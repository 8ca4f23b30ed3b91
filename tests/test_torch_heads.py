"""The classification heads (madeleine_torch/models/heads.py: MLP, ProjHead)
against the JAX package's `mlp_forward` and `proj_head_forward` on the CPU,
f32, with JAX's parameter trees carried across by `heads_params_from_jax`:
eval mode, and train mode with HEAD_DROPOUT monkeypatched to 0 on both
sides (the two packages draw other dropout bits, ROADMAP.md C). Forward at
rtol 1e-5 / atol 1e-5, gradients at rtol 1e-4 / atol 1e-5 x the largest.
Then three AdamW steps of an MLP head at rate 0.2 (row 21's plain version):
the loss falls, and a rerun from the same seeds is bit for bit equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from madeleine_tpu.models import heads as jheads
from madeleine_torch.models import heads
from madeleine_torch.models.factory import heads_params_from_jax
from madeleine_torch.models.madeleine import init_madeleine

D_IN, D_OUT, BS = 64, 5, 16
FWD_TOL = dict(rtol=1e-5, atol=1e-5)

KINDS = {"mlp": (jheads.init_mlp_params, jheads.mlp_forward, heads.MLP),
         "proj_head": (jheads.init_proj_head_params, jheads.proj_head_forward, heads.ProjHead)}


def _pair(kind, seed=0):
    """(JAX params as numpy, JAX forward, port head with the same weights)."""
    init, fwd, cls = KINDS[kind]
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), D_IN, D_OUT))
    rng = np.random.default_rng(seed + 100)
    for name, p in params.items():   # LayerNorm affines off their init, so both paths count
        if name.startswith("ln"):
            p["scale"] = (1.0 + 0.1 * rng.standard_normal(D_IN)).astype(np.float32)
            p["bias"] = (0.1 * rng.standard_normal(D_IN)).astype(np.float32)
    head = cls(D_IN, D_OUT)
    head.load_state_dict(heads_params_from_jax(params), strict=True)
    return params, fwd, head


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_rate_0"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_head_matches_jax(monkeypatch, kind, train):
    """The output and the gradients of sum(w * out) for the input and every
    parameter, against jax.grad of JAX's forward."""
    monkeypatch.setattr(jheads, "HEAD_DROPOUT", 0.0)
    monkeypatch.setattr(heads, "HEAD_DROPOUT", 0.0)
    params, fwd, head = _pair(kind)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BS, D_IN)).astype(np.float32)
    w = rng.standard_normal((BS, D_OUT)).astype(np.float32)
    rng_key = jax.random.PRNGKey(3) if train else None

    def loss(p, x):
        return jnp.sum(w * fwd(p, x, rng=rng_key, train=train))

    want = np.asarray(fwd(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
                          rng=rng_key, train=train))
    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, params),
                                            jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = head(tx, seed=3 if train else None, train=train)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **FWD_TOL)
    want_grads = heads_params_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    want_grads["x"] = torch.from_numpy(np.array(gx))
    got_grads = dict(head.named_parameters(), x=tx)
    assert set(got_grads) == set(want_grads)
    for k, ref in want_grads.items():
        ref = ref.numpy()
        np.testing.assert_allclose(got_grads[k].grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def _fine_tune(steps=3):
    """An MLP head from a seeded generator, AdamW on one batch of synthetic
    slide embeddings (class-dependent means), dropout 0.2 seeded per step.
    Returns (losses, state dict)."""
    gen = torch.Generator().manual_seed(0)
    head = init_madeleine(heads.MLP(D_IN, D_OUT), gen)
    labels = torch.arange(4 * BS) % D_OUT
    centres = torch.randn(D_OUT, D_IN, generator=gen)
    x = centres[labels] + torch.randn(4 * BS, D_IN, generator=gen)
    opt = torch.optim.AdamW(head.parameters(), lr=1e-3, weight_decay=0.01)
    losses = []
    for i in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(head(x, seed=100 + i, train=True), labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, {k: v.detach().clone() for k, v in head.state_dict().items()}


def test_mlp_fine_tune_learns_and_reruns_bit_for_bit():
    losses, sd = _fine_tune()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    again, sd2 = _fine_tune()
    assert again == losses
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_dropout_sites_and_eval_mode():
    """Training draws a mask at each site (the two MLP layers on streams of
    their own); eval mode and train mode without a seed draw none."""
    _, _, head = _pair("mlp")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((BS, D_IN)).astype(np.float32))
    with torch.no_grad():
        ev = head(x)
        assert torch.equal(head(x, seed=4, train=False), ev)
        assert torch.equal(head(x, train=True), ev)
        tr = head(x, seed=4, train=True)
        assert not torch.equal(tr, ev) and torch.equal(head(x, seed=4, train=True), tr)

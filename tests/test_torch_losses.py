"""The port's InfoNCE (madeleine_torch/ops/losses.py) and LR schedule
(madeleine_torch/train/optim.py) against the golden fixture and the JAX
package: values and gradients, f32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops import losses as JL
from madeleine_tpu.train.optim import make_lr_schedule as jax_schedule
from madeleine_torch.ops import losses as L
from madeleine_torch.train.optim import make_lr_schedule, make_optimizer
from tests.torch_port_helpers import GOLDEN_DIR, configs, to_torch


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN_DIR, "golden.npz"))


@pytest.mark.parametrize("symmetric,key", [(True, "infonce/sym"), (False, "infonce/asym")])
def test_info_nce_matches_golden(golden, symmetric, key):
    """The reference torch loss at temperature 0.001, rtol 1e-3 as tests/test_golden.py."""
    got = L.info_nce(to_torch(golden["infonce/q"]), to_torch(golden["infonce/k"]),
                     temperature=0.001, symmetric=symmetric)
    np.testing.assert_allclose(float(got), golden[key], rtol=1e-3)


def _qk(n=12, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32),
            rng.random(n) < 0.7)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("temperature", [0.001, 0.1])
def test_info_nce_matches_jax_values_and_gradients(symmetric, masked, temperature):
    """rtol 1e-5 on the value; gradients rtol 1e-4, atol 1e-5 x their scale
    (1/temperature multiplies the f32 rounding of the cosine logits)."""
    q, k, m = _qk()
    mask = m if masked else None
    f = lambda a, b: JL.info_nce(a, b, temperature=temperature, symmetric=symmetric,
                                 mask=None if mask is None else jnp.asarray(mask))
    want, (gq, gk) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    qt, kt = to_torch(q).requires_grad_(True), to_torch(k).requires_grad_(True)
    got = L.info_nce(qt, kt, temperature=temperature, symmetric=symmetric,
                     mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in ((qt.grad, gq), (kt.grad, gk)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * max(1, np.abs(w).max()))


@pytest.mark.parametrize("mode", ["unpaired", "paired"])
def test_info_nce_explicit_negatives_match_jax(mode):
    q, k, m = _qk()
    rng = np.random.default_rng(1)
    neg = rng.standard_normal((5, 16) if mode == "unpaired" else (12, 5, 16)).astype(np.float32)
    want = JL.info_nce(jnp.asarray(q), jnp.asarray(k), jnp.asarray(neg), temperature=0.1,
                       mask=jnp.asarray(m), negative_mode=mode)
    got = L.info_nce(to_torch(q), to_torch(k), to_torch(neg), temperature=0.1,
                     mask=torch.from_numpy(m), negative_mode=mode)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_info_nce_no_valid_rows_is_zero_and_finite():
    q, k, _ = _qk()
    qt = to_torch(q).requires_grad_(True)
    loss = L.info_nce(qt, to_torch(k), temperature=0.001, symmetric=True,
                      mask=torch.zeros(12, dtype=torch.bool))
    loss.backward()
    assert float(loss) == 0.0 and torch.isfinite(qt.grad).all()


@pytest.mark.parametrize("warmup", [True, False])
def test_lr_schedule_matches_optax(warmup):
    """Warmup ramp, the flat epoch and the cosine, to 1e-9 relative. optax is
    evaluated in float64: in float32 its warmup start (1e-4 - 1e-4 + 1e-9)
    cancels to 0.3% error."""
    jcfg, pcfg = configs(lr=1e-4, end_learning_rate=1e-8, max_epochs=7, warmup=warmup,
                         warmup_epochs=2)
    spe = 5
    want, got = jax_schedule(jcfg, spe), make_lr_schedule(pcfg, spe)
    with jax.enable_x64(True):
        ref = {step: float(want(step)) for step in (0, 1, 4, 9, 10, 11, 14, 15, 16, 20, 27, 34,
                                                    35, 36, 60)}
    for step, value in ref.items():
        np.testing.assert_allclose(got(step), value, rtol=1e-9, err_msg=str(step))


def test_optimizer_is_adamw_with_the_reference_hyperparameters():
    _, pcfg = configs(weight_decay=0.01)
    opt, schedule = make_optimizer(pcfg, [torch.nn.Parameter(torch.zeros(3))], 10)
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.01 and group["lr"] == schedule(0)

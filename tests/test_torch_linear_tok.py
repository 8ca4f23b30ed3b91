"""The port's token-projector train op (madeleine_torch/ops/linear_tok.py,
kernels 19/20 on the card) against the JAX package's `linear_tok` kernels
(`_fwd_call` / `_bwd_call` in interpret mode on the CPU) at
tests/test_linear_tok.py's shapes, and its autograd against the explicit
backward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madeleine_tpu.ops.linear_tok import _bwd_call, _fwd_call
from madeleine_torch.ops import linear_tok as lt
from tests.torch_port_helpers import to_torch


def _data(bb=2, t=70, E=64, d_out=16, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((bb, t, E)).astype(np.float32)
    w = rng.standard_normal((E, d_out)).astype(np.float32)
    b = rng.standard_normal((d_out,)).astype(np.float32)
    g = rng.standard_normal((bb, t, d_out)).astype(np.float32)
    return y, w, b, g


@pytest.mark.parametrize("t", [70, 45], ids=["t70", "ragged_t45"])
def test_matches_jax_kernels(t):
    """tok at rtol 1e-5 / atol 1e-5 (JAX's forward at t_block 32); dy, dW and
    db at rtol 1e-4 / atol 1e-4 (tests/test_linear_tok.py's bars): sums over
    up to 140 tokens in another order. t = 45 is no multiple of the t_block,
    so JAX's padded rows must not reach dW or db."""
    y, w, b, g = _data(t=t, seed=t)
    want = np.asarray(_fwd_call(jnp.asarray(y), jnp.asarray(w), jnp.asarray(b), t_block=32,
                                interpret=True))
    got = lt.linear_tok_fwd_plain(to_torch(y), to_torch(w.T.copy()), to_torch(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dy, dw, db = (np.asarray(a) for a in _bwd_call(jnp.asarray(y), jnp.asarray(g),
                                                   jnp.asarray(w), t_block=32, interpret=True))
    got = lt.linear_tok_bwd_plain(to_torch(y), to_torch(g), to_torch(w.T.copy()))
    np.testing.assert_allclose(got["y"].numpy(), dy, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["wt"].numpy(), dw.T, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["bt"].numpy(), db, rtol=1e-4, atol=1e-4)


def test_autograd_equals_the_explicit_backward():
    """`linear_tok_train` on CPU tensors: its gradients of y, Wt and bt are the
    explicit backward's for the same cotangent (rtol 1e-6), and its output is
    the plain forward's, bit for bit."""
    y, w, b, g = _data(seed=3)
    yt = to_torch(y).requires_grad_(True)
    wt = to_torch(w.T.copy()).requires_grad_(True)
    bt = to_torch(b).requires_grad_(True)
    out = lt.linear_tok_train(yt, wt, bt)
    assert torch.equal(out.detach(), lt.linear_tok_fwd_plain(yt.detach(), wt.detach(),
                                                             bt.detach()))
    (out * to_torch(g)).sum().backward()
    want = lt.linear_tok_bwd_plain(yt.detach(), to_torch(g), wt.detach())
    for name, ten in (("y", yt), ("wt", wt), ("bt", bt)):
        torch.testing.assert_close(ten.grad, want[name], rtol=1e-6, atol=0, msg=name)

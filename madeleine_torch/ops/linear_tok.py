"""Token projector for training: kernel 19 (forward) and 20 (backward), bf16.

Replaces `madeleine_tpu/ops/linear_tok.py` (`_fwd_kernel`, `_bwd_kernel`,
`linear_tok_train`), the per-op lane's token projector (ref: Model.py:80-83,
138-140): tok = y Wt^T + bt over y [b, t, E] (head-major), f32 accumulation
and bias, cast to y's dtype; the backward takes the cotangent in y's dtype
(linear_tok.py:125) and gives dy = g Wt in y's dtype, dWt = g^T y and
dbt = sum of g in f32. The JAX package reaches it for bf16 only
(madeleine_tpu/models/madeleine.py:93-103): an f32 step's projector is a
plain product (`models/madeleine.py::project_tokens`). The TPU needed the
op to pin its operands' layout;
the port keeps it as the token projector's own kernels. Wt [d_out, E] has
its input columns permuted to head-major (`madeleine.train_weights`'s wt);
bt is f32. The plain versions also serve K6/K7's. A CPU tensor takes them
(any float dtype); a CUDA tensor launches csrc/linear_tok.cu, bf16 only, or
raises. Both directions run on the TMA + wgmma GEMM (csrc/gemm_wgmma.cuh);
the backward's first design, on the mma.sync GEMM of csrc/gemm_bf16.cuh,
stays reachable as `linear_tok_bwd_mmasync_cuda`, a check that no path
calls.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from madeleine_torch.ops import _build
from madeleine_torch.ops import preattn as pa
from madeleine_torch.ops.preattn import wide

fwd_launches = 0   # kernel 19 launches (one per wrapper call on a CUDA tensor)
bwd_launches = 0   # kernel 20 launches
bwd_mmasync_launches = 0   # kernel 20's first design, the check-only entry point


def linear_tok_fwd_plain(y, wt, bt) -> torch.Tensor:
    """y [b, t, E] -> tok [b, t, d_out] in y.dtype."""
    return (pa.mm(y, wt) + bt).to(y.dtype)


def tok_bwd_plain(y, g, wt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy f32, dWt f32, dbt f32) for the cotangent g [b, t, d_out]."""
    return pa.mm_nn(g, wt), pa.token_sum(g, y), wide(g).sum((0, 1))


@torch.no_grad()
def linear_tok_bwd_plain(y, g, wt) -> Dict[str, torch.Tensor]:
    """The adjoint for the cotangent g (in y.dtype): {"y": dy in y.dtype,
    "wt", "bt": f32}."""
    dy, dwt, dbt = tok_bwd_plain(y, g, wt)
    return {"y": dy.to(y.dtype), "wt": dwt, "bt": dbt}


def _check(y, wt, bt, kernel):
    """(M, E, d_out) after the operand checks, each tensor attribute read
    once: at a small shape the host's launch is most of the forward's time."""
    if not y.is_cuda:
        raise ValueError(f"{kernel} kernel needs CUDA tensors, got {y.device}")
    if y.dtype != torch.bfloat16:
        raise NotImplementedError(f"{kernel} kernel runs in bf16 only, got {y.dtype}: an f32 "
                                  f"step projects its tokens with a plain F.linear "
                                  f"(models/madeleine.py::project_tokens), as the JAX package "
                                  f"keeps f32 outside this kernel")
    b, t, E = y.shape
    dout = wt.shape[0]
    if E % 8 or dout % 8 or dout > 4096 or b < 1 or t < 1:
        raise ValueError(f"{kernel} kernel: unsupported widths E={E}, d_out={dout} "
                         f"(needs E and d_out multiples of 8, d_out <= 4096)")
    if not y.is_contiguous():
        raise ValueError(f"{kernel} kernel: y must be contiguous")
    dev = y.device
    _build.check_operand(kernel, "wt", wt, (dout, E), torch.bfloat16, dev)
    _build.check_aligned(kernel, "y", y)
    _build.check_aligned(kernel, "wt", wt)
    if bt is not None:
        _build.check_operand(kernel, "bt", bt, (dout,), torch.float32, dev)
    return b * t, E, dout


def linear_tok_fwd_cuda(y, wt, bt) -> torch.Tensor:
    """Launch kernel 19 on CUDA tensors; returns as `linear_tok_fwd_plain`.
    Records no autograd (the output is a fresh tensor the kernel writes)."""
    global fwd_launches
    M, E, dout = _check(y, wt, bt, "linear_tok_fwd")
    tok = y.new_empty((y.shape[0], y.shape[1], dout))
    _build.call_ptrs("linear_tok", "linear_tok_forward", (y, wt, bt, tok), (M, E, dout), (),
                     tok.device)
    fwd_launches += 1
    return tok


def _launch_bwd(y, g, wt, kernel, fn, ws_fn):
    M, E, dout = _check(y, wt, None, kernel)
    _build.check_operand(kernel, "g", g, (*y.shape[:2], dout), torch.bfloat16, y.device)
    _build.check_aligned(kernel, "g", g)
    dev, f32 = y.device, torch.float32
    ws = _build.workspace("linear_tok", ws_fn, [M, E, dout])
    out = {"y": torch.empty_like(y), "wt": torch.empty(dout, E, dtype=f32, device=dev),
           "bt": torch.empty(dout, dtype=f32, device=dev)}
    scratch = [torch.empty(ws[0], dtype=f32, device=dev), torch.empty(ws[1], dtype=f32, device=dev)]
    _build.call_ptrs("linear_tok", fn, [y, g, wt, *out.values(), *scratch], [M, E, dout], [],
                     dev)
    return out


@torch.no_grad()
def linear_tok_bwd_cuda(y, g, wt) -> Dict[str, torch.Tensor]:
    """Launch kernel 20 on CUDA tensors; returns as `linear_tok_bwd_plain`.
    The checks of `_check` (and g's) are every condition the wgmma GEMM
    puts on these operands: no shape they pass is refused on the card."""
    global bwd_launches
    out = _launch_bwd(y, g, wt, "linear_tok_bwd", "linear_tok_backward",
                      "linear_tok_bwd_workspace")
    bwd_launches += 1
    return out


@torch.no_grad()
def linear_tok_bwd_mmasync_cuda(y, g, wt) -> Dict[str, torch.Tensor]:
    """Kernel 20's first design (both products on the mma.sync GEMM), kept
    as a check on the card beside `linear_tok_bwd_cuda`; no path of the
    port calls it. Arguments and result as `linear_tok_bwd_cuda`."""
    global bwd_mmasync_launches
    out = _launch_bwd(y, g, wt, "linear_tok_bwd_mmasync", "linear_tok_backward_mmasync",
                      "linear_tok_bwd_mmasync_workspace")
    bwd_mmasync_launches += 1
    return out


class LinearTokTrain(torch.autograd.Function):
    """(y, wt, bt) -> tok [b, t, d_out] in y.dtype."""

    @staticmethod
    def forward(ctx, y, wt, bt):
        fwd = linear_tok_fwd_cuda if y.is_cuda else linear_tok_fwd_plain
        ctx.save_for_backward(y, wt, bt)
        return fwd(y, wt, bt)

    @staticmethod
    def backward(ctx, g):
        y, wt, bt = ctx.saved_tensors
        bwd = linear_tok_bwd_cuda if y.is_cuda else linear_tok_bwd_plain
        grads = bwd(y, g.to(y.dtype).contiguous(), wt)
        return grads["y"], grads["wt"].to(wt.dtype), grads["bt"].to(bt.dtype)


def linear_tok_train(y: torch.Tensor, wt: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The token projector in training (JAX `linear_tok_train`): y [b, t, E]
    head-major in the compute dtype, wt [d_out, E] in the compute dtype, bt
    [d_out] f32 (gradients flow back through both). Returns [b, t, d_out]
    in y.dtype."""
    return LinearTokTrain.apply(y.contiguous(), wt, bt)

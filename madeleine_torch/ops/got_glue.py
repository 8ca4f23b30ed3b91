"""GOT glue around the transport kernels: K11/K12 (`threshold_build` forward
and backward) and K13/K14 (`gw_trace` forward and backward), f32.

PyTorch counterpart of `madeleine_tpu/ops/got_glue.py` (ref:
madeleine/utils/loss.py:225-258, 288-292), the route that the JAX package's
`got_loss_multi` takes by default:

  threshold_build:  (C0, Cs0, Ct0, thr [b, 3]) -> (C, Cs, Ct, Cst)
      C = relu(C0 - thr[:, 0]),  Cs = relu(Cs0 - thr[:, 1]),  Ct = relu(Ct0 - thr[:, 2]),
      Cst = (Cs^2 p) 1_m^T + 1_n (q^T (Ct^2)^T),  p = 1/n, q = 1/m;
    differentiable in all four inputs: the thresholds' cotangent flows back
    into the caller's min/max statistics, which stay outside the kernel;
  gw_trace:  (Cs, Ct, Cst, gamma) -> [b] per-problem sum((Cst - 2 Cs gamma Ct^T) o gamma),
    without materialising C_final on the card; gamma is detached by every
    caller (ref: loss.py:248), so it gets no gradient.

Each is a `torch.autograd.Function`: a CUDA tensor launches the kernels of
csrc/got_glue.cu (any n, m within the shared-memory limit) or raises; a CPU
tensor takes the plain versions, the unfused chain, whose backward is
autograd through them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from madeleine_torch.ops import _build

tb_fwd_launches = 0    # K11 launches (one per wrapper call on a CUDA tensor)
tb_bwd_launches = 0    # K12 launches
gwt_fwd_launches = 0   # K13 launches
gwt_bwd_launches = 0   # K14 launches

Glue4 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def cst_plain(Cs: torch.Tensor, Ct: torch.Tensor) -> torch.Tensor:
    """Cst = (Cs^2 p) 1_m^T + 1_n (q^T (Ct^2)^T), p = 1/n, q = 1/m (ref:
    loss.py:240-241)."""
    b, n, _ = Cs.shape
    m = Ct.shape[1]
    p = torch.full((b, n, 1), 1.0 / n, dtype=Cs.dtype, device=Cs.device)
    q = torch.full((b, m, 1), 1.0 / m, dtype=Cs.dtype, device=Cs.device)
    return torch.matmul(Cs ** 2, p) + torch.matmul(Ct ** 2, q).transpose(1, 2)


def threshold_build_plain(C0: torch.Tensor, Cs0: torch.Tensor, Ct0: torch.Tensor,
                          thr: torch.Tensor) -> Glue4:
    """The unfused chain: three threshold-ReLUs and the Cst outer sum."""
    C = torch.relu(C0 - thr[:, 0, None, None])
    Cs = torch.relu(Cs0 - thr[:, 1, None, None])
    Ct = torch.relu(Ct0 - thr[:, 2, None, None])
    return C, Cs, Ct, cst_plain(Cs, Ct)


def threshold_build_bwd_plain(C0, Cs0, Ct0, thr, dC, dCs, dCt, dCst) -> Glue4:
    """(dC0, dCs0, dCt0, dthr) for the outputs' cotangents: autograd through
    the plain chain."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in (C0, Cs0, Ct0, thr)]
        return torch.autograd.grad(threshold_build_plain(*xs), xs, (dC, dCs, dCt, dCst))


def gw_trace_plain(Cs: torch.Tensor, Ct: torch.Tensor, Cst: torch.Tensor,
                   gamma: torch.Tensor) -> torch.Tensor:
    """sum (Cst - 2 Cs gamma Ct^T) o gamma per problem (= trace(C_g^T gamma))."""
    C_final = Cst - 2.0 * torch.matmul(torch.matmul(Cs, gamma), Ct.transpose(1, 2))
    return (C_final * gamma).sum((1, 2))


def gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout):
    """(dCs, dCt, dCst) for the cotangent dout [b]: autograd through the plain
    trace, gamma held fixed."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in (Cs, Ct, Cst)]
        return torch.autograd.grad(gw_trace_plain(*xs, gamma.detach()), xs, dout)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"threshold_build_forward": [_P] * 8 + [_I] * 3 + [_P],
               "threshold_build_backward": [_P] * 12 + [_I] * 3 + [_P],
               "gw_trace_forward": [_P] * 6 + [_I] * 3 + [_P],
               "gw_trace_backward": [_P] * 9 + [_I] * 3 + [_P]}


def _check(kernel: str, named, b: int, n: int, m: int) -> torch.device:
    """Shapes by operand role: "nm" [b, n, m], "nn" [b, n, n], "mm" [b, m, m],
    "3" [b, 3], "b" [b]."""
    dims = {"nm": (b, n, m), "nn": (b, n, n), "mm": (b, m, m), "3": (b, 3), "b": (b,)}
    return _build.check_problems(kernel, [(name, x) for name, _, x in named],
                                 [dims[role] for _, role, x in named], "got_glue",
                                 "got_glue_smem_bytes", n, m)


def _launch(fn_name: str, args, device: torch.device) -> None:
    _build.launch("got_glue", fn_name, _SIGNATURES[fn_name], args, device)


@torch.no_grad()
def threshold_build_cuda(C0, Cs0, Ct0, thr) -> Glue4:
    """Launch K11; returns (C, Cs, Ct, Cst) as `threshold_build_plain`."""
    global tb_fwd_launches
    b, n, m = C0.shape
    dev = _check("threshold_build_fwd", [("C0", "nm", C0), ("Cs0", "nn", Cs0),
                                         ("Ct0", "mm", Ct0), ("thr", "3", thr)], b, n, m)
    outs = (torch.empty_like(C0), torch.empty_like(Cs0), torch.empty_like(Ct0),
            torch.empty_like(C0))
    _launch("threshold_build_forward", [thr, C0, Cs0, Ct0, *outs, b, n, m], dev)
    tb_fwd_launches += 1
    return outs


@torch.no_grad()
def threshold_build_bwd_cuda(C0, Cs0, Ct0, thr, dC, dCs, dCt, dCst) -> Glue4:
    """Launch K12; returns (dC0, dCs0, dCt0, dthr) as `threshold_build_bwd_plain`."""
    global tb_bwd_launches
    b, n, m = C0.shape
    dev = _check("threshold_build_bwd",
                 [("C0", "nm", C0), ("Cs0", "nn", Cs0), ("Ct0", "mm", Ct0), ("thr", "3", thr),
                  ("dC", "nm", dC), ("dCs", "nn", dCs), ("dCt", "mm", dCt),
                  ("dCst", "nm", dCst)], b, n, m)
    grads = (torch.empty_like(C0), torch.empty_like(Cs0), torch.empty_like(Ct0),
             torch.empty_like(thr))
    _launch("threshold_build_backward", [thr, C0, Cs0, Ct0, dC, dCs, dCt, dCst, *grads, b, n, m],
            dev)
    tb_bwd_launches += 1
    return grads


@torch.no_grad()
def gw_trace_cuda(Cs, Ct, Cst, gamma) -> torch.Tensor:
    """Launch K13; returns [b] as `gw_trace_plain`. Cs gamma goes to a
    [b, n, m] scratch allocated here; C_final is never written."""
    global gwt_fwd_launches
    b, n, m = Cst.shape
    dev = _check("gw_trace_fwd", [("Cs", "nn", Cs), ("Ct", "mm", Ct), ("Cst", "nm", Cst),
                                  ("gamma", "nm", gamma)], b, n, m)
    t1 = torch.empty_like(Cst)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    _launch("gw_trace_forward", [Cs, Ct, Cst, gamma, t1, out, b, n, m], dev)
    gwt_fwd_launches += 1
    return out


@torch.no_grad()
def gw_trace_bwd_cuda(Cs, Ct, gamma, dout):
    """Launch K14; returns (dCs, dCt, dCst) as `gw_trace_bwd_plain`. The
    products gamma Ct^T and gamma^T Cs go to [b, n, m] scratches allocated here."""
    global gwt_bwd_launches
    b, n, m = gamma.shape
    dev = _check("gw_trace_bwd", [("gamma", "nm", gamma), ("Cs", "nn", Cs), ("Ct", "mm", Ct),
                                  ("dout", "b", dout)], b, n, m)
    P, G = torch.empty_like(gamma), torch.empty_like(gamma)
    grads = (torch.empty_like(Cs), torch.empty_like(Ct), torch.empty_like(gamma))
    _launch("gw_trace_backward", [dout, Cs, Ct, gamma, P, G, *grads, b, n, m], dev)
    gwt_bwd_launches += 1
    return grads


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

class ThresholdBuild(torch.autograd.Function):
    """(C0, Cs0, Ct0, thr) -> (C, Cs, Ct, Cst); backward K12 or autograd
    through the plain chain (the counterpart of the custom_vjp of
    `madeleine_tpu/ops/got_glue.py::threshold_build`)."""

    @staticmethod
    def forward(ctx, C0, Cs0, Ct0, thr):
        ctx.save_for_backward(C0, Cs0, Ct0, thr)
        fwd = threshold_build_cuda if C0.is_cuda else threshold_build_plain
        return fwd(C0, Cs0, Ct0, thr)

    @staticmethod
    def backward(ctx, dC, dCs, dCt, dCst):
        saved = ctx.saved_tensors
        bwd = threshold_build_bwd_cuda if saved[0].is_cuda else threshold_build_bwd_plain
        return bwd(*saved, *(g.contiguous() for g in (dC, dCs, dCt, dCst)))


class GwTrace(torch.autograd.Function):
    """(Cs, Ct, Cst, gamma) -> [b]; backward K14 or autograd through the
    plain trace; gamma gets no gradient."""

    @staticmethod
    def forward(ctx, Cs, Ct, Cst, gamma):
        ctx.save_for_backward(Cs, Ct, Cst, gamma)
        fwd = gw_trace_cuda if Cst.is_cuda else gw_trace_plain
        return fwd(Cs, Ct, Cst, gamma)

    @staticmethod
    def backward(ctx, dout):
        Cs, Ct, Cst, gamma = ctx.saved_tensors
        if Cst.is_cuda:
            grads = gw_trace_bwd_cuda(Cs, Ct, gamma, dout.contiguous())
        else:
            grads = gw_trace_bwd_plain(Cs, Ct, Cst, gamma, dout)
        return (*grads, None)


def threshold_build(C0: torch.Tensor, Cs0: torch.Tensor, Ct0: torch.Tensor,
                    thr: torch.Tensor) -> Glue4:
    """C0 [b, n, m], Cs0 [b, n, n], Ct0 [b, m, m], thr [b, 3] f32 ->
    (C, Cs, Ct, Cst [b, n, m]), differentiable in all four inputs."""
    return ThresholdBuild.apply(*(x.contiguous() for x in (C0, Cs0, Ct0, thr)))


def gw_trace(Cs: torch.Tensor, Ct: torch.Tensor, Cst: torch.Tensor,
             gamma: torch.Tensor) -> torch.Tensor:
    """Per-problem GW objective [b], differentiable in Cs, Ct and Cst."""
    return GwTrace.apply(Cs.contiguous(), Ct.contiguous(), Cst.contiguous(),
                         gamma.detach().contiguous())

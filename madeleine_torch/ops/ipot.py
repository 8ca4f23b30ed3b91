"""IPOT transport plans of the GOT loss: kernels K8 (forward), K9 (backward)
and K10 (the Gromov-Wasserstein gamma loop), f32.

PyTorch counterpart of `madeleine_tpu/ops/ipot.py` (`_fwd_kernel`,
`_bwd_kernel`, `_gw_kernel`; ref: madeleine/utils/loss.py:179-193, 236-258).
IPOT runs `iterations` proximal Sinkhorn steps with uniform marginals:

    Q = A o T;  delta = 1/(n Q sigma);  a = Q^T delta;  sigma' = 1/(m a);
    T' = delta o Q o sigma'^T,   A = exp(-C / beta),  T_0 = 1, sigma_0 = 1/m.

`ipot_plan` is differentiable (`IpotPlan`): the backward is the exact adjoint
of the unrolled loop, the derivative that autograd through the loop gives
(the reference differentiates through the unconverged iterations).
`gw_gamma` is forward only: every caller detaches gamma (ref: loss.py:248).

A CPU tensor takes the plain PyTorch versions; a CUDA tensor launches K8 /
K9 / K10 from csrc/ipot_fwd.cu, csrc/ipot_bwd.cu and csrc/gw_gamma.cu
(f32), or raises. K8, K9 and K10 have two routes each, chosen by shape in
`transport_route`: a thread-block cluster per problem that keeps the
problem's state in shared memory (`cluster`, the train step's), and the
first design's one block per problem with the state in device memory (`global`, for
problems whose state does not fit a cluster). Each route has its own launch
counter.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from madeleine_torch.ops import _build

fwd_launches = 0          # K8 launches, cluster route (one per wrapper call on a CUDA tensor)
bwd_launches = 0          # K9 launches, cluster route
gw_launches = 0           # K10 launches, cluster route
fwd_launches_global = 0   # K8 launches, global route
bwd_launches_global = 0   # K9 launches, global route
gw_launches_global = 0    # K10 launches, global route


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ipot_plan_plain(C: torch.Tensor, beta: float = 0.5, iterations: int = 50) -> torch.Tensor:
    """C [b, n, m] f32 -> T [b, n, m]: the loop as `madeleine_tpu/ops/ipot.py::_step`
    writes it (products before sums), differentiable by autograd."""
    b, n, m = C.shape
    A = torch.exp(-C / beta)
    T = torch.ones_like(C)
    sigma = torch.ones(b, 1, m, dtype=C.dtype, device=C.device) / m
    for _ in range(iterations):
        Q = A * T
        delta = 1.0 / (n * (Q * sigma).sum(2, keepdim=True))     # [b, n, 1]
        sigma = 1.0 / (m * (Q * delta).sum(1, keepdim=True))     # [b, 1, m]
        T = delta * Q * sigma
    return T


def ipot_plan_bwd_plain(C: torch.Tensor, g: torch.Tensor, beta: float,
                        iterations: int) -> torch.Tensor:
    """dC for the plan's cotangent g: autograd through the plain loop."""
    with torch.enable_grad():
        Cx = C.detach().requires_grad_(True)
        (dC,) = torch.autograd.grad(ipot_plan_plain(Cx, beta, iterations), Cx, g)
    return dC


@torch.no_grad()
def gw_gamma_plain(Cs: torch.Tensor, Ct: torch.Tensor, Cst: torch.Tensor, beta: float = 0.1,
                   outer: int = 5, iters: int = 20) -> torch.Tensor:
    """Cs [b, n, n], Ct [b, m, m], Cst [b, n, m] -> gamma [b, n, m]: `outer`
    times C_g = Cst - 2 (Cs gamma) Ct^T, gamma = IPOT(C_g), from 1/(n m)."""
    _, n, m = Cst.shape
    gamma = torch.full_like(Cst, 1.0 / (n * m))
    for _ in range(outer):
        cg = Cst - 2.0 * torch.matmul(torch.matmul(Cs, gamma), Ct.transpose(1, 2))
        gamma = ipot_plan_plain(cg, beta, iters)
    return gamma


# ---------------------------------------------------------------------------
# routes of K8, K9 and K10
# ---------------------------------------------------------------------------

# cluster sizes tried in order, the first whose state fits wins (K8: at
# c = 4 its ranks are the global route's column-pass row groups, so its plan
# equals the global route's bit for bit, csrc/ipot_fwd.cu; c = 8 also timed
# slower on the card, PERF.md)
CLUSTER_SIZES = {"ipot_fwd": (4, 8), "ipot_bwd": (8,), "gw_gamma": (4, 8)}
_GROUPS, _WARPS, _FAST_M = 4, 16, 256        # ipot_cluster.cuh CGROUPS, CWARPS, FAST_M
_STAGE_FLOATS = 2 * 16 * ((64 + 4) + (128 + 4))   # ipot_cluster.cuh stage_floats()


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def cluster_rows(n: int, c: int) -> List[Tuple[int, int]]:
    """The rows [r0, r1) that each cluster rank owns: r0 = floor(r n / c)."""
    return [(r * n // c, (r + 1) * n // c) for r in range(c)]


def cluster_smem_bytes(kernel: str, n: int, m: int, c: int) -> int:
    """Shared memory per block of the cluster route of `kernel` ("ipot_fwd",
    "ipot_bwd" or "gw_gamma"): the formula of the source's cluster_smem_floats."""
    rows = -(-n // c)
    slice_ = _round4(rows * m)
    red = max(_GROUPS * m, _WARPS * _FAST_M)
    if kernel == "ipot_fwd":
        floats = 2 * slice_ + _round4(rows) + (1 + 2 * c) * _round4(m)
    elif kernel == "gw_gamma":
        floats = (2 * slice_ + _STAGE_FLOATS + _round4(rows) + (1 + 2 * c) * _round4(m) + red
                  + 2 * n)
    elif kernel == "ipot_bwd":
        floats = 5 * slice_ + 2 * _round4(rows) + (3 + 4 * c) * _round4(m) + red + 4
    else:
        raise ValueError(f"no cluster route for {kernel}")
    return 4 * floats


def transport_route(kernel: str, n: int, m: int) -> Tuple[str, int]:
    """("cluster", c) when a cluster of c blocks holds one [n, m] problem's
    state in shared memory, for the first c of CLUSTER_SIZES[kernel] that
    fits; else ("global", 1), the one-block kernel with the state in device memory."""
    for c in CLUSTER_SIZES[kernel]:
        if cluster_smem_bytes(kernel, n, m, c) <= _build.SMEM_LIMIT:
            return "cluster", c
    return "global", 1


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"ipot_forward": [_P] * 3 + [_I] * 3 + [_F, _I, _P],
               "ipot_fwd_cluster": [_P] * 2 + [_I] * 4 + [_F, _I, _P],
               "ipot_backward": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
               "ipot_bwd_cluster": [_P] * 6 + [_I] * 4 + [_F, _I, _P],
               "gw_gamma_forward": [_P] * 6 + [_I] * 3 + [_F, _F, _I, _I, _P],
               "gw_gamma_cluster_forward": [_P] * 4 + [_I] * 4 + [_F, _F, _I, _I, _P]}


@torch.no_grad()
def ipot_plan_cuda(C: torch.Tensor, beta: float, iterations: int) -> torch.Tensor:
    """Launch K8 on a CUDA tensor C [b, n, m] f32, on the route
    `transport_route` gives for the shape; returns T as `ipot_plan_plain`."""
    _, n, m = C.shape
    route, c = transport_route("ipot_fwd", n, m)
    if route == "cluster":
        return _ipot_fwd_cluster(C, beta, iterations, c)
    return _ipot_fwd_global(C, beta, iterations)


def _ipot_fwd_cluster(C, beta, iterations, c):
    """K8's cluster route: c blocks per problem, A and T in shared memory."""
    global fwd_launches
    b, n, m = C.shape
    dev = _build.check_problems("ipot_fwd", [("C", C)], [(b, n, m)], "ipot_fwd",
                                "ipot_fwd_cluster_smem_bytes", n, m, c)
    T = torch.empty_like(C)
    _build.launch("ipot_fwd", "ipot_fwd_cluster", _SIGNATURES["ipot_fwd_cluster"],
                  [C, T, b, n, m, c, float(beta), int(iterations)], dev)
    fwd_launches += 1
    return T


def _ipot_fwd_global(C, beta, iterations):
    """K8's global route (the one-block kernel): one block per problem, A in a
    device scratch and T in the output."""
    global fwd_launches_global
    b, n, m = C.shape
    dev = _build.check_problems("ipot_fwd", [("C", C)], [(b, n, m)], "ipot_fwd",
                                "ipot_fwd_smem_bytes", n, m)
    A, T = torch.empty_like(C), torch.empty_like(C)
    _build.launch("ipot_fwd", "ipot_forward", _SIGNATURES["ipot_forward"],
                  [C, A, T, b, n, m, float(beta), int(iterations)], dev)
    fwd_launches_global += 1
    return T


@torch.no_grad()
def ipot_plan_bwd_cuda(C: torch.Tensor, g: torch.Tensor, beta: float,
                       iterations: int) -> torch.Tensor:
    """Launch K9: dC for the plan's cotangent g, as `ipot_plan_bwd_plain`, on
    the route `transport_route` gives for the shape. The replayed history
    (T_k of every iteration: iterations * b * n * m * 4 bytes, and delta_k,
    sigma_k) lives in buffers allocated here."""
    _, n, m = C.shape
    route, c = transport_route("ipot_bwd", n, m)
    if route == "cluster":
        return _ipot_bwd_cluster(C, g, beta, iterations, c)
    return _ipot_bwd_global(C, g, beta, iterations)


def _ipot_bwd_cluster(C, g, beta, iterations, c):
    """K9's cluster route: c blocks per problem, A, dT and dA in shared memory."""
    global bwd_launches
    b, n, m = C.shape
    it = int(iterations)
    dev = _build.check_problems("ipot_bwd", [("C", C), ("g", g)], [(b, n, m)] * 2,
                                "ipot_bwd", "ipot_bwd_cluster_smem_bytes", n, m, c)
    f32 = torch.float32
    dC = torch.empty_like(C)
    Th = torch.empty(b * it * c * _round4(-(-n // c) * m), dtype=f32, device=dev)
    Dh = torch.empty(b, it, n, dtype=f32, device=dev)
    Sh = torch.empty(b, c, it + 1, m, dtype=f32, device=dev)
    _build.launch("ipot_bwd", "ipot_bwd_cluster", _SIGNATURES["ipot_bwd_cluster"],
                  [C, g, Th, Dh, Sh, dC, b, n, m, c, float(beta), it], dev)
    bwd_launches += 1
    return dC


def _ipot_bwd_global(C, g, beta, iterations):
    """K9's global route (the one-block kernel): one block per problem, its state in
    device memory."""
    global bwd_launches_global
    b, n, m = C.shape
    it = int(iterations)
    dev = _build.check_problems("ipot_bwd", [("C", C), ("g", g)], [(b, n, m)] * 2,
                                "ipot_bwd", "ipot_bwd_smem_bytes", n, m)
    f32 = torch.float32
    A, dT, dC = torch.empty_like(C), torch.empty_like(C), torch.empty_like(C)
    Th = torch.empty(b, it, n, m, dtype=f32, device=dev)
    Dh = torch.empty(b, it, n, dtype=f32, device=dev)
    Sh = torch.empty(b, it + 1, m, dtype=f32, device=dev)
    _build.launch("ipot_bwd", "ipot_backward", _SIGNATURES["ipot_backward"],
                  [C, g, A, Th, Dh, Sh, dT, dC, b, n, m, float(beta), it], dev)
    bwd_launches_global += 1
    return dC


@torch.no_grad()
def gw_gamma_cuda(Cs: torch.Tensor, Ct: torch.Tensor, Cst: torch.Tensor, beta: float,
                  outer: int, iters: int) -> torch.Tensor:
    """Launch K10 on CUDA tensors, on the route `transport_route` gives for
    the shape; returns gamma as `gw_gamma_plain`."""
    _, n, m = Cst.shape
    route, c = transport_route("gw_gamma", n, m)
    if route == "cluster":
        return _gw_gamma_cluster(Cs, Ct, Cst, beta, outer, iters, c)
    return _gw_gamma_global(Cs, Ct, Cst, beta, outer, iters)


def _gw_operands(Cs, Ct, Cst, smem_fn, *smem_args):
    b, n, m = Cst.shape
    return _build.check_problems("gw_gamma", [("Cst", Cst), ("Cs", Cs), ("Ct", Ct)],
                                 [(b, n, m), (b, n, n), (b, m, m)], "gw_gamma", smem_fn,
                                 *smem_args)


def _gw_gamma_cluster(Cs, Ct, Cst, beta, outer, iters, c):
    """K10's cluster route: c blocks per problem, A and gamma in shared memory."""
    global gw_launches
    b, n, m = Cst.shape
    dev = _gw_operands(Cs, Ct, Cst, "gw_gamma_cluster_smem_bytes", n, m, c)
    gamma = torch.empty_like(Cst)
    _build.launch("gw_gamma", "gw_gamma_cluster_forward",
                  _SIGNATURES["gw_gamma_cluster_forward"],
                  [Cs, Ct, Cst, gamma, b, n, m, c, float(beta), 1.0 / (n * m), int(outer),
                   int(iters)], dev)
    gw_launches += 1
    return gamma


def _gw_gamma_global(Cs, Ct, Cst, beta, outer, iters):
    """K10's global route (the one-block kernel): one block per problem, t1, A and
    gamma in device memory."""
    global gw_launches_global
    b, n, m = Cst.shape
    dev = _gw_operands(Cs, Ct, Cst, "gw_gamma_smem_bytes", n, m)
    t1, A, gamma = torch.empty_like(Cst), torch.empty_like(Cst), torch.empty_like(Cst)
    _build.launch("gw_gamma", "gw_gamma_forward", _SIGNATURES["gw_gamma_forward"],
                  [Cs, Ct, Cst, t1, A, gamma, b, n, m, float(beta), 1.0 / (n * m), int(outer),
                   int(iters)], dev)
    gw_launches_global += 1
    return gamma


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

class IpotPlan(torch.autograd.Function):
    """(C [b, n, m] f32, beta, iterations) -> T; backward: K9 or autograd
    through the plain loop (the counterpart of the custom_vjp of
    `madeleine_tpu/ops/ipot.py::ipot_plan_fused`)."""

    @staticmethod
    def forward(ctx, C, beta, iterations):
        ctx.save_for_backward(C)
        ctx.args = (beta, iterations)
        fwd = ipot_plan_cuda if C.is_cuda else ipot_plan_plain
        return fwd(C, beta, iterations)

    @staticmethod
    def backward(ctx, g):
        (C,) = ctx.saved_tensors
        bwd = ipot_plan_bwd_cuda if C.is_cuda else ipot_plan_bwd_plain
        return bwd(C, g.contiguous(), *ctx.args), None, None


def ipot_plan(C: torch.Tensor, beta: float = 0.5, iterations: int = 50) -> torch.Tensor:
    """IPOT transport plan, C [b, n, m] f32 -> T [b, n, m], differentiable."""
    return IpotPlan.apply(C.contiguous(), float(beta), int(iterations))


@torch.no_grad()
def gw_gamma(Cs: torch.Tensor, Ct: torch.Tensor, Cst: torch.Tensor, beta: float = 0.1,
             outer: int = 5, iters: int = 20) -> torch.Tensor:
    """The detached GW plan: K10 on CUDA tensors, `gw_gamma_plain` on CPU ones."""
    args = [x.detach().contiguous() for x in (Cs, Ct, Cst)]
    if Cst.is_cuda:
        return gw_gamma_cuda(*args, beta, outer, iters)
    return gw_gamma_plain(*args, beta, outer, iters)

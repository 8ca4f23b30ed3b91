"""The collectives of the data-parallel train step, with JAX's transpose
semantics (madeleine_tpu/train/trainer.py:249-290, ops/losses.py:109-128,
383-390,441-442), on any backend (NCCL on the card, Gloo on the CPU or on
CUDA tensors).

Every rank computes the same replicated loss and back-propagates its own
copy; the parameter gradients are then summed over ranks (`sum_gradients`,
one flat buffer and one all-reduce). So each collective's backward is the
one that makes that sum the gradient of the single-process step:

- `gather_rows` (the slide embeddings, read by the replicated InfoNCE and
  intra losses): its backward returns this rank's slice of the incoming
  gradient, which every rank holds whole. (The all-reduce backward of
  `torch.distributed.nn.functional.all_gather` would sum N equal copies; JAX
  undoes its reduce-scatter transpose with the loss's final `pmean`.)
- `sum_across` (GOT's per-stain sums, each rank's part of a replicated
  total): the identity backward.
- `gather_stats` (GOT's threshold min/max statistics, [n_dev, ...]): a rank
  back-propagates only through its own problems, so its incoming gradient
  is partial; the backward sums it over ranks and returns this rank's row,
  JAX's reduce-scatter transpose of `all_gather`, so the subgradient
  reaches the owner of the min or max with every rank's share.
- `reduce_nograd`: counts and other values without a gradient.

The list form of `all_gather` is used throughout (Gloo's safe one). Each
call adds to `traffic[purpose]` its calls, the bytes this rank sends and the
largest tensor it sent, counted on the host like `ops/launches.py`'s
launches: a test reads it to show that nothing bag-sized crosses ranks.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable

import torch
import torch.distributed as dist

traffic: Dict[str, Dict[str, int]] = {}


def _count(purpose: str, x: torch.Tensor) -> None:
    rec = traffic.setdefault(purpose, {"calls": 0, "bytes": 0, "max_numel": 0})
    rec["calls"] += 1
    rec["bytes"] += x.numel() * x.element_size()
    rec["max_numel"] = max(rec["max_numel"], x.numel())


def read() -> Dict[str, Dict[str, int]]:
    return copy.deepcopy(traffic)


def reset() -> None:
    traffic.clear()


def all_gather(x: torch.Tensor, group, purpose: str):
    """[x of rank 0, ..., x of rank N-1] (no gradient)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    _count(purpose, x)
    return parts


def reduce_nograd(x: torch.Tensor, group, purpose: str,
                  op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A copy of x reduced over ranks by `op` (no gradient)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    _count(purpose, out)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, purpose):
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[0]
        return torch.cat(all_gather(x, group, purpose))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None


class _GatherStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, purpose):
        ctx.rank, ctx.group, ctx.purpose = dist.get_rank(group), group, purpose
        return torch.stack(all_gather(x, group, purpose))

    @staticmethod
    def backward(ctx, g):
        return reduce_nograd(g, ctx.group, ctx.purpose + "_grad")[ctx.rank], None, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, purpose):
        return reduce_nograd(x, group, purpose)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_rows(x: torch.Tensor, group, purpose: str = "rows") -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order; the backward
    returns this rank's rows of the gradient."""
    if not x.requires_grad:
        return torch.cat(all_gather(x, group, purpose))
    return _GatherRows.apply(x, group, purpose)


def gather_stats(x: torch.Tensor, group, purpose: str = "stats") -> torch.Tensor:
    """[n_dev, *x.shape]: every rank's x; the backward sums the gradient
    over ranks and returns this rank's row."""
    if not x.requires_grad:
        return torch.stack(all_gather(x, group, purpose))
    return _GatherStats.apply(x, group, purpose)


def sum_across(x: torch.Tensor, group, purpose: str = "sums") -> torch.Tensor:
    """x summed over ranks; the identity backward."""
    if not x.requires_grad:
        return reduce_nograd(x, group, purpose)
    return _SumAcross.apply(x, group, purpose)


def sum_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Each parameter's gradient summed over ranks, in place: one flat
    buffer, one all-reduce. Parameters without a gradient are left out, as
    the optimizer leaves them (every rank's graph is the same, so the set is
    too)."""
    ps = [p for p in params if p.grad is not None]
    if not ps:
        return
    dtypes = {p.grad.dtype for p in ps}
    if len(dtypes) != 1:
        raise ValueError(f"gradients of several dtypes: {sorted(map(str, dtypes))}")
    flat = torch.cat([p.grad.reshape(-1) for p in ps])
    dist.all_reduce(flat, group=group)
    _count("grads", flat)
    offset = 0
    for p in ps:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n

"""Losses of the train step, in float32: InfoNCE and GOT.

PyTorch counterpart of `madeleine_tpu/ops/losses.py` (ref:
madeleine/utils/loss.py):

- `info_nce` (:49-106, ref :65-127): temperature-scaled contrastive
  cross-entropy with in-batch negatives, an optional symmetric variant, a
  validity mask that replaces the reference's boolean subsetting, and the
  explicit-negatives modes (which the reference falls through without
  returning; here they return the cross-entropy over [positive | negatives]);
- Graph Optimal Transport (:131-443, ref :160-301): `cosine_cost`, the
  threshold-ReLU, `ipot_distance` (IPOT Wasserstein, kernels K8/K9 of
  ops/ipot.py on the card), `gw_distance` (Gromov-Wasserstein, its detached
  gamma loop in K10), `got_loss` and `got_loss_multi`. `got_loss_multi`
  takes the JAX package's default route: the glue around the transport
  kernels (threshold-ReLU, the Cst outer sum, the final GW trace) runs
  through ops/got_glue.py (K11-K14 on the card); `got_loss` and
  `gw_distance` keep the plain chain, as the JAX package's do;
- `masked_subsample` (:258-289): the ragged batches' per-side GOT token
  draw, a Gumbel top-k over each bag's valid tokens, its noise from
  `gumbel_noise` (Philox keyed by the step's seed, a stream and the global
  row and token, so it does not change when the bucket grows);
- data parallelism (JAX's ``axis_name``, here a process ``group``):
  `info_nce_global` (:109-128) all-gathers the embeddings, and
  `got_loss_multi(..., group=)` gathers its threshold statistics (:383-390)
  and sums its per-stain losses over ranks (:441-442), with the backward
  rules of `parallel/collectives.py`;
- the intra-modality loss selector (:450-458, ref :138-156): `mse_loss`
  for the two `reconstruct_*` modes (the mask ignored), `info_nce` at the
  configured temperature for every other mode.

Everything runs in f32 with full-precision products (no TF32, see
`utils.device.full_precision_matmul`): temperature 0.001 multiplies logit
noise by 1000, and exp(-C/beta) at beta 0.1 multiplies a cost's error by 10.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from madeleine_torch.ops import prng
from madeleine_torch.ops.got_glue import cst_plain, gw_trace, gw_trace_plain, threshold_build
from madeleine_torch.ops.ipot import gw_gamma, ipot_plan
from madeleine_torch.parallel import collectives

_EPS_NORM = 1e-12
_NEG_INF = -1e30  # finite mask fill: keeps gradients NaN-free


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(_EPS_NORM)


def _masked_ce_diag(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean CE with diagonal labels; invalid rows dropped, invalid columns
    excluded from the denominator (equal to subsetting the valid entries)."""
    if mask is not None:
        logits = torch.where(mask[None, :], logits, torch.full_like(logits, _NEG_INF))
    ce = torch.logsumexp(logits, dim=1) - torch.diagonal(logits)
    if mask is None:
        return ce.mean()
    denom = mask.sum().clamp_min(1)
    return torch.where(mask, ce, torch.zeros_like(ce)).sum() / denom


def info_nce(query: torch.Tensor, positive_key: torch.Tensor,
             negative_keys: Optional[torch.Tensor] = None, *, temperature: float = 0.1,
             symmetric: bool = False, mask: Optional[torch.Tensor] = None,
             negative_mode: str = "unpaired") -> torch.Tensor:
    """InfoNCE (ref: loss.py:65-127). query, positive_key [n, d]; mask [n]
    bool marks the valid rows and columns. f32 throughout."""
    q = _l2_normalize(query.float())
    k = _l2_normalize(positive_key.float())
    if negative_keys is not None:
        nk = _l2_normalize(negative_keys.float())
        pos = (q * k).sum(dim=1, keepdim=True)
        if negative_mode == "unpaired":
            neg = q @ nk.T
        elif negative_mode == "paired":
            neg = torch.einsum("nd,nmd->nm", q, nk)
        else:
            raise ValueError(f"bad negative_mode {negative_mode}")
        logits = torch.cat([pos, neg], dim=1) / temperature
        ce = torch.logsumexp(logits, dim=1) - logits[:, 0]
        if mask is None:
            return ce.mean()
        return torch.where(mask, ce, torch.zeros_like(ce)).sum() / mask.sum().clamp_min(1)
    logits = (q @ k.T) / temperature
    loss = _masked_ce_diag(logits, mask)
    if symmetric:
        loss = 0.5 * loss + 0.5 * _masked_ce_diag(logits.T, mask)
    return loss


def info_nce_global(query: torch.Tensor, positive_key: torch.Tensor, *, group,
                    temperature: float = 0.1, symmetric: bool = False,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InfoNCE over the global batch (JAX losses.py:109-128): each rank's
    rows of query, positive_key and mask are gathered in rank order, so the
    in-batch negatives span every rank; the value is the same on every rank
    and the backward returns this rank's rows (`collectives.gather_rows`)."""
    q = collectives.gather_rows(query, group, "embeddings")
    k = collectives.gather_rows(positive_key, group, "embeddings")
    m = None if mask is None else collectives.gather_rows(mask, group, "labels")
    return info_nce(q, k, temperature=temperature, symmetric=symmetric, mask=m)


# ---------------------------------------------------------------------------
# Graph Optimal Transport
# ---------------------------------------------------------------------------

def cosine_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity between token sets, x [b, n, d], y [b, m, d] ->
    [b, n, m]. The reference normalises as x / (||x|| + 1e-12) (ref:
    loss.py:162-176), not with `_l2_normalize`'s max(||x||, eps)."""
    xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + _EPS_NORM)
    yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + _EPS_NORM)
    return 1.0 - torch.matmul(xn, yn.transpose(-1, -2))


def _threshold_relu(C: torch.Tensor, sample_mask: Optional[torch.Tensor],
                    beta: float = 0.1) -> torch.Tensor:
    """relu(C - (min + beta (max - min))) with min/max over the whole (valid
    part of the) batch tensor (ref: loss.py:225-233, 288-292). amin/amax
    split the subgradient evenly among ties, as jnp.min/jnp.max do."""
    if sample_mask is not None:
        valid = sample_mask[:, None, None]
        cmin = torch.where(valid, C, float("inf")).amin()
        cmax = torch.where(valid, C, float("-inf")).amax()
    else:
        cmin, cmax = C.amin(), C.amax()
    return torch.relu(C - (cmin + beta * (cmax - cmin)))


def ipot_distance(C: torch.Tensor, iterations: int = 50) -> torch.Tensor:
    """Per-sample Wasserstein cost <C, T> (ref: loss.py:202-207 returns the
    negative; callers negate again), T the IPOT plan at beta 0.5."""
    return (C * ipot_plan(C, 0.5, iterations)).sum((1, 2))


def gw_distance(x: torch.Tensor, y: torch.Tensor, *, sample_mask: Optional[torch.Tensor] = None,
                lamda: float = 0.1, iterations: int = 5, ot_iterations: int = 20) -> torch.Tensor:
    """Gromov-Wasserstein distance between token graphs, uniform marginals
    (ref: loss.py:236-275). x [b, n, d], y [b, m, d] -> [b]. gamma is
    detached (ref: loss.py:248 .detach())."""
    Cs = _threshold_relu(cosine_cost(x, x), sample_mask)
    Ct = _threshold_relu(cosine_cost(y, y), sample_mask)
    Cst = cst_plain(Cs, Ct)
    gamma = gw_gamma(Cs, Ct, Cst, lamda, iterations, ot_iterations)
    return gw_trace_plain(Cs, Ct, Cst, gamma)


def got_loss(v: torch.Tensor, q: torch.Tensor, *, sample_mask: Optional[torch.Tensor] = None,
             subsample: Optional[int] = None, generator: Optional[torch.Generator] = None,
             ot_iterations: int = 30, gw_iterations: int = 5,
             gw_ot_iterations: int = 20) -> torch.Tensor:
    """Total GOT loss = sum_b WD + sum_b GWD over valid samples (ref:
    loss.py:278-301). v, q [b, n, d]; sample_mask [b] bool. With `subsample`
    below n, one shared draw of token indices from `generator` (the
    reference's intent; its own draw indexes randperm(batch) into the token
    dim, a documented bug not reproduced)."""
    v, q = v.float(), q.float()
    if subsample is not None and subsample < v.shape[1]:
        if generator is None:
            raise ValueError("got_loss subsampling requires a generator")
        idx = torch.randperm(v.shape[1], generator=generator,
                             device=generator.device)[:subsample].to(v.device)
        v, q = v[:, idx], q[:, idx]
    C = _threshold_relu(cosine_cost(v, q), sample_mask)
    wd = ipot_distance(C, iterations=ot_iterations)
    gwd = gw_distance(v, q, sample_mask=sample_mask, lamda=0.1, iterations=gw_iterations,
                      ot_iterations=gw_ot_iterations)
    if sample_mask is not None:
        wd = torch.where(sample_mask, wd, 0.0)
        gwd = torch.where(sample_mask, gwd, 0.0)
    return wd.sum() + gwd.sum()


def got_loss_multi(v: torch.Tensor, q: torch.Tensor, *,
                   sample_mask: Optional[torch.Tensor] = None, ot_iterations: int = 30,
                   gw_iterations: int = 5, gw_ot_iterations: int = 20,
                   group=None) -> torch.Tensor:
    """All stain pairs' GOT as one batched transport problem -> per-stain
    losses [S] (madeleine_tpu/ops/losses.py:340-443, the fused glue branch).
    v, q [S, b, n, d] (pre-subsampled); sample_mask [S, b].
    Equal to S separate `got_loss` calls: the threshold statistics are taken
    per stain pair (ref: loss.py:288-292), while the S*b problems run through
    the kernels in one launch each: on the card K11 (threshold_build), K8
    (IPOT), K10 (GW gamma), K13 (gw_trace) forward and K14, K9, K12 backward.
    The thresholds' min/max stay here, outside the kernels, so their
    cotangent reaches amin/amax with its even tie split.

    With a process ``group`` (JAX's axis_name) b is this rank's rows: the
    kernels run on the local problems only, the min/max statistics of every
    rank are gathered ([n_dev, 6, S], one collective) so that the thresholds
    are the global batch's, and the per-stain sums are summed over ranks;
    the result equals the single-process global batch's."""
    S, b, n, d = v.shape
    v32 = v.float().reshape(S * b, n, d)
    q32 = q.float().reshape(S * b, n, d)

    def group_stats(C):
        """(min, max), each [S], over each stain group s."""
        Cg = C.reshape(S, b, *C.shape[1:])
        if sample_mask is not None:
            valid = sample_mask[..., None, None]
            return (torch.where(valid, Cg, float("inf")).amin(dim=(1, 2, 3)),
                    torch.where(valid, Cg, float("-inf")).amax(dim=(1, 2, 3)))
        return Cg.amin(dim=(1, 2, 3)), Cg.amax(dim=(1, 2, 3))

    C0 = cosine_cost(v32, q32)
    Cs0 = cosine_cost(v32, v32)
    Ct0 = cosine_cost(q32, q32)
    stats = [group_stats(X) for X in (C0, Cs0, Ct0)]
    if group is not None:
        # the global batch's statistics ([n_dev, 6, S], one collective); the
        # subgradient reaches each min's and max's owner with every rank's share
        g = collectives.gather_stats(torch.stack([x for pair in stats for x in pair]), group,
                                     "got_stats")
        stats = [(g[:, 2 * i].amin(0), g[:, 2 * i + 1].amax(0)) for i in range(3)]
    # thr_s = min + 0.1 (max - min) over stain group s, repeated to [S*b]
    thr3 = torch.stack([(cmin + 0.1 * (cmax - cmin)).repeat_interleave(b)
                        for cmin, cmax in stats], dim=1)                 # [S*b, 3]
    C, Cs, Ct, Cst = threshold_build(C0, Cs0, Ct0, thr3)
    wd = ipot_distance(C, iterations=ot_iterations)                      # [S*b]
    gamma = gw_gamma(Cs, Ct, Cst, 0.1, gw_iterations, gw_ot_iterations)
    total = wd + gw_trace(Cs, Ct, Cst, gamma)
    if sample_mask is not None:
        total = torch.where(sample_mask.reshape(S * b), total, 0.0)
    out = total.reshape(S, b).sum(1)
    return out if group is None else collectives.sum_across(out, group, "got_sums")


def gumbel_noise(seed: int, key: int, streams: torch.Tensor, rows: torch.Tensor, t: int
                 ) -> torch.Tensor:
    """Standard Gumbel noise f32 [*streams.shape, t], -log(-log(u)): u from
    word 0 of Philox4x32-10 with key (seed, key) and counter (token, global
    row, stream, 0), its top 24 bits plus one half over 2**24 (in (0, 1)).
    streams, rows: int tensors of one shape. A token's draw depends on its
    index, its row and its stream alone, not on t. Made where `streams`
    lies; nothing is read back to the host."""
    dev = streams.device
    shape = (*streams.shape, t)
    c0 = torch.arange(t, dtype=torch.int64, device=dev).expand(shape)
    c1 = (rows.to(torch.int64) & prng.MASK32)[..., None].expand(shape)
    c2 = (streams.to(torch.int64) & prng.MASK32)[..., None].expand(shape)
    word = prng.philox4x32(c0, c1, c2, torch.zeros_like(c0), int(seed) & prng.MASK32,
                           int(key) & prng.MASK32)[0]
    u = ((word >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def masked_subsample(x: torch.Tensor, mask: torch.Tensor, subsample: int,
                     gumbel: torch.Tensor) -> torch.Tensor:
    """x [b, n, d], mask [b, n] bool, gumbel [b, n] noise -> [b, subsample, d]:
    per bag the top `subsample` scores of the noise over its valid tokens
    (padding scores _NEG_INF), then idx[pos % max(n_valid, 1)] (JAX
    losses.py:258-289). A bag with n_valid >= subsample gives a subset without
    repeats; a shorter bag tiles a random permutation of its valid tokens;
    an empty bag gives token 0 (JAX's top_k breaks its ties by index).
    topk sorts on the device: nothing is read back to the host."""
    scores = torch.where(mask, gumbel.float(), _NEG_INF)
    idx = torch.topk(scores, subsample, dim=1, sorted=True).indices          # valid first
    n_valid = mask.sum(dim=1, keepdim=True)
    pos = torch.arange(subsample, device=x.device)[None, :]
    idx = torch.gather(idx, 1, pos % n_valid.clamp_min(1))
    idx = torch.where(n_valid > 0, idx, torch.zeros_like(idx))
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


# ---------------------------------------------------------------------------
# Intra-modality loss selector (ref: loss.py:138-156)
# ---------------------------------------------------------------------------

def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a.float() - b.float()))


def make_intra_loss(mode: str, temperature: float) -> Callable[..., torch.Tensor]:
    """Returns loss_fn(query, positive_key, mask=None, symmetric=False)."""
    if mode in ("reconstruct_avg_emb", "reconstruct_masked_emb"):
        return lambda q, k, mask=None, symmetric=False: mse_loss(q, k)
    return functools.partial(info_nce, temperature=temperature)

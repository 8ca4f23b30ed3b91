"""Bag (token) parallelism: one bag's tokens sharded over ranks (port of
`madeleine_tpu/parallel/bag_parallel.py`).

The attention pool is a one-query online softmax, so a bag sharded on its
token axis reduces with one (max, sum) combine: each rank runs the
token-wise MLP and gates on its shard (no communication), pools it with
its softmax statistics (m, s) per (bag, head), and the ranks combine

    M  = max_r m_r                                  (one all-reduce MAX)
    S  = sum_r s_r exp(m_r - M)
    W  = sum_r s_r exp(m_r - M) pooled_r            (one all-reduce SUM of [S | W])
    pooled = W / S

which is the masked softmax pool of the whole bag. The local pool is row
4's kernel on a CUDA tensor (`ops/attn_pool.py::pool_ms_cuda`: the pooled
output with its (m, s)) and its plain version `pool_ms_plain` on a CPU one.
A shard with no valid token has m = NEG_INF and adds nothing; a bag with
none pools to 0, as the port's other pools do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from madeleine_torch.config import HE_POSITION
from madeleine_torch.models.abmil import encoder_weights, gated_attention_logits, pre_attn_mlp
from madeleine_torch.models.madeleine import MADELEINE, _append_stain_encoding, _project
from madeleine_torch.ops.attn_pool import NEG_INF, pool_ms_cuda, pool_ms_plain
from madeleine_torch.parallel import collectives


@torch.no_grad()
def encode_bag_parallel(model: MADELEINE, feats: torch.Tensor, group, *,
                        mask: Optional[torch.Tensor] = None,
                        stain_idx: int = HE_POSITION) -> torch.Tensor:
    """This rank's token shard feats [b, t_local, d] (mask [b, t_local] bool)
    of bags whose tokens are split over `group`'s ranks -> the bags'
    embeddings [b, embed_dim] f32, the same on every rank (JAX
    `encode_bag_parallel`; the stain code is appended to every token of the
    shard, as JAX appends it before sharding). The compute dtype is
    feats.dtype."""
    cfg = model.cfg
    if cfg.activation != "softmax":
        raise ValueError(f"bag parallelism pools with softmax, not {cfg.activation}")
    if cfg.add_stain_encoding:
        feats = _append_stain_encoding(model, feats, stain_idx)
    emb = model.wsi_embedders
    w = encoder_weights(emb)
    b, t, _ = feats.shape
    nh = emb.n_heads
    y = pre_attn_mlp(w, feats)                                        # [b, t, nh * e]
    logits = gated_attention_logits(w, y.reshape(b, t, nh, emb.hidden_dim)).float()
    if mask is not None:
        logits = logits.masked_fill(~mask.to(logits.device)[..., None], NEG_INF)
    pool = pool_ms_cuda if y.is_cuda else pool_ms_plain
    pooled, m, s = pool(y.contiguous(), logits.contiguous())          # [b, E], [b, nh] x 2
    m_all = collectives.reduce_nograd(m, group, "bag_max", op=dist.ReduceOp.MAX)
    scale = s * torch.exp(m - m_all)                                  # s_r exp(m_r - M)
    w_loc = pooled.float().reshape(b, nh, -1) * scale[..., None]
    sums = collectives.reduce_nograd(torch.cat([scale[..., None], w_loc], -1), group,
                                     "bag_sums")                      # [b, nh, 1 + e]
    pooled = sums[..., 1:] / sums[..., :1].clamp_min(1e-30)
    return _project(model, pooled.to(feats.dtype))

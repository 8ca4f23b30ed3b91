"""Launch counts of the port's CUDA kernels, by kernel name.

Each kernel wrapper adds one to its module's counter where it launches its
kernel, and nowhere else; a run shows that its path went through the kernels
by reading the counts before and after it. Beside them, the whole-encoder
op's calls that ran in blocks of whole bags, and their blocks.
"""

from __future__ import annotations

from typing import Dict

from madeleine_torch.models import abmil
from madeleine_torch.ops import (attn_pool, dropout, encode_fused, encoder_train, gated_logits,
                                  gated_pool, got_glue, ipot, linear_tok, preattn)

# kernel name -> (module, counter attribute), in the order of the PERF table
COUNTERS = {
    "encode_fused": (encode_fused, "launches"),             # K1, the live-tile route
    "encode_fused_rowtile": (encode_fused, "rowtile_launches"),   # K1's first design
    "gated_pool": (gated_pool, "launches"),                 # K2, split-TF32 wgmma
    "gated_pool_ffma": (gated_pool, "ffma_launches"),       # K2's first design
    "attn_pool": (attn_pool, "launches"),                   # K3
    "attn_pool_ms": (attn_pool, "pool_ms_launches"),        # 4
    "attn_pool_bwd": (attn_pool, "pool_bwd_launches"),      # 5
    "encoder_train_fwd": (encoder_train, "fwd_launches"),   # K6
    "encoder_train_bwd": (encoder_train, "bwd_launches"),   # K7
    # the save-off route of K6 and the recompute route of K7, counted also above
    "encoder_train_fwd_nosave": (encoder_train, "fwd_nosave_launches"),
    "encoder_train_bwd_recompute": (encoder_train, "bwd_recompute_launches"),
    # K6 and K7 with f32 operands (--precision float32), and their routes
    "encoder_train_fwd_f32": (encoder_train, "fwd_f32_launches"),
    "encoder_train_bwd_f32": (encoder_train, "bwd_f32_launches"),
    "encoder_train_fwd_f32_nosave": (encoder_train, "fwd_f32_nosave_launches"),
    "encoder_train_bwd_f32_recompute": (encoder_train, "bwd_f32_recompute_launches"),
    # calls of K6 / K7 run in more than one block of whole bags, and their
    # blocks (each block one launch above): counted on any device
    "encoder_train_fwd_blocked_calls": (encoder_train, "fwd_blocked_calls"),
    "encoder_train_fwd_blocks": (encoder_train, "fwd_blocks"),
    "encoder_train_bwd_blocked_calls": (encoder_train, "bwd_blocked_calls"),
    "encoder_train_bwd_blocks": (encoder_train, "bwd_blocks"),
    # forward calls of the per-op lane's chain (rows 15-20, 4-5) run in more
    # than one block of whole bags, and their blocks: counted on any device,
    # cfg.remat's recompute included
    "perop_blocked_calls": (abmil, "perop_blocked_calls"),
    "perop_blocks": (abmil, "perop_blocks"),
    "ipot_fwd": (ipot, "fwd_launches"),                     # K8, cluster route
    "ipot_bwd": (ipot, "bwd_launches"),                     # K9, cluster route
    "gw_gamma": (ipot, "gw_launches"),                      # K10, cluster route
    "ipot_fwd_global": (ipot, "fwd_launches_global"),       # K8, global route
    "ipot_bwd_global": (ipot, "bwd_launches_global"),       # K9, global route
    "gw_gamma_global": (ipot, "gw_launches_global"),        # K10, global route
    "threshold_build_fwd": (got_glue, "tb_fwd_launches"),   # K11
    "threshold_build_bwd": (got_glue, "tb_bwd_launches"),   # K12
    "gw_trace_fwd": (got_glue, "gwt_fwd_launches"),         # K13
    "gw_trace_fwd_rowblock": (got_glue, "gwt_fwd_rowblock_launches"),   # K13's first design
    "gw_trace_bwd": (got_glue, "gwt_bwd_launches"),         # K14
    "gw_trace_bwd_rowblock": (got_glue, "gwt_bwd_rowblock_launches"),   # K14's first design
    "preattn_fwd": (preattn, "fwd_launches"),               # 15
    "preattn_fwd_rowblock": (preattn, "fwd_rowblock_launches"),   # 15's first design
    "preattn_bwd": (preattn, "bwd_launches"),               # 16
    "preattn_bwd_rowblock": (preattn, "bwd_rowblock_launches"),   # 16's first design
    "gated_logits_fwd": (gated_logits, "fwd_launches"),     # 17
    "gated_logits_fwd_rowblock": (gated_logits, "fwd_rowblock_launches"),   # 17's first design
    "gated_logits_bwd": (gated_logits, "bwd_launches"),     # 18
    "gated_logits_bwd_rowblock": (gated_logits, "bwd_rowblock_launches"),   # 18's first design
    # rows 15-18 with f32 operands (--precision float32 on the per-op lane)
    "preattn_fwd_f32": (preattn, "fwd_f32_launches"),       # 15, f32
    "preattn_bwd_f32": (preattn, "bwd_f32_launches"),       # 16, f32
    "gated_logits_fwd_f32": (gated_logits, "fwd_f32_launches"),   # 17, f32
    "gated_logits_bwd_f32": (gated_logits, "bwd_f32_launches"),   # 18, f32
    "linear_tok_fwd": (linear_tok, "fwd_launches"),         # 19
    "linear_tok_bwd": (linear_tok, "bwd_launches"),         # 20
    "linear_tok_bwd_mmasync": (linear_tok, "bwd_mmasync_launches"),   # 20's first design
    "dropout": (dropout, "launches"),                       # 21
}


def read() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def reset() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)

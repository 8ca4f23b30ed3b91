"""Launch counts of the port's CUDA kernels, by kernel name.

Each kernel wrapper adds one to its module's counter where it launches its
kernel, and nowhere else; a run shows that its path went through the kernels
by reading the counts before and after it.
"""

from __future__ import annotations

from typing import Dict

from madeleine_torch.ops import (attn_pool, encode_fused, encoder_train, gated_logits, gated_pool,
                                  got_glue, ipot, linear_tok, preattn)

# kernel name -> (module, counter attribute), in the order of the PERF table
COUNTERS = {
    "encode_fused": (encode_fused, "launches"),             # K1
    "gated_pool": (gated_pool, "launches"),                 # K2
    "attn_pool": (attn_pool, "launches"),                   # K3
    "encoder_train_fwd": (encoder_train, "fwd_launches"),   # K6
    "encoder_train_bwd": (encoder_train, "bwd_launches"),   # K7
    "ipot_fwd": (ipot, "fwd_launches"),                     # K8
    "ipot_bwd": (ipot, "bwd_launches"),                     # K9
    "gw_gamma": (ipot, "gw_launches"),                      # K10
    "threshold_build_fwd": (got_glue, "tb_fwd_launches"),   # K11
    "threshold_build_bwd": (got_glue, "tb_bwd_launches"),   # K12
    "gw_trace_fwd": (got_glue, "gwt_fwd_launches"),         # K13
    "gw_trace_bwd": (got_glue, "gwt_bwd_launches"),         # K14
    "preattn_fwd": (preattn, "fwd_launches"),               # 15
    "preattn_bwd": (preattn, "bwd_launches"),               # 16
    "gated_logits_fwd": (gated_logits, "fwd_launches"),     # 17
    "gated_logits_bwd": (gated_logits, "bwd_launches"),     # 18
    "linear_tok_fwd": (linear_tok, "fwd_launches"),         # 19
    "linear_tok_bwd": (linear_tok, "bwd_launches"),         # 20
}


def read() -> Dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def reset() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)

"""Multi-head gated-attention MIL (ABMIL) embedder, eval forward.

PyTorch counterpart of `madeleine_tpu/models/abmil.py` (ref: Model.py:314-451,
abmil.py:8-68). The module tree mirrors the reference's state-dict names, so
a reference ``model.pt`` loads with ``load_state_dict(strict=True)``:

    pre_attn.{0,4,8}        Linear     pre_attn.{1,5,9}   LayerNorm
    attn.{h}.attention_a.0  Linear     attn.{h}.attention_b.0   Linear
    attn.{h}.attention_c    Linear

Layout note: the reference splits the hidden*n_heads axis head-MINOR
(einops '(e c)', feature index = e * n_heads + h, ref Model.py:396). The
parameters keep that order. The kernels and the functions here work
head-MAJOR (index = h * hidden + e, per-head slices contiguous); the
permutation is applied to fc3/ln3 when `encoder_weights` builds the operand
tensors at the kernel boundary, never stored as a second copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from madeleine_torch.ops.attn_pool import (activate_attention, masked_attention_pool,
                                           softmax_pool)
from madeleine_torch.ops.encode_fused import encode_pool_fused
from madeleine_torch.ops.gated_pool import gated_attention_pool

__all__ = ["ABMILEmbedder", "activate_attention", "abmil_embed", "encoder_weights",
           "gate_weights", "gated_attention_logits", "layer_norm", "pre_attn_mlp"]

LN_EPS = 1e-5  # torch nn.LayerNorm default
PRE_ATTN_DROPOUT = 0.1   # ref: Model.py:354,358,362
ATTN_DROPOUT = 0.25      # ref: abmil.py:34-35


class GatedAttention(nn.Module):
    """One head's gated attention net (ref: abmil.py:23-39)."""

    def __init__(self, hidden_dim: int, attn_hidden_dim: int):
        super().__init__()
        self.attention_a = nn.Sequential(nn.Linear(hidden_dim, attn_hidden_dim),
                                         nn.Tanh(), nn.Dropout(ATTN_DROPOUT))
        self.attention_b = nn.Sequential(nn.Linear(hidden_dim, attn_hidden_dim),
                                         nn.Sigmoid(), nn.Dropout(ATTN_DROPOUT))
        self.attention_c = nn.Linear(attn_hidden_dim, 1)


class ABMILEmbedder(nn.Module):
    """Pre-attention MLP + n_heads gated attention nets (ref: Model.py:340-372)."""

    def __init__(self, input_dim: int, hidden_dim: int, n_heads: int,
                 attn_hidden_dim: int = 512):
        super().__init__()
        layers = []
        for i, o in ((input_dim, hidden_dim), (hidden_dim, hidden_dim),
                     (hidden_dim, hidden_dim * n_heads)):
            layers += [nn.Linear(i, o), nn.LayerNorm(o), nn.GELU(),
                       nn.Dropout(PRE_ATTN_DROPOUT)]
        self.pre_attn = nn.Sequential(*layers)
        self.attn = nn.ModuleList(GatedAttention(hidden_dim, attn_hidden_dim)
                                  for _ in range(n_heads))
        self.n_heads = n_heads
        self.hidden_dim = hidden_dim


def _head_major_perm(hidden: int, n_heads: int) -> np.ndarray:
    """perm[j] = head-minor source index of head-major position j:
    j = h * hidden + e  <-  e * n_heads + h (factory.py:47-51)."""
    j = np.arange(hidden * n_heads)
    return (j % hidden) * n_heads + (j // hidden)


def gate_weights(emb: ABMILEmbedder) -> Dict[str, torch.Tensor]:
    """Per-head gate weights stacked over heads, in the reference's [out, in]
    layout: wa/wb [nh, f, e], ba/bb/wc [nh, f], bc [nh]."""
    heads = emb.attn
    return {
        "wa": torch.stack([h.attention_a[0].weight for h in heads]),
        "ba": torch.stack([h.attention_a[0].bias for h in heads]),
        "wb": torch.stack([h.attention_b[0].weight for h in heads]),
        "bb": torch.stack([h.attention_b[0].bias for h in heads]),
        "wc": torch.cat([h.attention_c.weight for h in heads]),
        "bc": torch.cat([h.attention_c.bias for h in heads]),
    }


def encoder_weights(emb: ABMILEmbedder) -> Dict[str, torch.Tensor]:
    """Operand tensors of the whole encoder, head-major: w1..w3 in [out, in]
    layout with biases b*, LN scales s* and shifts t*; fc3's rows and ln3 are
    permuted to head-major here; plus `gate_weights`."""
    p = emb.pre_attn
    perm = torch.as_tensor(_head_major_perm(emb.hidden_dim, emb.n_heads),
                           device=p[8].weight.device)
    w = {"w1": p[0].weight, "b1": p[0].bias, "s1": p[1].weight, "t1": p[1].bias,
         "w2": p[4].weight, "b2": p[4].bias, "s2": p[5].weight, "t2": p[5].bias,
         "w3": p[8].weight[perm], "b3": p[8].bias[perm],
         "s3": p[9].weight[perm], "t3": p[9].bias[perm]}
    w.update(gate_weights(emb))
    return w


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim with f32 statistics, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()
    return y.to(x.dtype)


def pre_attn_mlp(w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """3x [Linear -> LayerNorm -> GELU(exact)], eval mode (ref: Model.py:350-363);
    widths in -> hidden -> hidden -> hidden*n_heads, output head-major.
    w: `encoder_weights`. Runs in x.dtype (f32: full precision, no TF32)."""
    for i in (1, 2, 3):
        x = F.linear(x, w[f"w{i}"].to(x.dtype), w[f"b{i}"].to(x.dtype))
        x = F.gelu(layer_norm(x, w[f"s{i}"], w[f"t{i}"]))
    return x


def gated_attention_logits(attn: Dict[str, torch.Tensor], xh: torch.Tensor) -> torch.Tensor:
    """All-heads gated scores (ref: abmil.py:41-52): xh [..., t, nh, e]
    head-major -> raw logits [..., t, nh]."""
    wa, wb = attn["wa"].to(xh.dtype), attn["wb"].to(xh.dtype)
    a = torch.tanh(torch.einsum("...he,hfe->...hf", xh, wa) + attn["ba"].to(xh.dtype))
    b = torch.sigmoid(torch.einsum("...he,hfe->...hf", xh, wb) + attn["bb"].to(xh.dtype))
    return torch.einsum("...hf,hf->...h", a * b, attn["wc"].to(xh.dtype)) \
        + attn["bc"].to(xh.dtype)


def abmil_embed(
    emb: ABMILEmbedder,
    bags: torch.Tensor,
    *,
    activation: str = "softmax",
    mask: Optional[torch.Tensor] = None,
    return_attention: bool = False,
    return_tokens: bool = False,
):
    """ABMIL eval forward (ref: Model.py:375-451), as abmil.py:255-364 routes it.

    bags [b, t, d_in], mask [b, t] bool. On a CUDA tensor with softmax and
    nothing but the pooled output asked for, bf16 runs the whole encoder in
    kernel K1 (ops/encode_fused.py) and f32 runs the MLP through torch.matmul,
    then kernel K2 (ops/gated_pool.py). With the tokens asked for, the MLP and
    the gates run the plain way and the softmax pool of a CUDA tensor is
    kernel K3 (ops/attn_pool.py); with the logits asked for, the pool is
    plain too (the JAX package's use_pallas=False there).

    Returns pooled [b, nh, e] (head-major), plus raw logits [b, t, nh] if
    return_attention, plus tokens [b, t, nh, e] if return_tokens.
    """
    nh = emb.n_heads
    w = encoder_weights(emb)
    fused_ok = (bags.is_cuda and activation == "softmax" and not return_attention
                and not return_tokens)
    if fused_ok and bags.dtype == torch.bfloat16:
        return encode_pool_fused(w, bags, mask)

    y = pre_attn_mlp(w, bags)
    xh = y.reshape(*y.shape[:-1], nh, emb.hidden_dim)
    if fused_ok:
        return gated_attention_pool(w, xh, mask)

    raw_logits = gated_attention_logits(w, xh)
    if bags.is_cuda and activation == "softmax" and not return_attention:
        pooled = softmax_pool(xh, raw_logits, mask)
    else:
        pooled = masked_attention_pool(xh, raw_logits, mask, activation)
    out: Tuple[torch.Tensor, ...] = (pooled,)
    if return_attention:
        out = out + (raw_logits,)
    if return_tokens:
        out = out + (xh,)
    return out if len(out) > 1 else out[0]

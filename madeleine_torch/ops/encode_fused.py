"""Whole-encoder fused forward (kernel K1, bf16).

Replaces `madeleine_tpu/ops/encode_fused.py::_encode_kernel`. Per token:

    x -> [Linear -> LN -> GELU] x2 -> [Linear 512->2048 -> LN -> GELU] = y32
      -> per-head gates tanh . sigmoid on bf16(y32) -> logits + mask bias
      -> softmax pool of y32 over tokens -> pooled [nh*e], rounded to bf16

with bf16 operands, f32 accumulation and f32 bias/LN/GELU (exact erf);
each layer's output is rounded to bf16 before the next product. A CPU tensor
takes the plain PyTorch version; a CUDA tensor launches the kernel in
csrc/encode_fused.cu or raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from madeleine_torch.ops import _build
from madeleine_torch.ops.attn_pool import mask_bias, softmax_pool_plain

launches = 0  # kernel launches (one per wrapper call on a CUDA tensor)

LN_EPS = 1e-5
HIDDEN = 512       # the kernel's fixed hidden and attention widths
MAX_D_IN = 704     # largest input width whose tiles fit in shared memory
_MATS = ("w1", "w2", "w3", "wa", "wb")
_VECS = ("b1", "s1", "t1", "b2", "s2", "t2", "b3", "s3", "t3", "ba", "bb", "wc", "bc")
_ARG_ORDER = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3",
              "wa", "ba", "wb", "bb", "wc", "bc")


@torch.no_grad()
def encode_pool_fused_plain(x: torch.Tensor, bias: torch.Tensor,
                            w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [b, t, d_in] (bf16 or f32), bias [b, t, nh] f32, w: `abmil.encoder_weights`
    -> pooled [b, nh*e] in x.dtype, with the kernel's cast points."""
    dt = x.dtype
    nh, f, e = w["wa"].shape
    b, t, _ = x.shape

    def layer(h, i):
        z = torch.matmul(h.float(), w[f"w{i}"].to(dt).float().T) + w[f"b{i}"].float()
        z = F.layer_norm(z, z.shape[-1:], w[f"s{i}"].float(), w[f"t{i}"].float(), LN_EPS)
        return F.gelu(z)                                   # exact erf, f32

    h = layer(x, 1).to(dt)
    h = layer(h, 2).to(dt)
    y32 = layer(h, 3)                                      # [b, t, nh*e] f32
    yh = y32.to(dt).float().reshape(b, t, nh, e)           # gates read bf16 y
    a = torch.tanh(torch.einsum("bthe,hfe->bthf", yh, w["wa"].to(dt).float())
                   + w["ba"].float())
    g = torch.sigmoid(torch.einsum("bthe,hfe->bthf", yh, w["wb"].to(dt).float())
                      + w["bb"].float())
    logits = torch.einsum("bthf,hf->bth", a * g, w["wc"].float()) + w["bc"].float() + bias
    return softmax_pool_plain(logits, y32.reshape(b, t, nh, e)).to(dt)


@torch.no_grad()
def encode_fused_cuda(x: torch.Tensor, bias: torch.Tensor,
                      w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Launch kernel K1 on CUDA tensors -> pooled [b, nh*e] bf16. Matrices
    must be bf16, vectors f32, all contiguous on x's device."""
    global launches
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.ndim != 3 \
            or not x.is_contiguous():
        raise ValueError("encode_fused kernel needs a contiguous bf16 CUDA tensor "
                         f"[b, t, d_in], got {x.dtype} {tuple(x.shape)} on {x.device}")
    b, t, d_in = x.shape
    nh, f, e = w["wa"].shape
    if e != HIDDEN or f != HIDDEN or d_in % 16 or d_in > MAX_D_IN or t < 1 or b < 1:
        raise ValueError(f"encode_fused kernel: unsupported widths d_in={d_in}, "
                         f"hidden={e}, attention={f} (needs hidden = attention = "
                         f"{HIDDEN}, d_in % 16 == 0, d_in <= {MAX_D_IN})")
    E = nh * e
    shapes = {"w1": (e, d_in), "w2": (e, e), "w3": (E, e), "wa": (nh, f, e),
              "wb": (nh, f, e), "b1": (e,), "s1": (e,), "t1": (e,), "b2": (e,),
              "s2": (e,), "t2": (e,), "b3": (E,), "s3": (E,), "t3": (E,),
              "ba": (nh, f), "bb": (nh, f), "wc": (nh, f), "bc": (nh,)}
    for k, shape in shapes.items():
        dtype = torch.bfloat16 if k in _MATS else torch.float32
        _build.check_operand("encode_fused", k, w[k], shape, dtype, x.device)
    _build.check_operand("encode_fused", "bias", bias, (b, t, nh), torch.float32, x.device)
    out = _build.launch_split_pool("encode_fused", [x, bias, *(w[k] for k in _ARG_ORDER)],
                                   (b, t, d_in, nh), b, t, nh, E, torch.bfloat16)
    launches += 1
    return out


def kernel_weights(w: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The kernel's operand types: matrices in `dtype`, vectors in f32."""
    out = {k: w[k].to(dtype).contiguous() for k in _MATS}
    out.update({k: w[k].to(torch.float32).contiguous() for k in _VECS})
    return out


@torch.no_grad()
def encode_pool_fused(weights: Dict[str, torch.Tensor], feats: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole-encoder fused forward -> pooled [b, nh, e] in feats.dtype
    (softmax, no dropout). weights: `models.abmil.encoder_weights`."""
    b, t, _ = feats.shape
    nh, _, e = weights["wa"].shape
    bias = mask_bias(mask, b, t, nh, feats.device)
    w = kernel_weights(weights, feats.dtype)
    if feats.device.type == "cpu":
        out = encode_pool_fused_plain(feats, bias, w)
    else:
        out = encode_fused_cuda(feats.contiguous(), bias, w)
    return out.reshape(b, nh, e)

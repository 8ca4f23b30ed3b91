"""Whole-encoder fused forward (kernel K1, bf16).

Replaces `madeleine_tpu/ops/encode_fused.py::_encode_kernel`. Per token:

    x -> [Linear -> LN -> GELU] x2 -> [Linear 512->2048 -> LN -> GELU] = y32
      -> per-head gates tanh . sigmoid on bf16(y32) -> logits + mask bias
      -> softmax pool of y32 over tokens -> pooled [nh*e], rounded to bf16

with bf16 operands, f32 accumulation and f32 bias/LN/GELU (exact erf);
each layer's output is rounded to bf16 before the next product. A CPU tensor
takes the plain PyTorch version; a CUDA tensor launches the kernel in
csrc/encode_fused.cu or raises.

On the card every path takes `encode_fused_cuda`: K6's forward machinery at
dropout rate 0 (the TMA + wgmma GEMM, the LN/GELU row kernels, the gate
products with the logits in their epilogue) over the bag's live 64-token
tiles only. Which tiles are live is decided on the device (`live_tiles_plain`
is the plain version of that decision), and calls are cut into chunks of at
most ROW_BUDGET live rows, which bounds the scratch. The first, single-kernel
design stays reachable as `encode_fused_rowtile_cuda`, a check that no path
calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from madeleine_torch.ops import _build
from madeleine_torch.ops.attn_pool import MASKED_BIAS, mask_bias, softmax_pool_plain
from madeleine_torch.ops.encoder_train import GATE_CHUNK, permute_gates

launches = 0           # launches of the live-tile route (one per wrapper call on a CUDA tensor)
rowtile_launches = 0   # launches of the first design, the check-only entry point

LN_EPS = 1e-5
HIDDEN = 512       # the kernels' fixed hidden and attention widths
MAX_D_IN = 704     # largest input width whose tiles fit the first design's shared memory
TILE_ROWS = 64     # tokens per tile (csrc/encode_fused.cu TM)
# Live rows per chunk of the live-tile route: its scratch is at most
# ROW_BUDGET x (nh e f32 + max(nh e, 2 e + d_in) bf16 + nh f / 64 f32), about
# 0.41 GB at the published widths. One chunk holds the timing shape's 8 x 4096
# token slots, an extracted bag of 9000 tokens (141 tiles) and any serving
# batch up to 32,768 token slots; larger calls run chunk after chunk.
ROW_BUDGET = 32768
_MATS = ("w1", "w2", "w3", "wa", "wb")
_VECS = ("b1", "s1", "t1", "b2", "s2", "t2", "b3", "s3", "t3", "ba", "bb", "wc", "bc")
_ARG_ORDER = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3",
              "wa", "ba", "wb", "bb", "wc", "bc")
_TILES_ORDER = ("w1", "b1", "s1", "t1", "w2", "b2", "s2", "t2", "w3", "b3", "s3", "t3",
                "wab", "bab", "wc", "bc")


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


def live_tiles_plain(bias: torch.Tensor, budget: int = ROW_BUDGET
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the live-tile route's first two kernels
    (csrc/encode_fused.cu tile_flags, live_scan) for bias [b, t, nh]: the
    flags [b * ntiles] of the tile slots (bag-major) holding a token unmasked
    in any head, the live slots in slot order, and each chunk's live rows
    (TILE_ROWS x its live tiles, chunks of `budget` rows of list entries)."""
    b, t, nh = bias.shape
    ntiles = -(-t // TILE_ROWS)
    pad = torch.full((b, ntiles * TILE_ROWS, nh), MASKED_BIAS, dtype=bias.dtype,
                     device=bias.device)
    pad[:, :t] = bias
    flags = (pad.reshape(b * ntiles, TILE_ROWS * nh) > MASKED_BIAS).any(1)
    live = torch.nonzero(flags).flatten()
    cap, nchunks = chunk_plan(b, t, budget)[1:3]
    starts = torch.arange(nchunks) * cap
    rows = TILE_ROWS * (live.numel() - starts).clamp(0, cap)
    return flags, live, rows


def chunk_plan(b: int, t: int, budget: int = ROW_BUDGET) -> Tuple[int, int, int, int]:
    """(tile slots, live tiles per chunk, chunks, scratch rows) of a call:
    the device decides how many slots are live, so the host sizes the
    chunks and the scratch by the slots, within the row budget."""
    slots = b * -(-t // TILE_ROWS)
    cap = max(1, budget // TILE_ROWS)
    return slots, cap, -(-slots // cap), TILE_ROWS * min(cap, slots)


def _check_call(kernel: str, x: torch.Tensor, bias: torch.Tensor, w: Dict[str, torch.Tensor],
                keys) -> Tuple[int, int, int, int, int, int]:
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.ndim != 3 \
            or not x.is_contiguous():
        raise ValueError(f"{kernel} kernel needs a contiguous bf16 CUDA tensor "
                         f"[b, t, d_in], got {x.dtype} {tuple(x.shape)} on {x.device}")
    b, t, d_in = x.shape
    nh, f, e = w["wa"].shape
    if e != HIDDEN or f != HIDDEN or d_in % 16 or d_in > MAX_D_IN or t < 1 or b < 1:
        raise ValueError(f"{kernel} kernel: unsupported widths d_in={d_in}, "
                         f"hidden={e}, attention={f} (needs hidden = attention = "
                         f"{HIDDEN}, d_in % 16 == 0, d_in <= {MAX_D_IN})")
    E = nh * e
    shapes = {"w1": (e, d_in), "w2": (e, e), "w3": (E, e), "wa": (nh, f, e),
              "wb": (nh, f, e), "b1": (e,), "s1": (e,), "t1": (e,), "b2": (e,),
              "s2": (e,), "t2": (e,), "b3": (E,), "s3": (E,), "t3": (E,),
              "ba": (nh, f), "bb": (nh, f), "wc": (nh, f), "bc": (nh,),
              "wab": (nh, 2 * f, e), "bab": (nh, 2 * f)}
    for k in keys:
        dtype = torch.bfloat16 if k in _MATS or k == "wab" else torch.float32
        _build.check_operand(kernel, k, w[k], shapes[k], dtype, x.device)
    _build.check_operand(kernel, "bias", bias, (b, t, nh), torch.float32, x.device)
    return b, t, d_in, nh, e, f


@torch.no_grad()
def encode_fused_cuda(x: torch.Tensor, bias: torch.Tensor,
                      w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Launch K1's live-tile route on CUDA tensors -> pooled [b, nh*e] bf16.
    w: `kernel_weights` (matrices bf16, vectors f32, the permuted gate
    operands wab / bab), all contiguous on x's device. The live tiles and
    their count stay on the device; chunks follow `chunk_plan`."""
    global launches
    b, t, d_in, nh, e, f = _check_call("encode_fused", x, bias, w, _TILES_ORDER)
    if nh not in (1, 2, 4):
        raise ValueError(f"encode_fused kernel: {nh} heads (its row kernels take 1, 2 or 4)")
    for k in ("w1", "w2", "w3", "wab"):
        _build.check_aligned("encode_fused", k, w[k])
    _build.check_aligned("encode_fused", "x", x)
    dev, f32, E = x.device, torch.float32, nh * e
    slots, cap, nchunks, rows = chunk_plan(b, t)
    ints = torch.empty(2 * slots + nchunks, dtype=torch.int32, device=dev)
    # the pool partials m, s [slots, nh] and w [slots, E] in one buffer, w on 256 bytes
    pm = -(-slots * nh // 64) * 64
    part = torch.empty(2 * pm + slots * E, dtype=f32, device=dev)
    out = torch.empty(b, E, dtype=torch.bfloat16, device=dev)
    tensors = [x, bias, *(w[k] for k in _TILES_ORDER), out,
               torch.empty(rows, E, dtype=f32, device=dev),                          # Z
               torch.empty(rows, max(E, 2 * e + d_in), dtype=torch.bfloat16, device=dev),
               torch.empty(rows, nh, f // GATE_CHUNK, dtype=f32, device=dev),       # lpart
               ints[:slots], ints[slots:2 * slots], ints[2 * slots:],   # flag, list, chunk rows
               part[:pm], part[pm:2 * pm], part[2 * pm:]]
    _build.call_ptrs("encode_fused", "encode_fused_tiles_forward", tensors,
                     (b, t, d_in, nh, e, f, cap, nchunks), (), dev)
    launches += 1
    return out


@torch.no_grad()
def encode_fused_rowtile_cuda(x: torch.Tensor, bias: torch.Tensor,
                              w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K1's first design (one kernel, a 64-token tile per block, on
    mma.sync), kept as a check on the card beside `encode_fused_cuda`; no
    path of the port calls it. Arguments as `encode_fused_cuda`."""
    global rowtile_launches
    b, t, d_in, nh, e, _ = _check_call("encode_fused", x, bias, w, _ARG_ORDER)
    out = _build.launch_split_pool("encode_fused", [x, bias, *(w[k] for k in _ARG_ORDER)],
                                   (b, t, d_in, nh), b, t, nh, nh * e, torch.bfloat16)
    rowtile_launches += 1
    return out


def kernel_weights(w: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The kernels' operand types: matrices in `dtype`, vectors in f32, and
    the gate operands in the order of K6's gate product (wab [nh, 2f, e],
    bab [nh, 2f]: `encoder_train.permute_gates`). Built once per weight
    state by the model (`models.abmil.kernel_operands`), not per call."""
    out = {k: w[k].to(dtype).contiguous() for k in _MATS}
    out.update({k: w[k].to(torch.float32).contiguous() for k in _VECS})
    wab, bab = permute_gates(out)
    out.update(wab=wab.contiguous(), bab=bab.contiguous())
    return out


@torch.no_grad()
def encode_pool_fused(w: Dict[str, torch.Tensor], feats: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whole-encoder fused forward -> pooled [b, nh, e] in feats.dtype
    (softmax, no dropout). w: the operands `kernel_weights` builds in
    feats.dtype from `models.abmil.encoder_weights`."""
    b, t, _ = feats.shape
    nh, _, e = w["wa"].shape
    bias = mask_bias(mask, b, t, nh, feats.device)
    if feats.device.type == "cpu":
        out = encode_pool_fused_plain(feats, bias, w)
    else:
        out = encode_fused_cuda(feats.contiguous(), bias, w)
    return out.reshape(b, nh, e)

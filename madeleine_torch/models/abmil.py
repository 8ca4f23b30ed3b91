"""Multi-head gated-attention MIL (ABMIL) embedder: the eval forward, and the
training forward of the per-op lane.

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

Training (`abmil_embed_train`, the per-op lane, JAX abmil.py:134-214,
255-357 with train=True): the pre-attention MLP and the gate logits through
their train ops (ops/preattn.py, ops/gated_logits.py: kernels 15-18 on the
card), then with softmax the training pool `fused_attention_pool` (rows 4
and 5 on the card), with another activation the plain masked pool through
autograd; with n_views=3 each half-bag view through the training pool.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from madeleine_torch.ops import encoder_train as et
from madeleine_torch.ops.attn_pool import (activate_attention, fused_attention_pool,
                                           masked_attention_pool, softmax_pool)
from madeleine_torch.ops.encode_fused import encode_pool_fused, kernel_weights
from madeleine_torch.ops.gated_logits import gated_logits_train
from madeleine_torch.ops.gated_pool import gated_attention_pool, split_operands
from madeleine_torch.ops.preattn import preattn_train

__all__ = ["ABMILEmbedder", "activate_attention", "abmil_embed", "abmil_embed_train",
           "drop_kernel_operands", "encoder_weights", "gate_weights", "gated_attention_logits",
           "head_major_index", "kernel_operands", "layer_norm", "pre_attn_mlp"]

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


def head_major_index(hidden: int, n_heads: int, device) -> torch.Tensor:
    """perm[j] = head-minor source index of head-major position j:
    j = h * hidden + e  <-  e * n_heads + h (factory.py:47-51). Made on
    `device`, with no host copy: the train step never waits for the card."""
    j = torch.arange(hidden * n_heads, device=device)
    return (j % hidden) * n_heads + torch.div(j, hidden, rounding_mode="floor")


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
    perm = head_major_index(emb.hidden_dim, emb.n_heads, p[8].weight.device)
    w = {"w1": p[0].weight, "b1": p[0].bias, "s1": p[1].weight, "t1": p[1].bias,
         "w2": p[4].weight, "b2": p[4].bias, "s2": p[5].weight, "t2": p[5].bias,
         "w3": p[8].weight[perm], "b3": p[8].bias[perm],
         "s3": p[9].weight[perm], "t3": p[9].bias[perm]}
    w.update(gate_weights(emb))
    return w


def kernel_operands(emb: ABMILEmbedder, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The eval kernels' operands of `emb`: in bf16 K1's whole encoder
    (ops/encode_fused.py::kernel_weights: head-major, cast, the gates
    permuted), in f32 K2's gate operands only (ops/gated_pool.py::
    split_operands: the TF32 split of the permuted gates; the f32 route
    reads its MLP weights fresh). Built once per state of the parameters and
    kept on the module, one set per dtype: a served or extracted bag reuses
    them. An in-place change that bumps a parameter's version
    (load_state_dict, a multi-tensor optimizer step) rebuilds them; one that
    bumps none (the fused AdamW step) leaves both sets stale until
    `drop_kernel_operands`, which the trainer calls after every update and
    any other caller of such a step must call too."""
    key = tuple((p.data_ptr(), p._version) for p in emb.parameters())
    cache = emb.__dict__.setdefault("_kernel_operands", {})
    cached = cache.get(dtype)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            if dtype == torch.float32:
                ops = split_operands(**gate_weights(emb))
            else:
                ops = kernel_weights(encoder_weights(emb), dtype)
        cached = cache[dtype] = (key, ops)
    return cached[1]


def drop_kernel_operands(model: nn.Module) -> None:
    """Forget the operands `kernel_operands` keeps on every embedder of
    `model`. The trainer calls it after each update, so an embed after
    training never rests on the parameters' version counters alone."""
    for m in model.modules():
        m.__dict__.pop("_kernel_operands", None)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim with f32 statistics, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()
    return y.to(x.dtype)


def pre_attn_mlp(w: Dict[str, torch.Tensor], x: torch.Tensor, *, seed: Optional[int] = None,
                 row_offset: int = 0) -> torch.Tensor:
    """3x [Linear -> LayerNorm -> GELU(exact)], eval mode (ref: Model.py:350-363);
    widths in -> hidden -> hidden -> hidden*n_heads, output head-major.
    w: `encoder_weights`. Runs in x.dtype (f32: full precision, no TF32).
    With a seed, training: the train op `preattn_train` with its dropout,
    w then `encoder_train.train_operands`; row_offset is the global batch
    row of x's first row."""
    if seed is not None:
        return preattn_train(x, w, seed, row_offset)
    for i in (1, 2, 3):
        x = F.linear(x, w[f"w{i}"].to(x.dtype), w[f"b{i}"].to(x.dtype))
        x = F.gelu(layer_norm(x, w[f"s{i}"], w[f"t{i}"]))
    return x


def gated_attention_logits(attn: Dict[str, torch.Tensor], xh: torch.Tensor, *,
                           seed: Optional[int] = None, row_offset: int = 0) -> torch.Tensor:
    """All-heads gated scores (ref: abmil.py:41-52): xh [..., t, nh, e]
    head-major -> raw logits [..., t, nh]. With a seed, training: the train
    op `gated_logits_train` with its dropout on xh [b, t, nh, e] -> f32
    logits, attn then `encoder_train.train_operands`."""
    if seed is not None:
        b, t, nh, e = xh.shape
        return gated_logits_train(xh.reshape(b, t, nh * e), attn, seed, row_offset)
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
    half_mask: Optional[torch.Tensor] = None,
):
    """ABMIL eval forward (ref: Model.py:375-451), as abmil.py:255-364 routes it.

    bags [b, t, d_in], mask [b, t] bool. On a CUDA tensor with softmax and
    nothing but the pooled output asked for, bf16 runs the whole encoder in
    kernel K1 (ops/encode_fused.py) and f32 runs the MLP through torch.matmul,
    then kernel K2 (ops/gated_pool.py); K1 and K2 read the operands
    `kernel_operands` keeps for the weight state. With the tokens asked
    for, the MLP and the gates run the plain way and the softmax pool of a CUDA tensor is
    kernel K3 (ops/attn_pool.py); with the logits asked for, the pool is
    plain too (the JAX package's use_pallas=False there).

    With half_mask ([t] bool) the two half-bag views pool beside the whole
    bag (n_views=3, abmil.py:338-357): each view's softmax re-normalises the
    raw logits over its half ANDed with `mask`, through K3's op
    (`softmax_pool`: the kernel on a CUDA tensor, its plain version on a
    CPU one; an empty view pools to 0), and the whole bag pools as above.

    Returns pooled [b, nh, e] (head-major; [b, 3, nh, e] with half_mask),
    plus raw logits [b, t, nh] if return_attention, plus tokens [b, t, nh,
    e] if return_tokens.
    """
    nh = emb.n_heads
    fused_ok = (bags.is_cuda and activation == "softmax" and not return_attention
                and not return_tokens and half_mask is None)
    if fused_ok and bags.dtype == torch.bfloat16:
        return encode_pool_fused(kernel_operands(emb, bags.dtype), bags, mask)

    w = encoder_weights(emb)
    if fused_ok and bags.dtype == torch.float32:
        w.update(kernel_operands(emb, torch.float32))

    y = pre_attn_mlp(w, bags)
    xh = y.reshape(*y.shape[:-1], nh, emb.hidden_dim)
    if fused_ok:
        return gated_attention_pool(w, xh, mask)

    raw_logits = gated_attention_logits(w, xh)
    if bags.is_cuda and activation == "softmax" and not return_attention:
        pooled = softmax_pool(xh, raw_logits, mask)
    else:
        pooled = masked_attention_pool(xh, raw_logits, mask, activation)
    if half_mask is not None:
        b, t = bags.shape[:2]
        half = half_mask.reshape(1, t).to(bags.device, torch.bool)
        valid = torch.ones(b, t, dtype=torch.bool, device=bags.device) if mask is None \
            else mask.to(bags.device, torch.bool).reshape(b, t)
        views = [softmax_pool(xh, raw_logits, valid & h) for h in (half, ~half)]
        pooled = torch.stack([pooled] + views, 1)
    out: Tuple[torch.Tensor, ...] = (pooled,)
    if return_attention:
        out = out + (raw_logits,)
    if return_tokens:
        out = out + (xh,)
    return out if len(out) > 1 else out[0]


# The transient bytes one block of whole bags of the per-op lane may take.
# The blocks cannot shrink what a stain keeps from its forward into its
# backward (`perop_saved_row_bytes`: y, and with another activation than
# softmax the plain pool's f32 copy of it: 9.3 GB with softmax in bf16 at
# [65, 32768], 18.1 GB with sigmoid in f32 at [65, 16384]) nor the batch
# beside it (10.9 GB at both), so a block gets less than K6/K7's 48 GiB:
# 32 GiB keeps every call of the steps at 2048 tokens and of the f32 CLI at
# bucket 8192 (21.8 GB reckoned by `perop_row_bytes`) one block; those two
# grown calls (43.6 and 58.9 GB) run in two.
PEROP_BLOCK_BUDGET_BYTES = 32 * 1024 ** 3
perop_blocked_calls = 0   # abmil_embed_train calls run in more than one block (any device)
perop_blocks = 0          # the blocks of those calls


def perop_row_bytes(widths: Sequence[int], itemsize: int, activation: str, n_views: int = 1,
                    need_dx: bool = False) -> int:
    """Transient bytes per row (token) of one block of `abmil_embed_train`,
    the larger of its forward and its backward, from the buffers the ops
    allocate; widths = (d_in, hidden, nh, e, f, d_out), itemsize that of the
    compute dtype. Forward: kernel 15's y, f32 Z, H1 and H2; 17's logits and
    their 64-column partials; with softmax the training pool's masked f32
    logits (each view's too), otherwise the plain pool's f32 copies of y
    (`.float()` in bf16, and the product's permuted copy); the block's
    tokens. Backward: the cotangent of y summed over its readers (the sum
    out of place), then per op what it allocates beside it: 20's (or the
    f32 projector's) dy, the pool's dy (the plain pool's f32 product
    gradient and its cast), 18's DZG and dy, 16's recompute and adjoint
    buffers (Z, U1-U3, rstd, H1, H2, DZ3 in bf16, DH, DZ12, dx with
    need_dx). What outlives a block (the stain's saves) is
    `perop_saved_row_bytes`."""
    d_in, hd, nh, e, f, dout = widths
    q, E, nhf = itemsize, nh * e, nh * f
    y, tok, logits = E * q, dout * q, 4 * nh
    views = 1 if n_views == 1 else 3
    plain = activation != "softmax"
    pre_f = y + 4 * max(hd, E) + 2 * hd * q
    gates_f = y + logits + 4 * nh * (f // 64)
    pool_f = y + 2 * logits + views * logits + ((4 * E if q < 4 else 0) + 4 * E if plain else 0)
    fwd = max(pre_f, gates_f, pool_f) + tok
    dy = 2 * y                                 # the summed cotangent, and a sum out of place
    proj_b = dy + tok + (y if q < 4 else 4 * E)
    pool_b = dy + (4 * E + (2 * E if q < 4 else 0) if plain else y) + logits
    gates_b = dy + 2 * nhf * q + y + logits
    pre_b = (y + 4 * max(hd, E) + 2 * hd * q + E * q + 3 * 4 + 2 * hd * q
             + (E * q if q < 4 else 0) + 4 * hd + hd * q + (d_in * q if need_dx else 0))
    return max(fwd, proj_b, pool_b, gates_b, pre_b)


def perop_saved_row_bytes(widths: Sequence[int], itemsize: int, activation: str,
                          n_views: int = 1) -> int:
    """Bytes per row (token) that one stain's `abmil_embed_train` keeps from
    its forward into its backward, whatever its blocks: y (read by 18, the
    pool and 20), the logits, the pool's masked f32 logits (each view's),
    with another activation than softmax the plain pool's f32 permuted copy
    of y and its activated weights, and the tokens. Under cfg.remat one
    stain's are live at a time (recomputed in its backward); without it,
    every stain's until the backward."""
    d_in, hd, nh, e, f, dout = widths
    q, E = itemsize, nh * e
    views = 1 if n_views == 1 else 3
    plain = 4 * E + 2 * 4 * nh if activation != "softmax" else 0
    return E * q + 4 * nh + views * 4 * nh + plain + dout * q


def perop_blocks_of(b: int, t: int, widths: Sequence[int], dtype: torch.dtype, activation: str,
                    n_views: int = 1, need_dx: bool = False, limit: Optional[int] = None
                    ) -> List[Tuple[int, int]]:
    """The blocks of whole bags of one `abmil_embed_train` call
    (`encoder_train.whole_bag_blocks`, K6/K7's rule): each block's bytes
    (`perop_row_bytes` times its rows) under PEROP_BLOCK_BUDGET_BYTES and,
    on the card, under its total memory less BLOCK_MARGIN (`limit`, from
    `device_total_bytes`: never the free memory, so the blocks, and with
    them the weight gradients' sum order, depend on shapes alone); its rows
    under the kernels' 32-bit limits (`MAX_BLOCK_ROWS`), its bags under rows
    4-5's grid (`MAX_POOL_BAGS`)."""
    row = perop_row_bytes(widths, torch.empty((), dtype=dtype).element_size(), activation,
                          n_views, need_dx)
    return et.whole_bag_blocks(b, t, row, et.MAX_BLOCK_ROWS.get(dtype, 2 ** 31 - 256), limit,
                               PEROP_BLOCK_BUDGET_BYTES, et.MAX_POOL_BAGS, "abmil_embed_train")


def _embed_block(w, bags, activation, seed, mask, row_offset, half_mask, project):
    """`abmil_embed_train`'s chain on one block of whole bags."""
    y = pre_attn_mlp(w, bags, seed=seed, row_offset=row_offset)
    nh, _, e = w["wa"].shape
    xh = y.reshape(*y.shape[:-1], nh, e)
    logits = gated_attention_logits(w, xh, seed=seed, row_offset=row_offset)
    if activation == "softmax":
        whole = fused_attention_pool(xh, logits, mask)
    else:
        whole = masked_attention_pool(xh, logits, mask, activation)
    if half_mask is not None:
        b, t = bags.shape[:2]
        views = [whole]
        for half in (half_mask, ~half_mask):
            half = half.reshape(1, t).expand(b, t)
            views.append(fused_attention_pool(xh, logits, half if mask is None else mask & half))
        whole = torch.stack(views, dim=1)
    return whole, (xh if project is None else project(y))


def abmil_embed_train(w: Dict[str, torch.Tensor], bags: torch.Tensor, *, activation: str,
                      seed: int, mask: Optional[torch.Tensor] = None, row_offset: int = 0,
                      half_mask: Optional[torch.Tensor] = None,
                      project: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                      block_bags: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ABMIL training forward on the per-op lane (JAX abmil.py:255-357 with
    train=True): `pre_attn_mlp` and `gated_attention_logits` through their
    train ops (dropout keyed by seed and the global rows from row_offset),
    then the masked pool of `activation`: with softmax the training pool
    `fused_attention_pool` (abmil.py:329-334), otherwise the plain way
    through autograd (JAX's _pool_reference). With half_mask ([t] bool, the
    split shared by every row: n_views=3) each half also pools through the
    training pool over ``mask & half`` and ``mask & ~half``, softmax
    whatever the activation (abmil.py:349-357). bags [b, t, d_in] in the
    compute dtype, w: `encoder_train.train_operands`, mask [b, t] bool or
    None. project: the token projector, y [b, t, E] -> [b, t, d_out], run
    on each block's y (None returns the head-major tokens).

    The call runs in blocks of whole bags (`perop_blocks_of`, by shape, dtype
    and the card's total memory; block_bags forces a block size), each the
    whole chain at row offset row_offset + b0, so each draws the unblocked
    call's dropout masks; the blocks' pooled outputs and tokens are
    concatenated (equal to the unblocked call's bit for bit) and autograd
    sums the weight gradients over the blocks. One block is exactly the
    unblocked call. Returns (pooled [b, nh, e], or [b, 3, nh, e] with
    half_mask: the whole bag, half 1, half 2; tokens [b, t, nh, e], or
    project's output), both in bags.dtype."""
    global perop_blocked_calls, perop_blocks
    b, t, d_in = bags.shape
    if block_bags is None:
        nh, f, e = w["wa"].shape
        widths = (d_in, w["w1"].shape[0], nh, e, f, 0 if project is None else w["wt"].shape[0])
        blocks = perop_blocks_of(b, t, widths, bags.dtype, activation,
                                 1 if half_mask is None else 3, bags.requires_grad,
                                 et.device_total_bytes(bags.device))
    else:
        blocks = [(b0, min(b0 + block_bags, b)) for b0 in range(0, b, block_bags)]
    if len(blocks) == 1:
        return _embed_block(w, bags, activation, seed, mask, row_offset, half_mask, project)
    parts = [_embed_block(w, bags[b0:b1], activation, seed,
                          None if mask is None else mask[b0:b1], row_offset + b0, half_mask,
                          project) for b0, b1 in blocks]
    perop_blocked_calls += 1
    perop_blocks += len(blocks)
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

"""MADELEINE multistain slide encoder, eval forward.

PyTorch counterpart of `madeleine_tpu/models/madeleine.py` (ref: Model.py:45-216):

  feats [bs, t, d] --(optional stain encoding, Model.py:125-132,177-189)-->
  ABMIL embedder (models/abmil.py) --> pooled [bs, nh, e] --> projector --> [bs, hidden]

The module holds its config (``model.cfg``); parameter names are the
reference's, so ``model.pt`` files load strictly. The training forward
(`forward_train`, n_views 1 or 3, with or without stain encodings) runs the whole
encoder through the train op of ops/encoder_train.py with softmax, and the
per-op lane with any other activation or with MADELEINE_NO_FUSED_ENCODER set
(`abmil_embed_train`, then the token projector's train op,
ops/linear_tok.py); its eval mode (``train=False``) runs `abmil_embed` per
modality, whose softmax pool on the card is kernel K3 (also the
half-bag views' pools at n_views=3).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from madeleine_torch.config import HE_POSITION, MadeleineConfig
from madeleine_torch.models.abmil import (ABMILEmbedder, abmil_embed, abmil_embed_train,
                                          encoder_weights, head_major_index)
from madeleine_torch.ops.encoder_train import encoder_train, train_operands
from madeleine_torch.ops.linear_tok import linear_tok_train


class MADELEINE(nn.Module):
    """Parameter tree of the reference model (ref: Model.py:50-94):
    wsi_embedders, token_projector (hidden*nh -> 128), projector
    (hidden*nh -> hidden) and, with stain encodings, embedding [n_mod, 32]."""

    def __init__(self, cfg: MadeleineConfig):
        super().__init__()
        if cfg.wsi_encoder != "abmil":
            raise ValueError(f'Unsupported wsi_encoder. Must be "abmil". Now is {cfg.wsi_encoder}.')
        self.cfg = cfg
        hidden, nh = cfg.wsi_encoder_hidden_dim, cfg.n_heads
        self.wsi_embedders = ABMILEmbedder(cfg.input_dim, hidden, nh,
                                           cfg.attention_hidden_dim)
        self.token_projector = nn.Linear(hidden * nh, cfg.token_proj_dim)
        self.projector = nn.Linear(hidden * nh, hidden)
        if cfg.add_stain_encoding:
            self.embedding = nn.Embedding(cfg.n_modalities, cfg.stain_encoding_dim)


def init_madeleine(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh weights from a seeded generator, in the regime of the JAX
    package's init (abmil.py:55-68): every Linear U(+-1/sqrt(fan_in)) for
    weight and bias, LayerNorm ones/zeros, stain codes N(0, 1). It walks any
    module, so it also initialises a head of `models/heads.py` (the regime
    of JAX's `init_mlp_params` / `init_proj_head_params`)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                nn.init.uniform_(mod.weight, -bound, bound, generator=generator)
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, generator=generator)
    return model


def _append_stain_encoding(model: MADELEINE, feats: torch.Tensor, stain_idx) -> torch.Tensor:
    """Concat the learned per-stain code to every patch feature
    (ref: Model.py:125-132,177-189). feats [..., t, d]; stain_idx an int, or
    a [n] index tensor for feats [n, t, d]. The code is cast to feats' dtype
    before the concat, so the table's gradient flows back through the cast."""
    enc = model.embedding.weight[stain_idx].to(feats.dtype).unsqueeze(-2)
    enc = enc.expand(*feats.shape[:-1], enc.shape[-1])
    return torch.cat([feats, enc], dim=-1)


def _project(model: MADELEINE, pooled: torch.Tensor) -> torch.Tensor:
    """Head-major pooled [bs, nh, e] -> projector (reference head-minor
    input order) -> [bs, hidden] f32."""
    bs = pooled.shape[0]
    flat = pooled.transpose(1, 2).reshape(bs, -1).float()   # index e * nh + h
    return F.linear(flat, model.projector.weight.float(), model.projector.bias.float())


@torch.no_grad()
def encode(model: MADELEINE, feats: torch.Tensor, *, stain_idx: int = HE_POSITION,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-stain slide encoding [bs, t, d] -> [bs, embed_dim] f32.

    stain_idx=0 is `encode_he` (ref: Model.py:97-107); other indices are the
    per-stain eval branch (ref: Model.py:162-203) with the stain-encoding
    concat when enabled. The compute dtype is feats.dtype."""
    cfg = model.cfg
    if cfg.add_stain_encoding:
        feats = _append_stain_encoding(model, feats, stain_idx)
    pooled = abmil_embed(model.wsi_embedders, feats, activation=cfg.activation,
                         mask=mask)
    return _project(model, pooled)


def encode_he(model: MADELEINE, feats: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference method name (ref: Model.py:97-107)."""
    return encode(model, feats, stain_idx=HE_POSITION, mask=mask)


def train_weights(model: MADELEINE, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The encoder_train operands (head-major, in the autograd graph of the
    reference-ordered parameters): `encoder_weights` plus the token
    projector with its input columns permuted to head-major."""
    emb = model.wsi_embedders
    perm = head_major_index(emb.hidden_dim, emb.n_heads, model.token_projector.weight.device)
    w = encoder_weights(emb)
    w["wt"] = model.token_projector.weight[:, perm]
    w["bt"] = model.token_projector.bias
    return train_operands(w, dtype)


def _linear_head_major(model: MADELEINE, layer: nn.Linear, x: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Head-major x [..., nh, e] -> `layer` (the projector or the token
    projector, reference head-minor input order) in the compute dtype: the
    JAX package's _linear on the bridge-permuted rows."""
    emb = model.wsi_embedders
    perm = head_major_index(emb.hidden_dim, emb.n_heads, x.device)
    return F.linear(x.flatten(-2), layer.weight[:, perm].to(dtype), layer.bias.to(dtype))


def _slide_projection(model: MADELEINE, pooled: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The slide projector on head-major pooled [..., nh, e] in the compute
    dtype (`_linear_head_major`). In f32 its product runs in float64 and is
    rounded once to f32: the correctly rounded value of the JAX package's
    HIGHEST-precision product, the same for a row at any batch size. An f32
    GEMM's rounding depends on the rows it is given (4.5e-7 relative between
    64 rows and two halves of 32 on an H100): a data-parallel rank holds
    part of the batch, and InfoNCE's nearly cancelling projector-bias
    gradient amplified that to 1.08e-4 against one process (ROADMAP C2)."""
    if dtype != torch.float32:
        return _linear_head_major(model, model.projector, pooled, dtype)
    return _linear_head_major(model, model.projector, pooled.double(), torch.float64).float()


@torch.no_grad()
def _forward_eval(model: MADELEINE, feats: torch.Tensor, mask: Optional[torch.Tensor],
                  half: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward (JAX madeleine.py:309-318): per modality, its stain
    code when enabled, `abmil_embed` with the tokens returned (on the card:
    the plain MLP and gates, then K3's softmax pool; with a half split
    [t], K3 also pools each half-bag view), the projector and the token
    projector in the compute dtype. Slides [bs, n_mod, 1 or 3, hidden]."""
    cfg = model.cfg
    bs, n_mod, t, _ = feats.shape
    dt = feats.dtype
    slides, toks = [], []
    for i in range(n_mod):
        x = feats[:, i]
        if cfg.add_stain_encoding:
            x = _append_stain_encoding(model, x, i)
        pooled, tokens = abmil_embed(model.wsi_embedders, x, activation=cfg.activation,
                                     mask=None if mask is None else mask[:, i],
                                     return_tokens=True, half_mask=half)
        slides.append(_slide_projection(model, pooled, dt))
        toks.append(_linear_head_major(model, model.token_projector, tokens, dt))
    slides = torch.stack(slides, 1)
    return (slides if half is not None else slides[:, :, None]), torch.stack(toks, 1)


VIEW_STREAM = 0x56494557   # keys the half-bag split apart from the dropout and GOT draws


def half_split(seed: int, t: int, device) -> torch.Tensor:
    """The step's half-bag split [t] bool, shared by every row (JAX
    madeleine.py:185-192, abmil.py:349-352): the ranks of a random
    permutation of t, ``ranks < t // 2``. The permutation comes from a
    generator keyed by (seed, VIEW_STREAM), as trainer.got_generator keys
    the GOT draw, so a resumed run draws the same split."""
    key = int(np.random.SeedSequence([seed, VIEW_STREAM]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(key)
    perm = torch.randperm(t, generator=gen, device=device)
    return torch.zeros(t, dtype=torch.bool, device=device).scatter_(0, perm[:t // 2], True)


def project_tokens(y: torch.Tensor, wt: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The per-op lane's token projector in training, routed as the JAX
    package routes it (madeleine.py:93-103): bf16 through the train op of
    ops/linear_tok.py (kernels 19/20 on the card), f32 through a plain
    product, full f32 (no TF32: `utils.device.full_precision_matmul`, as on
    the loss path), as JAX's HIGHEST-precision `_linear`. y [b, t, E]
    head-major, wt [d_out, E] in y's dtype, bt [d_out] f32."""
    if y.dtype == torch.bfloat16:
        return linear_tok_train(y, wt, bt)
    return F.linear(y, wt, bt.to(y.dtype))


def fused_route(cfg) -> bool:
    """Whether a training forward takes the fused train op (K6/K7): softmax
    attention with MADELEINE_NO_FUSED_ENCODER unset or empty (read at each
    call); otherwise the per-op lane (JAX madeleine.py:157-174)."""
    return cfg.activation == "softmax" and not os.environ.get("MADELEINE_NO_FUSED_ENCODER")


def forward_train(model: MADELEINE, feats: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None, n_views: int = 1, seed: int = 0,
                  train: bool = True, half_mask: Optional[torch.Tensor] = None,
                  row_start: int = 0, global_bs: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward (ref: Model.py:110-159) at the dropout rates of the
    train ops; with ``train=False`` the eval forward (no dropout, no
    gradient; `_forward_eval`). With softmax the whole encoder runs through
    the train op of ops/encoder_train.py (kernels K6/K7 on a CUDA tensor);
    with another activation, or with the environment variable
    MADELEINE_NO_FUSED_ENCODER set to any non-empty value (read at each
    call), through the per-op lane, as the JAX package routes it
    (madeleine.py:157-174,226-248): `abmil_embed_train` (kernels 15-18, then
    with softmax the training pool, rows 4/5, else the plain pool) and the
    token projector (`project_tokens`: kernels 19/20 in bf16).

    feats [bs, n_mod, t, d] in the compute dtype; mask [bs, n_mod, t] bool;
    seed: the step's dropout seed. n_views=3 (the intra-modality loss) adds
    two half-bag views of every row: one split per step (`half_split`, or
    the given half_mask [t] bool), shared by every row and modality and
    handed to both routes (JAX madeleine.py:185-192, abmil.py:338-357). The
    eval forward takes the same split (seed 0 by default, as JAX's eval
    draws from PRNGKey(0), madeleine.py:149) and pools the views in K3.
    cfg.modality_scan runs one encoder call per modality (the canonical
    route, [bs, t, d] each, global rows m*BS + i), and with cfg.remat on
    the per-op lane each modality's body under a checkpoint (its backward
    recomputes it: one modality's saves live at a time); otherwise one joint
    call over [bs*n_mod, t, d] (rows i*n_mod + m). Under data parallelism feats
    holds one rank's rows of a global batch of ``global_bs`` (None: bs) rows,
    its first row being global row ``row_start``: the dropout masks are
    keyed by the single-process step's global rows (JAX madeleine.py:151-155),
    m*BS + row_start + i on the scan route and (row_start + i)*n_mod + m on
    the joint one, so that N ranks draw the masks one process draws.
    With stain encodings each modality's rows carry its own stain code, and
    the input gradient reaches the table. Documented deviation (JAX
    madeleine.py:213-218): the reference builds train-time stain ids
    mod-major but flattens feats b-major, misassigning the codes whenever
    bs != 1; the correct per-stain id is used here, as in the JAX package.
    With a ragged mask the padding of each bag is masked out of every pool
    and logit; each fused call takes the route that `resolve_save_acts` gives it.
    Returns slide_embs [bs, n_mod, n_views, hidden] and token_embs
    [bs, n_mod, t, 128], both in feats.dtype."""
    cfg = model.cfg
    if n_views not in (1, 3):
        raise ValueError(f"n_views must be 1 or 3, got {n_views}")
    bs, n_mod, t, d = feats.shape
    if n_views == 3 and half_mask is None:
        half_mask = half_split(seed, t, feats.device)
    half = None if n_views == 1 else half_mask.reshape(t).to(feats.device, torch.bool)
    if not train:
        return _forward_eval(model, feats, mask, half)
    global_bs = bs if global_bs is None else global_bs
    dt = feats.dtype
    se = cfg.add_stain_encoding
    w = train_weights(model, dt)
    fused = fused_route(cfg)

    def encode(x, m, row_offset):
        """(pooled [n, nh, e] or [n, 3, nh, e], tokens [n, t, 128]) of the rows x [n, t, d]."""
        if fused:
            return encoder_train(x, m, w, seed, row_offset=row_offset, need_dx=se,
                                 half_mask=half)
        return abmil_embed_train(w, x, activation=cfg.activation, seed=seed, mask=m,
                                 row_offset=row_offset, half_mask=half,
                                 project=lambda y: project_tokens(y, w["wt"], w["bt"]))

    if not cfg.modality_scan:
        x = feats.reshape(bs * n_mod, t, d)
        if se:   # row i*n_mod + m is modality m
            ids = torch.arange(n_mod, device=feats.device).repeat(bs)
            x = _append_stain_encoding(model, x, ids)
        m = None if mask is None else mask.reshape(bs * n_mod, t)
        pooled, tok = encode(x, m, row_start * n_mod)
        slide = _slide_projection(model, pooled, dt)
        return (slide.reshape(bs, n_mod, n_views, -1), tok.reshape(bs, n_mod, t, -1))

    def per_modality(x, m, i):
        """One modality's body (JAX's `_per_modality`): the stain code, the
        encoder, the projector -> (slide [bs, n_views, hidden], tokens)."""
        if se:
            x = _append_stain_encoding(model, x, i)
        pooled, tok = encode(x, m, i * global_bs + row_start)
        return _slide_projection(model, pooled, dt), tok

    # cfg.remat on the per-op lane: each modality's body under a checkpoint,
    # as JAX's scan body under jax.checkpoint (madeleine.py:283-298), so its
    # backward recomputes the body and one modality's saves are live at a
    # time. The lane draws no torch RNG (its dropout is Philox keyed by seed
    # and global row), so the recompute needs no RNG state and repeats the
    # forward bit for bit. The fused lane is not wrapped: K7 already rebuilds
    # K6's rows on its recompute route, and a checkpoint would run K6 twice.
    remat = cfg.remat and not fused
    slides, toks = [], []
    for i in range(n_mod):
        x = feats[:, i]
        m = None if mask is None else mask[:, i]
        if remat:
            slide, tok = torch.utils.checkpoint.checkpoint(per_modality, x, m, i,
                                                           use_reentrant=False,
                                                           preserve_rng_state=False)
        else:
            slide, tok = per_modality(x, m, i)
        slides.append(slide)
        toks.append(tok)
    return torch.stack(slides, 1).reshape(bs, n_mod, n_views, -1), torch.stack(toks, 1)


def forward_train_dict(model: MADELEINE, feats: torch.Tensor, **kw):
    """Reference-shaped output: {modality: emb} dicts, HE replicated on a
    trailing stain axis (ref: Model.py:149-159)."""
    slide_embs, token_embs = forward_train(model, feats, **kw)
    mods = model.cfg.MODALITIES
    wsi, tok = {}, {}
    for idx, modality in enumerate(mods):
        s, tk = slide_embs[:, idx], token_embs[:, idx]
        if modality == "HE":
            reps = max(len(mods) - 1, 1)
            s = s[..., None].expand(*s.shape, reps)
            tk = tk[..., None].expand(*tk.shape, reps)
        wsi[modality], tok[modality] = s, tk
    return wsi, tok


@torch.no_grad()
def encode_with_attention(model: MADELEINE, feats: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HE encoding + raw attention logits [bs, t, nh] (ref: Model.py:206-216).
    Always the plain route: the logits are an output."""
    cfg = model.cfg
    if cfg.add_stain_encoding:
        feats = _append_stain_encoding(model, feats, HE_POSITION)
    pooled, raw = abmil_embed(model.wsi_embedders, feats, activation=cfg.activation,
                              mask=mask, return_attention=True)
    return _project(model, pooled), raw

"""MADELEINE multistain slide encoder, eval forward.

PyTorch counterpart of `madeleine_tpu/models/madeleine.py` (ref: Model.py:45-216):

  feats [bs, t, d] --(optional stain encoding, Model.py:125-132,177-189)-->
  ABMIL embedder (models/abmil.py) --> pooled [bs, nh, e] --> projector --> [bs, hidden]

The module holds its config (``model.cfg``); parameter names are the
reference's, so ``model.pt`` files load strictly. The training forward
(`forward_train`, n_views=1, softmax, with or without stain encodings) runs
the whole encoder through the train op of ops/encoder_train.py; its eval
mode (``train=False``) runs `abmil_embed` per modality, whose softmax pool
on the card is kernel K3.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from madeleine_torch.config import HE_POSITION, MadeleineConfig
from madeleine_torch.models.abmil import (ABMILEmbedder, _head_major_perm, abmil_embed,
                                          encoder_weights)
from madeleine_torch.ops.encoder_train import encoder_train, train_operands


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


def init_madeleine(model: MADELEINE, generator: torch.Generator) -> MADELEINE:
    """Fresh weights from a seeded generator, in the regime of the JAX
    package's init (abmil.py:55-68): every Linear U(+-1/sqrt(fan_in)) for
    weight and bias, LayerNorm ones/zeros, stain codes N(0, 1)."""
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
    perm = torch.as_tensor(_head_major_perm(emb.hidden_dim, emb.n_heads),
                           device=model.token_projector.weight.device)
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
    perm = torch.as_tensor(_head_major_perm(emb.hidden_dim, emb.n_heads), device=x.device)
    return F.linear(x.flatten(-2), layer.weight[:, perm].to(dtype), layer.bias.to(dtype))


@torch.no_grad()
def _forward_eval(model: MADELEINE, feats: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward (JAX madeleine.py:309-318): per modality, its stain
    code when enabled, `abmil_embed` with the tokens returned (on the card:
    the plain MLP and gates, then K3's softmax pool), the projector and the
    token projector in the compute dtype."""
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
                                     return_tokens=True)
        slides.append(_linear_head_major(model, model.projector, pooled, dt))
        toks.append(_linear_head_major(model, model.token_projector, tokens, dt))
    return torch.stack(slides, 1)[:, :, None], torch.stack(toks, 1)


def forward_train(model: MADELEINE, feats: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None, n_views: int = 1, seed: int = 0,
                  train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward (ref: Model.py:110-159), through the whole-encoder
    train op (ops/encoder_train.py: kernels K6/K7 on a CUDA tensor) at its
    dropout rates; with ``train=False`` the eval forward (no dropout, no
    gradient; `_forward_eval`).

    feats [bs, n_mod, t, d] in the compute dtype; mask [bs, n_mod, t] bool;
    seed: the step's dropout seed. cfg.modality_scan runs one op call per
    modality (the canonical route, [bs, t, d] each, global rows m*bs + i);
    otherwise one joint call over [bs*n_mod, t, d] (rows i*n_mod + m). With
    stain encodings each modality's rows carry its own stain code, and the
    op returns dx so that the table learns. Documented deviation (JAX
    madeleine.py:213-218): the reference builds train-time stain ids
    mod-major but flattens feats b-major, misassigning the codes whenever
    bs != 1; the correct per-stain id is used here, as in the JAX package.
    Returns slide_embs [bs, n_mod, 1, hidden] and token_embs
    [bs, n_mod, t, 128], both in feats.dtype."""
    cfg = model.cfg
    if n_views != 1:
        raise NotImplementedError("n_views=3 is not ported (ROADMAP.md D3b)")
    if cfg.activation != "softmax" and train:
        raise NotImplementedError(f"activation {cfg.activation!r} in training is not ported "
                                  "(ROADMAP.md D6: the per-op lane)")
    if not train:
        return _forward_eval(model, feats, mask)
    bs, n_mod, t, d = feats.shape
    dt = feats.dtype
    se = cfg.add_stain_encoding
    w = train_weights(model, dt)
    if not cfg.modality_scan:
        x = feats.reshape(bs * n_mod, t, d)
        if se:   # row i*n_mod + m is modality m
            ids = torch.arange(n_mod, device=feats.device).repeat(bs)
            x = _append_stain_encoding(model, x, ids)
        m = None if mask is None else mask.reshape(bs * n_mod, t)
        pooled, tok = encoder_train(x, m, w, seed, need_dx=se)
        slide = _linear_head_major(model, model.projector, pooled, dt)
        return (slide.reshape(bs, n_mod, 1, -1), tok.reshape(bs, n_mod, t, -1))
    slides, toks = [], []
    for i in range(n_mod):
        x = feats[:, i]
        if se:
            x = _append_stain_encoding(model, x, i)
        m = None if mask is None else mask[:, i]
        pooled, tok = encoder_train(x, m, w, seed, row_offset=i * bs, need_dx=se)
        slides.append(_linear_head_major(model, model.projector, pooled, dt))
        toks.append(tok)
    return torch.stack(slides, 1)[:, :, None], torch.stack(toks, 1)


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

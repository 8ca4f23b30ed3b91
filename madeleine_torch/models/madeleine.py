"""MADELEINE multistain slide encoder, eval forward.

PyTorch counterpart of `madeleine_tpu/models/madeleine.py` (ref: Model.py:45-216):

  feats [bs, t, d] --(optional stain encoding, Model.py:125-132,177-189)-->
  ABMIL embedder (models/abmil.py) --> pooled [bs, nh, e] --> projector --> [bs, hidden]

The module holds its config (``model.cfg``); parameter names are the
reference's, so ``model.pt`` files load strictly. The training forward waits
for a later slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from madeleine_torch.config import HE_POSITION, MadeleineConfig
from madeleine_torch.models.abmil import ABMILEmbedder, abmil_embed


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


def _append_stain_encoding(model: MADELEINE, feats: torch.Tensor, stain_idx: int) -> torch.Tensor:
    """Concat the learned per-stain code to every patch feature
    (ref: Model.py:177-189)."""
    enc = model.embedding.weight[stain_idx].to(feats.dtype)
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

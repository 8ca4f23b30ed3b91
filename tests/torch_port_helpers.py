"""Shared set-up for the tests that hold `madeleine_torch` against `madeleine_tpu`.

The same numpy arrays, made from a seed, go to the JAX function and to its
PyTorch counterpart; JAX parameter trees cross over through
`madeleine_torch.models.factory.params_from_jax`.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import torch

from madeleine_tpu.config import MadeleineConfig as JaxConfig
from madeleine_tpu.models.madeleine import init_madeleine_params
from madeleine_torch.config import HE_POSITION, MadeleineConfig
from madeleine_torch.models.abmil import encoder_weights, pre_attn_mlp
from madeleine_torch.models.factory import params_from_jax
from madeleine_torch.models.madeleine import MADELEINE, _append_stain_encoding, _project
from madeleine_torch.ops.encode_fused import encode_pool_fused, kernel_weights
from madeleine_torch.ops.gated_pool import gated_attention_pool

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# small widths: d_in 64, hidden 128, 2 heads, attention width 64
SMALL = dict(patch_embedding_dim=64, wsi_encoder_hidden_dim=128,
             attention_hidden_dim=64, n_heads=2, precision="float32",
             dataset="__test__", MODALITIES=["HE", "HER2", "PGR"])


def configs(**overrides):
    """(JAX config, port config) with equal fields."""
    fields = dict(SMALL, **overrides)
    return JaxConfig(**fields).finalize(), MadeleineConfig(**fields).finalize()


def jax_params(cfg, seed: int = 0):
    """JAX init as numpy, with LayerNorm affines perturbed so that the scale
    and shift paths (and the head-major permutation of ln3) are exercised."""
    params = jax.tree_util.tree_map(
        np.asarray, init_madeleine_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)
    for ln in ("ln1", "ln2", "ln3"):
        p = params["wsi_embedders"]["pre_attn"][ln]
        p["scale"] = (1.0 + 0.1 * rng.standard_normal(p["scale"].shape)).astype(np.float32)
        p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)).astype(np.float32)
    return params


def port_model(cfg, params) -> MADELEINE:
    model = MADELEINE(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def ragged_mask(lengths, t: int) -> np.ndarray:
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def flagship_state_dict(**kw):
    sys.path.insert(0, GOLDEN_DIR)
    try:
        from generate import flagship_state_dict as fsd
    finally:
        sys.path.remove(GOLDEN_DIR)
    return fsd(**kw)


def to_torch(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


@torch.no_grad()
def kernel_route_encode(model: MADELEINE, feats: torch.Tensor, *, stain_idx: int = HE_POSITION,
                        mask=None) -> torch.Tensor:
    """`encode` by the route a CUDA tensor takes in `abmil_embed`, called on
    CPU tensors so that each kernel wrapper runs its plain version: bf16 ->
    encode_pool_fused (K1); f32 -> pre_attn_mlp, then gated_attention_pool (K2)."""
    if model.cfg.add_stain_encoding:
        feats = _append_stain_encoding(model, feats, stain_idx)
    emb = model.wsi_embedders
    w = encoder_weights(emb)
    if feats.dtype == torch.bfloat16:
        pooled = encode_pool_fused(kernel_weights(w, feats.dtype), feats, mask)
    else:
        y = pre_attn_mlp(w, feats)
        pooled = gated_attention_pool(
            w, y.reshape(*y.shape[:-1], emb.n_heads, emb.hidden_dim), mask)
    return _project(model, pooled)



def param_pair(seed: int = 0, **overrides):
    """(JAX config, port config, JAX params as numpy, port model) from one seed."""
    jcfg, pcfg = configs(**overrides)
    params = jax_params(jcfg, seed)
    return jcfg, pcfg, params, port_model(pcfg, params)


def grads_as_state_dict(grads, params):
    """A JAX gradient pytree (any subset of the parameter tree) -> the port's
    state-dict layout; missing subtrees count as zero."""
    full = jax.tree_util.tree_map(np.zeros_like, params)
    for k, v in grads.items():
        if k == "wsi_embedders":
            full[k].update(jax.tree_util.tree_map(np.asarray, v))
        else:
            full[k] = jax.tree_util.tree_map(np.asarray, v)
    return params_from_jax(full)


def train_batch(rng, bs: int = 8, n_mod: int = 3, t: int = 24, d: int = 64,
                he_only: bool = False, signal: float = 0.0):
    """Synthetic train batch (numpy): feats [bs, n_mod, t, d], modality_labels
    [bs, n_mod], sample_mask [bs]. signal > 0 adds a per-case vector shared by
    every stain of the case, so cross-stain alignment is learnable. Missing
    stains are zeroed, as the dataset's placeholder does."""
    feats = rng.standard_normal((bs, n_mod, t, d)).astype(np.float32)
    if signal:
        feats += signal * rng.standard_normal((bs, 1, 1, d)).astype(np.float32)
    labels = np.ones((bs, n_mod), np.float32)
    if he_only:
        labels[:, 1:] = 0.0
    else:
        labels[:, 1] = (rng.random(bs) < 0.8).astype(np.float32)
        labels[:, 2:] = (rng.random((bs, n_mod - 2)) < 0.6).astype(np.float32)
    feats = feats * labels[:, :, None, None]
    return {"feats": feats, "modality_labels": labels, "sample_mask": np.ones(bs, bool)}


def golden_model(gold) -> MADELEINE:
    """The port model with golden.npz's state dict (d_in 24, 2 heads, 3 stains)."""
    sd = {k[len("sd/"):]: torch.from_numpy(gold[k]) for k in gold.files if k.startswith("sd/")}
    cfg = MadeleineConfig(patch_embedding_dim=24, wsi_encoder_hidden_dim=512,
                          attention_hidden_dim=512, n_heads=2, precision="float32",
                          dataset="__golden__", MODALITIES=["HE", "HER2", "PGR"]).finalize()
    model = MADELEINE(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def flagship_model(stain_encoding: bool = False, **cfg_fields) -> MADELEINE:
    """The port model at the published widths with the flagship weights
    (golden_flagship.npz's `fs/*` model, or with stain encodings its `se/*`)."""
    cfg = MadeleineConfig(**dict(dict(precision="float32", dataset="ACROBAT",
                                      add_stain_encoding=stain_encoding), **cfg_fields))
    model = MADELEINE(cfg.finalize())
    sd = flagship_state_dict(stain_encoding=stain_encoding)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model

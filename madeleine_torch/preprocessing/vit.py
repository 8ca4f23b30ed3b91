"""ViT image tower, the tile encoder's compute core (JAX:
madeleine_tpu/preprocessing/vit.py).

The reference embeds tiles with CONCH's ViT-B/16 (ref:
conch_patch_embedder.py:93-125). `VisionTransformer` is an open_clip-style
vision transformer whose parameters carry open_clip's ``visual.*`` names,
so such a checkpoint loads strictly (`load_torch_vision_tower`):

- patch embedding as unfold + matmul over NHWC images with ``conv1``'s
  weight (the JAX package's layout), class token and learned positions,
  ``ln_pre``; pre-norm blocks with packed-qkv multi-head attention (the
  softmax in float32 at any operand type) and an exact-erf GELU MLP;
  ``ln_post`` on the class token, then the optional projection ``proj``;
  LayerNorm eps 1e-5;
- `vit_params_from_jax` carries the JAX package's parameter tree across;
- `TorchViTEncoder` takes uint8 tiles, resizes them on the device with
  half-pixel bilinear interpolation (no antialias) rounded back to uint8,
  as cv2.INTER_LINEAR on uint8 does, CLIP-normalises them and runs the
  tower, in float32 (no TF32) unless another dtype is asked for.

The JAX package computes this tower in XLA, with no Pallas kernel; so the
products and the softmax here are PyTorch's own calls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from madeleine_torch.utils.device import resolve_device

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    out_dim: Optional[int] = 512      # projection dim (None = raw width)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1


class Attention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj, out_proj) and
    semantics, the softmax in float32."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, w = x.shape
        hd = w // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (a.reshape(n, s, self.heads, hd).transpose(1, 2) for a in qkv.chunk(3, -1))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(n, s, w)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float):
        super().__init__()
        mlp = int(width * mlp_ratio)
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, mlp))
        self.mlp.add_module("gelu", nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(mlp, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(cfg.width, cfg.heads,
                                                               cfg.mlp_ratio)
                                        for _ in range(cfg.layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class VisionTransformer(nn.Module):
    """open_clip's VisionTransformer parameter names (``conv1``,
    ``class_embedding``, ``positional_embedding``, ``ln_pre``,
    ``transformer.resblocks.{i}``, ``ln_post``, ``proj``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, w, p, p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, w))
        self.ln_pre = nn.LayerNorm(w, eps=LN_EPS)
        self.transformer = Transformer(cfg)
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS)
        self.proj = nn.Parameter(torch.empty(w, cfg.out_dim)) if cfg.out_dim else None

    def forward(self, images: torch.Tensor, project: bool = True) -> torch.Tensor:
        """images [n, H, W, 3], CLIP-normalised -> [n, out_dim] (the class
        token; projected when `project` and ``proj`` exists)."""
        n, h, _, _ = images.shape
        p = self.cfg.patch_size
        g = h // p
        x = images.reshape(n, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, p * p * 3)
        w_patch = self.conv1.weight.permute(0, 2, 3, 1).reshape(self.cfg.width, p * p * 3)
        x = F.linear(x, w_patch)
        cls = self.class_embedding.expand(n, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        pooled = self.ln_post(x[:, 0])
        if project and self.proj is not None:
            pooled = pooled @ self.proj
        return pooled


@torch.no_grad()
def init_vit(model: VisionTransformer, generator: torch.Generator) -> VisionTransformer:
    """Random weights in the JAX package's regime (init_vit_params): the
    patch embedding, class token, positions and projection N(0, 1/width),
    each dense weight N(0, 1/fan_in) with zero bias, LayerNorms 1 and 0."""
    scale = model.cfg.width ** -0.5

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    for name, t in model.named_parameters():
        if name.endswith(("ln_1.weight", "ln_2.weight")) or name.startswith(
                ("ln_pre.weight", "ln_post.weight")):
            t.fill_(1.0)
        elif name.endswith("bias"):
            t.zero_()
        elif name in ("conv1.weight", "class_embedding", "positional_embedding", "proj"):
            normal(t, scale)
        else:   # [out, in] dense weights
            normal(t, t.shape[1] ** -0.5)
    return model


def vit_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ViT parameter tree (numpy leaves) -> this module's
    state dict."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def ln(dst, src):
        return {f"{dst}.weight": t(src["scale"]), f"{dst}.bias": t(src["bias"])}

    patch = np.asarray(params["patch_embed"]["w"])          # [p*p*3, w], channel minor
    w = patch.shape[1]
    p = int(round((patch.shape[0] // 3) ** 0.5))
    sd = {"conv1.weight": t(patch.T.reshape(w, p, p, 3).transpose(0, 3, 1, 2)),
          "class_embedding": t(params["cls"]), "positional_embedding": t(params["pos"]),
          **ln("ln_pre", params["ln_pre"]), **ln("ln_post", params["ln_post"])}
    for i, b in enumerate(params["blocks"]):
        base = f"transformer.resblocks.{i}."
        sd.update(ln(base + "ln_1", b["ln1"]))
        sd.update(ln(base + "ln_2", b["ln2"]))
        sd.update({base + "attn.in_proj_weight": t(np.asarray(b["qkv"]["w"]).T),
                   base + "attn.in_proj_bias": t(b["qkv"]["b"]),
                   base + "attn.out_proj.weight": t(np.asarray(b["out"]["w"]).T),
                   base + "attn.out_proj.bias": t(b["out"]["b"]),
                   base + "mlp.c_fc.weight": t(np.asarray(b["fc1"]["w"]).T),
                   base + "mlp.c_fc.bias": t(b["fc1"]["b"]),
                   base + "mlp.c_proj.weight": t(np.asarray(b["fc2"]["w"]).T),
                   base + "mlp.c_proj.bias": t(b["fc2"]["b"])})
    if "proj" in params:
        sd["proj"] = t(params["proj"])
    return sd


def vit_from_torch_state_dict(sd: Mapping[str, Any], prefix: str = "visual.",
                              heads: Optional[int] = None
                              ) -> Tuple[ViTConfig, VisionTransformer]:
    """open_clip VisionTransformer state dict -> (ViTConfig, module), every
    ``<prefix>*`` key loaded strictly. The state dict does not record the
    head count: open_clip's convention, heads = width // 64, unless given."""
    sub = {k[len(prefix):]: torch.as_tensor(np.asarray(v, np.float32)) if not
           isinstance(v, torch.Tensor) else v.detach().float()
           for k, v in sd.items() if k.startswith(prefix)}
    if "conv1.weight" not in sub:
        raise KeyError(f"missing {prefix}conv1.weight")
    w, _, p, _ = sub["conv1.weight"].shape
    grid = int(round((sub["positional_embedding"].shape[0] - 1) ** 0.5))
    n_layers = 0
    while f"transformer.resblocks.{n_layers}.ln_1.weight" in sub:
        n_layers += 1
    proj = sub.get("proj")
    cfg = ViTConfig(image_size=grid * p, patch_size=p, width=w, layers=n_layers,
                    heads=w // 64 if heads is None else heads,
                    out_dim=None if proj is None else proj.shape[1])
    model = VisionTransformer(cfg)
    model.load_state_dict(sub, strict=True)
    return cfg, model.eval()


def load_torch_vision_tower(checkpoint_path: str, prefix: str = "visual.",
                            heads: Optional[int] = None
                            ) -> Tuple[ViTConfig, VisionTransformer]:
    """torch .pt/.bin checkpoint (a state dict, or a module) -> (ViTConfig,
    module) on the CPU."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return vit_from_torch_state_dict(sd, prefix=prefix, heads=heads)


def resize_uint8(tiles: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [n, h, w, 3] -> uint8 [n, size, size, 3]: bilinear with
    half-pixel centres and no antialias, rounded to the nearest level
    (cv2.resize(..., INTER_LINEAR) on uint8, which rounds fixed-point
    weights, lies within one level of it)."""
    x = tiles.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=False)
    return x.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


class TorchViTEncoder:
    """Tile-encoder protocol (JAX: JaxViTEncoder): uint8 tiles [n, s, s, 3]
    (numpy, or a tensor) -> features [n, dim] float32 (numpy, or a tensor
    on the device). The tiles go to `device` (default CUDA),
    are resized there to the tower's image size, CLIP-normalised and
    encoded in `dtype` (default float32)."""

    def __init__(self, cfg: ViTConfig, model: VisionTransformer,
                 dtype: Optional[torch.dtype] = None, project: bool = True, device=None):
        self.cfg, self.project = cfg, project
        self.device = resolve_device(device)
        self.dtype = dtype or torch.float32
        self.dim = (cfg.out_dim if project else None) or cfg.width
        self.model = model.to(self.device, self.dtype).eval()
        self.mean = torch.as_tensor(CLIP_MEAN, device=self.device)
        self.std = torch.as_tensor(CLIP_STD, device=self.device)

    def preprocess(self, tiles: torch.Tensor) -> torch.Tensor:
        """uint8 [n, h, w, 3] on the device -> the tower's input."""
        s = self.cfg.image_size
        if tiles.shape[1] != s or tiles.shape[2] != s:
            tiles = resize_uint8(tiles, s)
        x = (tiles.float() / 255.0 - self.mean) / self.std
        return x.to(self.dtype)

    @torch.no_grad()
    def encode(self, tiles: torch.Tensor) -> torch.Tensor:
        """uint8 tiles [n, s, s, 3] -> float32 features [n, dim] on the device."""
        return self.model(self.preprocess(tiles.to(self.device)), project=self.project).float()

    def __call__(self, tiles):
        """numpy tiles -> numpy features; a tensor (the tile embedder's, on
        the device already) -> a float32 tensor on the device."""
        if isinstance(tiles, torch.Tensor):
            return self.encode(tiles)
        return self.encode(torch.from_numpy(np.ascontiguousarray(tiles, np.uint8))).cpu().numpy()

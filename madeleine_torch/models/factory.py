"""Checkpoint I/O and model factory.

The port's parameters already carry the reference's names and layout
(ref: factory.py:16-39, Model.py:28-41), so a reference ``model.pt`` loads with
``load_state_dict(strict=True)`` and saves back unchanged. `params_from_jax`
carries a parameter pytree of the JAX package (nested dicts of numpy arrays,
head-major, [in, out] matrices) across into that layout; it is the port's own
copy of `madeleine_tpu/models/factory.py::params_to_state_dict`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from madeleine_torch.config import MadeleineConfig, compute_dtype
from madeleine_torch.models.abmil import _head_major_perm
from madeleine_torch.models.madeleine import MADELEINE, init_madeleine
from madeleine_torch.utils.device import resolve_device

_PRE_ATTN_LAYERS = {"fc1": "0", "ln1": "1", "fc2": "4", "ln2": "5", "fc3": "8", "ln3": "9"}


def _strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop a leading ``module.`` (nn.DataParallel artifact, ref: Model.py:31-40)."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``model.pt`` (a state dict or a pickled module) into f32 CPU tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return _strip_module_prefix({k: v.detach().to(torch.float32) for k, v in sd.items()})


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (numpy leaves, head-major) -> reference-named
    state dict of f32 tensors, with the head-major permutation inverted."""
    sd: Dict[str, np.ndarray] = {}
    pre = params["wsi_embedders"]["pre_attn"]
    attn = params["wsi_embedders"]["attn"]
    n_heads = np.asarray(attn["wa"]).shape[0]
    hidden = np.asarray(pre["fc3"]["w"]).shape[1] // n_heads
    perm = _head_major_perm(hidden, n_heads)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    for ours, idx in _PRE_ATTN_LAYERS.items():
        p = {k: np.asarray(v) for k, v in pre[ours].items()}
        key = f"wsi_embedders.pre_attn.{idx}"
        if ours == "fc3":
            sd[f"{key}.weight"], sd[f"{key}.bias"] = p["w"][:, inv].T, p["b"][inv]
        elif ours == "ln3":
            sd[f"{key}.weight"], sd[f"{key}.bias"] = p["scale"][inv], p["bias"][inv]
        elif ours.startswith("fc"):
            sd[f"{key}.weight"], sd[f"{key}.bias"] = p["w"].T, p["b"]
        else:
            sd[f"{key}.weight"], sd[f"{key}.bias"] = p["scale"], p["bias"]
    for h in range(n_heads):
        key = f"wsi_embedders.attn.{h}"
        for branch, (w, b) in (("attention_a.0", ("wa", "ba")),
                               ("attention_b.0", ("wb", "bb")),
                               ("attention_c", ("wc", "bc"))):
            sd[f"{key}.{branch}.weight"] = np.asarray(attn[w])[h].T
            sd[f"{key}.{branch}.bias"] = np.asarray(attn[b])[h]
    for name in ("token_projector", "projector"):
        sd[f"{name}.weight"] = np.asarray(params[name]["w"])[inv, :].T
        sd[f"{name}.bias"] = np.asarray(params[name]["b"])
    if "embedding" in params:
        sd["embedding.weight"] = np.asarray(params["embedding"]["table"])
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}


def export_torch_checkpoint(model: MADELEINE, path: str) -> None:
    """Save the state dict as a reference-loadable ``model.pt`` (f32, CPU)."""
    torch.save({k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()},
               path)


def _as_config(model_cfg: Union[MadeleineConfig, Mapping, Any]) -> MadeleineConfig:
    if isinstance(model_cfg, MadeleineConfig):
        cfg = model_cfg
    elif isinstance(model_cfg, Mapping):
        cfg = MadeleineConfig.from_dict(dict(model_cfg))
    else:  # argparse / SimpleNamespace
        cfg = MadeleineConfig.from_dict(vars(model_cfg))
    if not cfg.STAINS:
        cfg.finalize()
    return cfg


def create_model(model_cfg, checkpoint_path: Optional[str] = None, seed: int = 0,
                 device=None) -> Tuple[MadeleineConfig, MADELEINE]:
    """Build the model on `device` (default CUDA), from a torch ``.pt``/``.pth``/
    ``.bin`` or ``.npz`` state dict when given, else with fresh weights from
    `seed` (ref: Model.py:15-43). Returns (cfg, model), the model in eval mode."""
    dev = resolve_device(device)
    cfg = _as_config(model_cfg)
    model = MADELEINE(cfg)
    if checkpoint_path:
        if checkpoint_path.endswith((".pt", ".pth", ".bin")):
            sd = load_torch_state_dict(checkpoint_path)
        elif checkpoint_path.endswith(".npz"):
            with np.load(checkpoint_path) as data:
                sd = _strip_module_prefix({k: torch.from_numpy(data[k].astype(np.float32))
                                           for k in data.files})
        else:
            raise NotImplementedError(
                f"checkpoint {checkpoint_path}: only torch .pt/.pth/.bin and .npz "
                "state dicts load in the port (orbax restore is not ported)")
        model.load_state_dict(sd, strict=True)
    else:
        init_madeleine(model, torch.Generator().manual_seed(seed))
    return cfg, model.to(dev).eval()


def create_model_from_pretrained(local_dir: str, repo_id: str = "MahmoodLab/madeleine",
                                 download: bool = True, device=None
                                 ) -> Tuple[MadeleineConfig, MADELEINE, torch.dtype]:
    """Read ``model_config.json`` + ``model.pt`` from local_dir, first trying
    the HF hub when asked and the files are missing (ref: factory.py:16-39).
    Returns (cfg, model, compute dtype)."""
    os.makedirs(local_dir, exist_ok=True)
    cfg_path = os.path.join(local_dir, "model_config.json")
    ckpt_path = os.path.join(local_dir, "model.pt")
    if download and not (os.path.exists(cfg_path) and os.path.exists(ckpt_path)):
        try:
            from huggingface_hub import snapshot_download
            snapshot_download(repo_id=repo_id, local_dir=local_dir)
        except Exception as e:  # offline or not installed: use local files
            print(f"* snapshot_download unavailable ({type(e).__name__}); "
                  f"using local files in {local_dir}")
    with open(cfg_path) as f:
        model_cfg = json.load(f)
    cfg, model = create_model(model_cfg, checkpoint_path=ckpt_path, device=device)
    return cfg, model, compute_dtype(cfg.precision)

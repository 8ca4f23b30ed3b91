"""Checkpoints: the full train state with crash-safe saves and exact resume,
and the reference-loadable ``model.pt``.

Port of `madeleine_tpu/train/checkpoint.py` with `torch.save` in place of
orbax. The reference saves only a bare state dict when the rank improves and
cannot resume (ref: bin/pretrain.py:69-72). Here:

- `save_train_state(directory, state, metadata)`: ``state`` (the model's f32
  parameters, the AdamW state, the count of applied updates) goes to
  ``<directory>/state.pt``, written whole into ``<directory>.tmp`` before any
  rename; the previous checkpoint moves to ``<directory>.old`` and is removed
  only after the swap, so a crash at any point leaves an intact checkpoint at
  ``<directory>`` or ``<directory>.old``. ``metadata`` (epoch, best rank) goes
  to ``<directory>.meta.json``.
- `restore_train_state` falls back to ``<directory>.old`` when the primary
  does not load.
- `save_best_torch`: ``model.pt`` plus ``model_config.json``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from madeleine_torch.models.factory import export_torch_checkpoint

STATE_FILE = "state.pt"


def save_train_state(directory: str, state: Dict[str, Any],
                     metadata: Optional[Dict[str, Any]] = None) -> None:
    directory = os.path.abspath(directory)
    tmp, old = directory + ".tmp", directory + ".old"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))   # complete new checkpoint, off to the side
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(directory):
        os.rename(directory, old)                      # the previous one stays restorable
    os.rename(tmp, directory)                          # atomic swap-in (same filesystem)
    if metadata is not None:
        meta_tmp = directory + ".meta.json.tmp"
        with open(meta_tmp, "w") as f:
            json.dump(metadata, f, indent=2)
        os.replace(meta_tmp, directory + ".meta.json")
    if os.path.exists(old):
        shutil.rmtree(old)


def restore_train_state(directory: str) -> Dict[str, Any]:
    """The saved state, its tensors on the CPU; from ``<directory>.old``
    when the primary is missing or does not load (a crash mid-save)."""
    directory = os.path.abspath(directory)

    def _load(path):
        return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                          weights_only=False)

    try:
        return _load(directory)
    except Exception:
        old = directory + ".old"
        if os.path.isdir(old):
            return _load(old)
        raise


def load_metadata(directory: str) -> Optional[Dict[str, Any]]:
    path = os.path.abspath(directory) + ".meta.json"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_best_torch(results_dir: str, model: torch.nn.Module, cfg=None) -> str:
    """Write a reference-loadable ``model.pt`` (+ ``model_config.json`` when
    cfg is given) into the results dir (ref: bin/pretrain.py:72,
    factory.py:23-28)."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, "model.pt")
    export_torch_checkpoint(model, path)
    if cfg is not None:
        with open(os.path.join(results_dir, "model_config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=4)
    return path

"""Pickle helpers and the model summary (ref: utils/file_utils.py:4-38).

The embeddings pkl schema ``{"embeds": np.ndarray, "slide_ids": list}`` is
what downstream linear probing reads (ref: bin/run_linear_probing.py:71-81).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import torch


def save_pkl(filename: str, save_object: Any) -> None:
    with open(filename, "wb") as f:
        pickle.dump(save_object, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_pkl(filename: str) -> Any:
    with open(filename, "rb") as f:
        return pickle.load(f)


def print_network(model: torch.nn.Module, cfg: Any = None,
                  results_dir: Optional[str] = None) -> str:
    """A model summary, one line per parameter and the counts; written to
    ``<results_dir>/model_config.txt`` after the config when given (ref:
    file_utils.py:17-38)."""
    lines = [f"{name}: shape={tuple(p.shape)} dtype={p.dtype}"
             for name, p in model.named_parameters()]
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    lines += [f"Total number of parameters: {total}",
              f"Total number of trainable parameters: {trainable}"]
    text = "\n".join(lines)
    if results_dir is not None:
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "model_config.txt"), "w") as f:
            if cfg is not None:
                f.write(str(cfg) + "\n\n")
            f.write(text + "\n")
    return text

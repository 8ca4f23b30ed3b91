"""Pickle helpers (ref: utils/file_utils.py:4-15).

The embeddings pkl schema ``{"embeds": np.ndarray, "slide_ids": list}`` is
what downstream linear probing reads (ref: bin/run_linear_probing.py:71-81).
"""

from __future__ import annotations

import pickle
from typing import Any


def save_pkl(filename: str, save_object: Any) -> None:
    with open(filename, "wb") as f:
        pickle.dump(save_object, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_pkl(filename: str) -> Any:
    with open(filename, "rb") as f:
        return pickle.load(f)

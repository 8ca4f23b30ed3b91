"""Slide-embedding extraction (ref: madeleine/utils/utils.py:27-90).

Bags stream through `BucketedBagLoader` as padded, masked batches. On the
GPU the loader thread pins each batch, the copy to the device is
asynchronous, and embeddings stay on the device until the stream ends.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from madeleine_torch.config import compute_dtype
from madeleine_torch.data.datasets import BucketedBagLoader, Prefetcher
from madeleine_torch.models.madeleine import MADELEINE, encode
from madeleine_torch.ops.rank import smooth_rank_measure
from madeleine_torch.utils.device import resolve_device
from madeleine_torch.utils.file_utils import save_pkl


def _pinned(batch: Dict) -> Dict:
    batch["feats"] = torch.from_numpy(batch["feats"]).pin_memory()
    batch["mask"] = torch.from_numpy(batch["mask"]).pin_memory()
    return batch


def run_inference(model: MADELEINE, loader, *, stain_idx: int = 0,
                  dtype: Optional[torch.dtype] = None, device=None,
                  verbose: bool = True) -> Tuple[Dict, float]:
    """Encode every bag the loader yields -> ({"embeds", "slide_ids"}, rank)
    (ref: utils.py:27-66). `device` defaults to CUDA; the model moves there.
    `dtype` defaults to the config's precision."""
    dev = resolve_device(device)
    model.to(dev)
    dtype = dtype or compute_dtype(model.cfg.precision)
    source = map(_pinned, loader) if dev.type == "cuda" else loader
    pending, all_ids = [], []
    n_done, t0 = 0, time.time()
    for batch in Prefetcher(source):
        feats = torch.as_tensor(batch["feats"]).to(dev, non_blocking=True).to(dtype)
        mask = torch.as_tensor(batch["mask"]).to(dev, non_blocking=True)
        n_valid = batch.get("n_valid", len(batch["slide_ids"]))
        emb = encode(model, feats, stain_idx=stain_idx, mask=mask)
        pending.append(emb[:n_valid])
        all_ids.extend(batch["slide_ids"])
        n_done += n_valid
    embeds = (torch.cat(pending).float().cpu().numpy() if pending
              else np.zeros((0, model.cfg.embed_dim), np.float32))
    elapsed = time.time() - t0
    rank = float(smooth_rank_measure(torch.from_numpy(embeds))) if len(embeds) > 1 else 0.0
    if verbose:
        print(f"* Encoded {n_done} slides in {elapsed:.2f}s "
              f"({n_done / max(elapsed, 1e-9):.1f} slides/sec), rank={rank:.2f}")
    return {"embeds": embeds, "slide_ids": all_ids}, rank


def get_downstream_loader(path: str, buckets=None,
                          tokens_per_batch: int = 262144) -> BucketedBagLoader:
    """Loader over ``<path>/patch_embeddings`` bags, or ``path`` itself
    (ref: bin/extract_slide_embeddings.py:21-29)."""
    feat_dir = os.path.join(path, "patch_embeddings")
    if not os.path.isdir(feat_dir):
        feat_dir = path
    kwargs = {} if buckets is None else {"buckets": buckets}
    return BucketedBagLoader(feat_dir, tokens_per_batch=tokens_per_batch, **kwargs)


def extract_slide_level_embeddings(model: MADELEINE, val_loaders: Dict[str, BucketedBagLoader],
                                   save_dir: Optional[str] = None, device=None) -> Dict[str, Dict]:
    """Each named loader -> its results dict, saved as ``{name}.pkl``
    (ref: utils.py:68-90)."""
    results = {}
    for name, loader in val_loaders.items():
        print(f"\n* Extracting slide-level embeddings of {name}")
        res, rank = run_inference(model, loader, device=device)
        print(f"Rank for {name} = {rank}")
        results[name] = res
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            save_pkl(os.path.join(save_dir, f"{name}.pkl"), res)
    return results

"""Configuration for the PyTorch port.

Own copy of `madeleine_tpu.config` (the port imports nothing of the JAX
package): the reference's ``model_config.json`` schema (ref: Model.py:50-94,
process_args.py:6-95) as a typed dataclass. Unknown keys are ignored, so
configs written by the reference or by the JAX package load unchanged.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional

import torch

# HE is always the first modality (ref: Model.py:13, HE_POSITION = 0).
HE_POSITION = 0

# Dataset -> ordered stain list (ref: datasets/modalities.py:1-3).
MODALITY_DICTS: Dict[str, List[str]] = {
    "ACROBAT": ["HE", "HER2", "PGR", "KI67", "ER"],
}


@dataclasses.dataclass
class MadeleineConfig:
    # ---- model (fields read in ref Model.py:50-94) ----
    wsi_encoder: str = "abmil"
    patch_embedding_dim: int = 512
    wsi_encoder_hidden_dim: int = 512
    activation: str = "softmax"          # softmax | relu | leaky_relu | sigmoid
    n_heads: int = 4
    add_stain_encoding: bool = False
    stain_encoding_dim: int = 32         # ref: Model.py:54 (hardcoded 32)
    attention_hidden_dim: int = 512      # ref: Model.py:71 (hardcoded 512)
    token_proj_dim: int = 128            # ref: Model.py:80-83 (hardcoded 128)
    precision: str = "bfloat16"          # float64 | float32 | bfloat16

    # ---- data ----
    dataset: str = "ACROBAT"
    cohort: str = "brca"
    csv_fpath: Optional[str] = None
    data_root_dir: Optional[str] = None
    n_subsamples: int = 2048
    MODALITIES: List[str] = dataclasses.field(
        default_factory=lambda: list(MODALITY_DICTS["ACROBAT"]))

    # ---- training (ref: process_args.py:24-40) ----
    max_epochs: int = 120
    lr: float = 1e-4
    end_learning_rate: float = 1e-8
    batch_size: int = 65
    temperature: float = 0.001
    warmup: bool = True
    warmup_epochs: int = 5
    weight_decay: float = 0.01
    seed: int = 42
    num_workers: int = 0

    # ---- losses (ref: process_args.py:50-54) ----
    symmetric_cl: bool = True
    global_loss: str = "info-nce"
    local_loss: str = "got"
    intra_modality_loss: str = "-1"
    intra_modality_mode_wsi: str = "contrast"
    local_loss_weight: float = 1.0
    got_subsample: int = 256

    # ---- run management ----
    results_dir: str = "results"
    log_ml: bool = False
    pretrained: Optional[str] = None
    bucket_sizes: Optional[List[int]] = None  # inference length buckets

    # ---- train route and run (the JAX package's extensions) ----
    modality_scan: bool = True   # one encoder call per modality; False: one joint call
    remat: bool = True           # per-op lane: each modality's body recomputed in its backward
    mesh_shape: Optional[int] = None   # data-parallel devices: the world size
    checkpoint_every: int = 0    # extra train-state checkpoints every N epochs (0: gated only)
    profile_dir: Optional[str] = None  # torch.profiler chrome trace of the epochs

    # Derived (filled by finalize()).
    STAINS: List[str] = dataclasses.field(default_factory=list)
    EXP_CODE: str = ""
    exp_hash: str = ""
    RESULTS_SAVE_PATH: str = ""

    def finalize(self) -> "MadeleineConfig":
        """Derive the stain list, experiment code and results dir
        (ref: setup_components.py:106-117, process_args.py:68-85). An explicit
        MODALITIES list (e.g. from a checkpoint's model_config.json) wins over
        the dataset registry."""
        if not getattr(self, "_explicit_modalities", False) \
                and self.dataset in MODALITY_DICTS:
            self.MODALITIES = list(MODALITY_DICTS[self.dataset])
        self.STAINS = [m for i, m in enumerate(self.MODALITIES) if i != HE_POSITION]
        self.EXP_CODE = (
            f"Cohort:{self.cohort}_SlideEnc:{self.wsi_encoder}_nHeads:{self.n_heads}"
            f"_GlobalLoss:{self.global_loss}_LocalLoss:{self.local_loss}"
            f"_AddSE:{self.add_stain_encoding}_LR:{self.lr}_Epochs:{self.max_epochs}"
            f"_Batch:{self.batch_size}_nTokens:{self.n_subsamples}"
            f"_Temp:{self.temperature}_Precision:{self.precision}"
        )
        payload = {k: str(v) for k, v in dataclasses.asdict(self).items()
                   if k not in ("exp_hash", "RESULTS_SAVE_PATH", "EXP_CODE", "STAINS")}
        self.exp_hash = hashlib.md5(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()
        if not self.RESULTS_SAVE_PATH:
            self.RESULTS_SAVE_PATH = os.path.join(self.results_dir, self.exp_hash)
        return self

    @property
    def n_modalities(self) -> int:
        return len(self.MODALITIES)

    @property
    def input_dim(self) -> int:
        dim = self.patch_embedding_dim
        if self.add_stain_encoding:
            dim += self.stain_encoding_dim
        return dim

    @property
    def embed_dim(self) -> int:
        """Slide-embedding width: the projector's output, Linear(hidden * n_heads
        -> hidden) (ref: Model.py:87-94)."""
        return self.wsi_encoder_hidden_dim

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MadeleineConfig":
        """Build from a dict; extra keys are ignored, known aliases mapped."""
        field_names = {f.name for f in dataclasses.fields(cls)}
        aliases = {"RESULS_SAVE_PATH": "RESULTS_SAVE_PATH"}  # ref typo (process_args.py:85)
        kwargs: Dict[str, Any] = {}
        for k, v in d.items():
            k = aliases.get(k, k)
            if k in field_names and v is not None:
                kwargs[k] = v
        cfg = cls(**kwargs)
        if "MODALITIES" in kwargs:
            cfg._explicit_modalities = True
        if not cfg.STAINS:
            cfg.finalize()
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "MadeleineConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)


def config_cache_key(cfg: MadeleineConfig) -> str:
    """Canonical content key of a config: equal fields give equal keys."""
    return json.dumps(cfg.to_dict(), sort_keys=True, default=str)


def compute_dtype(precision: str) -> torch.dtype:
    """Precision string -> torch dtype (ref: utils/utils.py:124-144).
    float64 runs as float32, as in the JAX package."""
    if precision in ("float64", "float32"):
        return torch.float32
    if precision == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"Invalid precision: {precision}")

"""Component setup family (JAX: madeleine_tpu/setup.py; ref:
madeleine/utils/setup_components.py:86-247).

The reference's ``setup_*`` entry points on the port's objects, and the one
place that builds them: `cli/pretrain.py` makes its results dir, its Python
loader's dataset and train loader (the ragged one under ``--n_subsamples
-1``), its model and its AdamW through these functions, and
`train/trainer.py::compute_losses` takes its losses from `setup_losses`.
`setup` parses the pretrain CLI's flags itself; the downstream loaders and
the data-parallel mesh complete the family.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Tuple

from madeleine_torch.config import MadeleineConfig
from madeleine_torch.data.datasets import (BucketedBagLoader, RaggedTrainLoader, SlideDataset,
                                           TrainLoader)


def setup(argv=None) -> MadeleineConfig:
    """Parse the pretrain CLI's flags (without --device), derive the
    modalities, EXP_CODE and results dir, and write ``config.json`` there
    (ref: setup_components.py:86-125)."""
    from madeleine_torch.parallel.multihost import process_info
    from madeleine_torch.utils.args import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(argv), process_info()[1])
    setup_results_dir(cfg)
    return cfg


def setup_results_dir(cfg: MadeleineConfig) -> str:
    """Make the results dir and write ``config.json`` there; returns the dir."""
    os.makedirs(cfg.RESULTS_SAVE_PATH, exist_ok=True)
    cfg.save(os.path.join(cfg.RESULTS_SAVE_PATH, "config.json"))
    return cfg.RESULTS_SAVE_PATH


def setup_dataset(cfg: MadeleineConfig, process_count: int = 1) -> SlideDataset:
    """The training cases (ref: setup_components.py:128-140); each case's
    subsample drawn per case under several processes, as the CLI does."""
    return SlideDataset(cfg.dataset, cfg.csv_fpath, cfg.data_root_dir, cfg.MODALITIES,
                        embedding_size=cfg.patch_embedding_dim, sample=cfg.n_subsamples,
                        per_case_seed=process_count > 1, seed=cfg.seed)


def setup_dataloader(cfg: MadeleineConfig, dataset: SlideDataset, process_index: int = 0,
                     process_count: int = 1):
    """The shuffling train loader (ref: setup_components.py:142-152): full
    bags in length buckets under ``--n_subsamples -1``, else subsampled."""
    procs = dict(process_index=process_index, process_count=process_count)
    if cfg.n_subsamples == -1:
        return RaggedTrainLoader(dataset, cfg.batch_size, seed=cfg.seed, **procs)
    return TrainLoader(dataset, cfg.batch_size, seed=cfg.seed, **procs)


def setup_downstream_datasets(cfg: MadeleineConfig,
                              datasets: Optional[Dict[str, str]] = None
                              ) -> Dict[str, BucketedBagLoader]:
    """Downstream loaders keyed by name, over each dir's
    ``patch_embeddings/`` or the dir itself (ref: setup_components.py:34-58,
    154-173 hardcodes BCNB; pass {"BCNB": "<dir>"} here)."""
    from madeleine_torch.eval.inference import get_downstream_loader

    return {name: get_downstream_loader(path) for name, path in (datasets or {}).items()}


def setup_model(cfg: MadeleineConfig, seed: Optional[int] = None, device=None):
    """A MADELEINE with fresh weights from `seed` (default cfg.seed) on
    `device` (default CUDA), in eval mode (ref: setup_components.py:175-192;
    setup_mesh replaces nn.DataParallel)."""
    from madeleine_torch.models.factory import create_model

    return create_model(cfg, seed=cfg.seed if seed is None else seed, device=device)[1]


def setup_mesh(cfg: MadeleineConfig):
    """The data-parallel mesh over the process group when it holds more
    than one process, else None (the DataParallel equivalent, ref:
    setup_components.py:185-187)."""
    from madeleine_torch.parallel.mesh import make_mesh
    from madeleine_torch.parallel.multihost import process_info

    world = process_info()[1]
    return make_mesh((world,)) if world > 1 else None


def setup_optim(cfg: MadeleineConfig, model, steps_per_epoch: int):
    """AdamW + warmup/cosine schedule over the model's parameters
    (ref: setup_components.py:194-209). Returns (optimizer, schedule)."""
    from madeleine_torch.train.optim import make_optimizer

    return make_optimizer(cfg, model.parameters(), steps_per_epoch)


def setup_losses(cfg: MadeleineConfig) -> Tuple:
    """(global_fn, local_fn, intra_fn) as the train step calls them, None
    where disabled (ref: setup_components.py:211-247): InfoNCE at the
    config's temperature and symmetry, GOT over all stain pairs in one call
    (`got_loss_multi`), the intra-modality loss of `intra_modality_mode_wsi`."""
    from madeleine_torch.ops import losses as L

    loss_global = (functools.partial(L.info_nce, temperature=cfg.temperature,
                                     symmetric=cfg.symmetric_cl)
                   if cfg.global_loss == "info-nce" else None)
    loss_local = L.got_loss_multi if cfg.local_loss == "got" else None
    loss_intra = (L.make_intra_loss(cfg.intra_modality_mode_wsi, cfg.temperature)
                  if cfg.intra_modality_loss == "info-nce" else None)
    return loss_global, loss_local, loss_intra

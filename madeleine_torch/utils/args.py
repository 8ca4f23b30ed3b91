"""The command-line surface of pretraining (ref: madeleine/utils/process_args.py:6-95).

The port's own copy of `madeleine_tpu/utils/args.py`: the same flag names and
defaults, so the launch scripts run unchanged, mapped onto MadeleineConfig.
Flags that the reference parses and never uses (--early_stopping,
--scheduler, --opt, --num_workers) are accepted; --seed and --weight_decay
are honoured. The CLI adds --device.
"""

from __future__ import annotations

import argparse

from madeleine_torch.config import MadeleineConfig

EXTRAS = ("resume", "downstream_dir", "num_gpus", "early_stopping", "opt", "scheduler",
          "wandb_project_name", "wandb_entity", "native_loader")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Configurations for MADELEINE pretraining")
    # ----> set up
    p.add_argument("--data_root_dir", type=str, default=None)
    p.add_argument("--dataset", type=str, default="ACROBAT")
    p.add_argument("--csv_fpath", type=str, default=None)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--cohort", type=str, default="brca")
    # ----> training
    p.add_argument("--patch_embedding_dim", type=int, default=512)
    p.add_argument("--max_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--early_stopping", action="store_true", default=False)
    p.add_argument("--opt", type=str, default="adamW")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_subsamples", type=int, default=-1)
    p.add_argument("--scheduler", type=str, default=None)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--temperature", type=float, default=0.001)
    p.add_argument("--warmup", action="store_true", default=False)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--end_learning_rate", type=float, default=1e-8)
    p.add_argument("--num_gpus", type=int, default=1, help="accepted; one device is used")
    p.add_argument("--precision", type=str, default="bfloat16")
    # ----> model
    p.add_argument("--wsi_encoder", type=str, default="abmil")
    p.add_argument("--activation", type=str, default="softmax")
    p.add_argument("--wsi_encoder_hidden_dim", type=int, default=512)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--add_stain_encoding", action="store_true", default=False)
    # ----> losses
    p.add_argument("--symmetric_cl", action="store_true", default=False)
    p.add_argument("--global_loss", type=str, default="-1")
    p.add_argument("--local_loss", type=str, default="-1")
    p.add_argument("--intra_modality_loss", type=str, default="-1")
    p.add_argument("--local_loss_weight", type=float, default=1.0)
    # ----> logging
    p.add_argument("--log_ml", action="store_true")
    p.add_argument("--wandb_project_name", type=str, default="MADELEINE")
    p.add_argument("--wandb_entity", type=str, default="madeleine")
    # ----> inference / resume
    p.add_argument("--pretrained", type=str, default=None)
    # ----> the JAX package's extensions
    p.add_argument("--mesh_shape", type=int, default=None,
                   help="data-parallel device count; only 1 is ported (ROADMAP.md A7)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler chrome trace of the epochs here")
    p.add_argument("--no_remat", dest="remat", action="store_false",
                   help="accepted and recorded; the train kernels always save K6's rows")
    p.add_argument("--no_modality_scan", dest="modality_scan", action="store_false",
                   help="one joint [bs*n_mod] encoder call instead of one per modality")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None, help="train-state dir to resume from")
    p.add_argument("--downstream_dir", type=str, default=None,
                   help="dir of bag files for post-train slide extraction")
    p.add_argument("--native_loader", type=str, default="auto", choices=["auto", "on", "off"],
                   help="'on' (the JAX package's native .bag assembler) is not ported "
                        "(ROADMAP.md A5); auto and off read bags in Python")
    return p


def config_from_args(args: argparse.Namespace) -> MadeleineConfig:
    """The parsed flags as a finalized config; the flags that are not config
    fields ride along in ``cfg._extras``. Raises NotImplementedError, naming
    the ROADMAP item, for what the port does not run."""
    d = vars(args).copy()
    if d["mesh_shape"] is not None and d["mesh_shape"] > 1:
        raise NotImplementedError(f"--mesh_shape {d['mesh_shape']}: data parallelism is not "
                                  "ported (ROADMAP.md A7)")
    if d["native_loader"] == "on":
        raise NotImplementedError("--native_loader on: the native .bag batch assembler is not "
                                  "ported (ROADMAP.md A5)")
    if d["n_subsamples"] == -1:
        raise NotImplementedError("--n_subsamples -1: full-bag (ragged) training is not ported "
                                  "(ROADMAP.md A6)")
    cfg = MadeleineConfig.from_dict(d)   # finalized
    cfg._extras = {k: d[k] for k in EXTRAS}
    return cfg

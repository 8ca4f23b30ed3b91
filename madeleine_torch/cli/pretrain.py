"""MADELEINE multistain pretraining, on one device or data-parallel (ref: bin/pretrain.py).

Usage (the flags of scripts/launch_pretrain_withoutStainEncodings.sh, plus --device;
add --add_stain_encoding for scripts/launch_pretrain_withStainEncodings.sh):
    python -m madeleine_torch.cli.pretrain --dataset ACROBAT --csv_fpath <ACROBAT.csv> \
        --data_root_dir <bags> --results_dir <dir> --wsi_encoder abmil --n_heads 4 \
        --patch_embedding_dim 512 --wsi_encoder_hidden_dim 512 --activation softmax \
        --global_loss info-nce --local_loss got --temperature 0.001 --symmetric_cl \
        --lr 0.0001 --batch_size 65 --n_subsamples 2048 --warmup --warmup_epochs 5 \
        --precision bfloat16 [--max_epochs N] [--resume <dir>] [--downstream_dir <dir>] \
        [--checkpoint_every N] [--device cuda]

Reads the cohort CSV (`csv` module) and the per-(case, stain) bags: ``.bag``
files through the native loader (`native/dataset.py`, C++ threaded assembly
into a pinned ring, in bf16 under ``--precision bfloat16``) when
``--native_loader`` is ``on``, or ``auto`` (the default) and the data dir
holds ``.bag`` files; otherwise through the Python loader (``.h5`` where
h5py imports, else ``.npz`` or ``.bag``). With ``--n_subsamples -1`` (the
default) every bag trains whole: the ragged loaders (`NativeRaggedLoader`,
`RaggedTrainLoader`) pad each batch's bags to its length bucket (1024 ...
16384, powers of two past the top) under a token mask; with a positive
count, each bag is subsampled to that many tokens. It takes AdamW steps of
InfoNCE + GOT on the card (kernels K6-K14; with ``--intra_modality_loss
info-nce`` also the intra-modality InfoNCE between two half-bag views of
every bag, K6/K7's view route; with a non-softmax
``--activation``, the per-op lane's kernels 15-20 in place of K6/K7, and
with softmax and MADELEINE_NO_FUSED_ENCODER set in the environment, kernels
15-20 and the training pool's rows 4-5), and writes into
``<results_dir>/<config hash>/``: ``config.json``, ``model_config.txt``,
``metrics.jsonl`` (one record per epoch, with the loader's name and host
ms per batch, the native loader's parts and pinned bytes, per-step
timings, kernel launches, bucket and valid tokens, the ragged loaders'
truncation count after each batch, and one record for the downstream
pass), ``train_state`` (+
``.meta.json``) when a checkpoint is due, ``model.pt`` +
``model_config.json``, and with --downstream_dir the slide embeddings of
that cohort as ``<name>.pkl``. A run resumes exactly from
``--resume <train_state dir>`` (or from its own results dir's train state).
The card's machine has no pandas or h5py: give it ``.bag`` bags (``python -m
madeleine_torch.cli.convert_bags``) or ``.npz`` ones.

Data parallelism: ``torchrun --nproc_per_node N -m madeleine_torch.cli.pretrain
<the same flags>`` runs one process per device (rank r on cuda:LOCAL_RANK,
NCCL; with ``--device cpu``, Gloo), each loading its rows of every global
batch of --batch_size (which must divide by N; the subsample is then drawn
per case, as the JAX CLI's ``per_case_seed``), and the step sums the
gradients over the ranks, so the weights stay equal on every rank
(`train/trainer.py`). --mesh_shape, when given, must equal N. Only rank 0
writes the results dir; every rank restores a resumed run and gates the
checkpoint on the same, global, smooth rank. Each rank prints its
parameters' sha256 at the end.

The host runs up to MADELEINE_DISPATCH_WINDOW steps (default 8) ahead of
the card: the skip is decided on the device and each step's records are
read that many steps later (`train/trainer.py::train_loop`). A batch of the
Python loader is pinned by `host_batches` (PyTorch's caching host
allocator, which keeps a block from reuse until the copy that reads it has
completed on the stream); a slot of the native loader's ring is refilled
once the step has recorded its batch's copy and that copy has completed
(`native/dataset.py::SlotGuard`), so the ring may be 2 slots deep under the
Prefetcher (its depth from the slot's bytes and the host's MemTotal; each
epoch's record logs ``pinned_bytes`` and ``ring_depth``). Each step runs
under the profiler range ``step_fn`` (`--profile_dir`;
`python -m madeleine_torch.tools.profile_summary <dir>` summarises it).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from madeleine_torch.data.datasets import Prefetcher
from madeleine_torch.eval.inference import get_downstream_loader, run_inference
from madeleine_torch.native.dataset import NativeRaggedLoader, NativeTrainLoader
from madeleine_torch.ops import launches
from madeleine_torch.parallel import multihost
from madeleine_torch.setup import (setup_dataloader, setup_dataset, setup_model, setup_optim,
                                   setup_results_dir)
from madeleine_torch.train import checkpoint as ckpt
from madeleine_torch.train.trainer import make_train_step, train_loop
from madeleine_torch.utils.args import build_parser, config_from_args
from madeleine_torch.utils.file_utils import print_network, save_pkl
from madeleine_torch.utils.logging import MetricsLogger
from madeleine_torch.utils.profiling import trace
from madeleine_torch.utils.seed import set_deterministic_mode

MIN_CHECKPOINT_EPOCH = 20  # ref: bin/pretrain.py:69 (no saves for the first 20 epochs)


def host_batches(loader, load_ms: List[float], pin: bool,
                 truncations: Optional[List[int]] = None) -> Iterator[Dict]:
    """The loader's batches, their feats pinned for an asynchronous copy to
    the card when `pin` (the native loader's ring is pinned already: it is
    not copied again); appends each batch's host ms (for the Python loader
    read, subsample, collate and pin) to `load_ms` and, for a ragged
    loader, its truncation count after the batch to `truncations`."""
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            return
        feats = batch["feats"]
        if pin and not (isinstance(feats, torch.Tensor) and feats.is_pinned()):
            batch["feats"] = torch.as_tensor(feats).pin_memory()
        load_ms.append((time.perf_counter() - t0) * 1e3)
        if truncations is not None and hasattr(loader, "truncation_count"):
            truncations.append(loader.truncation_count)
        yield batch


def make_loader(cfg, native_loader: str, dev: torch.device, process_index: int = 0,
                process_count: int = 1):
    """(loader, its name) as the JAX CLI chooses (bin/pretrain.py:60-116):
    ``auto`` is ``on`` when the data dir holds ``.bag`` files; ``on`` is the
    native loader, assembling in bf16 under --precision bfloat16 and in f32
    otherwise; ``off`` is the setup family's SlideDataset + TrainLoader
    (`setup.setup_dataset`, `setup.setup_dataloader`). --n_subsamples -1
    takes the ragged loaders (NativeRaggedLoader, RaggedTrainLoader),
    printing the JAX CLI's lines. Under several processes each loader
    yields rank `process_index`'s rows, the subsample drawn per case."""
    ragged = cfg.n_subsamples == -1
    procs = dict(process_index=process_index, process_count=process_count)
    per_case = process_count > 1   # JAX bin/pretrain.py:95,108
    if native_loader == "auto":
        bags = glob.glob(os.path.join(cfg.data_root_dir or "", "*.bag"))
        native_loader = "on" if bags else "off"
    if native_loader == "on":
        out_dtype = "bfloat16" if cfg.precision == "bfloat16" else "float32"
        kw = dict(embedding_size=cfg.patch_embedding_dim, batch_size=cfg.batch_size,
                  seed=cfg.seed, out_dtype=out_dtype, device=dev, **procs)
        if ragged:
            loader = NativeRaggedLoader(cfg.csv_fpath, cfg.data_root_dir, cfg.MODALITIES, **kw)
            print(f"* Native .bag loader, full-bag (ragged) batches ({out_dtype} assembly)")
        else:
            loader = NativeTrainLoader(cfg.csv_fpath, cfg.data_root_dir, cfg.MODALITIES,
                                       sample=cfg.n_subsamples, per_case_seed=per_case, **kw)
            print(f"* Native .bag loader (C++ threaded assembler, {out_dtype} assembly)")
        return loader, "native-bf16" if out_dtype == "bfloat16" else "native-f32"
    if ragged:
        print("* Full-bag (ragged) training: padded length buckets + token masks")
    dataset = setup_dataset(cfg, process_count)
    return setup_dataloader(cfg, dataset, process_index, process_count), "python"


def param_digest(model: torch.nn.Module) -> str:
    """sha256 over every parameter's bytes, in name order."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> str:
    """Run pretraining; returns the results dir. Rank 0 prints the run's
    timeline last: the wall clock (time.time()) at each part's end, from the
    entry into main to the end of the downstream pass."""
    timeline = {"main": time.time()}
    parser = build_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    own_group = not dist.is_initialized() and multihost.initialize_from_env(args.device)
    rank, world = multihost.process_info()
    group = dist.group.WORLD if dist.is_initialized() else None
    cfg = config_from_args(args, world)
    extras = cfg._extras
    dev = multihost.local_device(args.device)
    set_deterministic_mode(cfg.seed)
    primary = rank == 0

    results = cfg.RESULTS_SAVE_PATH
    if primary:   # only rank 0 writes the results dir
        setup_results_dir(cfg)
        print(f"* Running experiment {cfg.EXP_CODE}")
        print(f"* Results dir: {results}")
        if world > 1:
            print(f"* Data parallel over {world} processes ({dist.get_backend()})")
    logger = (MetricsLogger(results, use_wandb=cfg.log_ml, project=extras["wandb_project_name"],
                            run_name=cfg.EXP_CODE, config=cfg.to_dict(), tags=[cfg.cohort])
              if primary else None)
    timeline["setup"] = time.time()

    # ---- data -----------------------------------------------------------
    loader, loader_name = make_loader(cfg, extras["native_loader"], dev, rank, world)
    steps_per_epoch = len(loader)
    n_cases = len(loader.rows) if loader_name != "python" else len(loader.dataset)
    if primary:
        print(f"* {loader_name} loader: {n_cases} cases, {steps_per_epoch} steps/epoch")
    timeline["loader"] = time.time()

    # ---- model / optimizer ----------------------------------------------
    model = setup_model(cfg, device=dev)
    if primary:
        print(f"* Model parameters: {sum(p.numel() for p in model.parameters()):,}")
        print_network(model, cfg, results_dir=results)
    optimizer, schedule = setup_optim(cfg, model, steps_per_epoch)
    train_step = make_train_step(cfg, model, optimizer, schedule, group=group)

    start_epoch, best_rank = 0, 0.0
    state_dir = os.path.join(results, "train_state")
    resume_dir = extras["resume"]
    if resume_dir or (cfg.pretrained is None and os.path.exists(state_dir)):
        src = resume_dir or state_dir
        meta = ckpt.load_metadata(src) or {}
        state = ckpt.restore_train_state(src)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        train_step.updates = int(state["updates"])
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_rank = float(meta.get("best_rank", 0.0))
        if primary:
            print(f"* Resumed from {src} at epoch {start_epoch} (best_rank={best_rank:.2f})")

    timeline["model"] = time.time()

    # ---- epochs (under --profile_dir, rank 0 writes <profile_dir>/trace.json) ----
    with trace(cfg.profile_dir if primary else None):
        for epoch in range(start_epoch, cfg.max_epochs):
            if primary:
                print(f"\nTraining for epoch {epoch}...")
            start = time.time()
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            loader.set_epoch(epoch)   # the shuffle and subsamples keyed by (seed, epoch)
            load_ms: List[float] = []
            truncations: List[int] = []
            ep_loss, train_rank, agg = train_loop(
                cfg, train_step,
                Prefetcher(host_batches(loader, load_ms, dev.type == "cuda", truncations)),
                epoch, cfg.seed)
            # the loss, the skips and the smooth rank are the global batch's, the
            # same on every rank, so every rank takes the same checkpoint gate
            improved = epoch > MIN_CHECKPOINT_EPOCH and train_rank > best_rank
            due = improved or (cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0)
            if improved:
                best_rank_before, best_rank = best_rank, train_rank
            if not primary:
                continue
            print(f"Done with epoch {epoch}: loss={ep_loss:.3f} rank={train_rank:.3f} "
                  f"time={time.time() - start:.1f}s ({agg['n_skipped']} skipped)")
            record = {"train_loss": ep_loss, "train_rank": train_rank,
                      "epoch_time": agg["epoch_time"], "n_steps": agg["n_steps"],
                      "n_skipped": agg["n_skipped"], "epoch": epoch, "loader": loader_name,
                      "loader_ms": load_ms, "steps": agg["steps"]}
            if loader_name != "python":   # the native loader's parts, per batch
                for part in ("draw_ms", "assemble_ms", "guard_wait_ms"):
                    record[part] = [t[part] for t in loader.timings]
                record["pinned_bytes"] = loader.pinned_bytes
                record["ring_depth"] = loader.ring_depth
            if truncations:   # a ragged loader's count after each batch
                record["truncation_count"] = truncations
            if dev.type == "cuda":
                record["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            logger.log(record, step=epoch)
            if improved:
                print(f"Better rank: {best_rank_before} --> {train_rank}. Saving model")
                ckpt.save_best_torch(results, model, cfg)
            if due:
                ckpt.save_train_state(
                    state_dir, {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                                "updates": int(train_step.updates)},
                    metadata={"epoch": epoch, "best_rank": best_rank, "train_rank": train_rank,
                              "loss": float(ep_loss)})

    timeline["epochs"] = time.time()
    if primary:
        print("\nDone with training\n")
        # the final model.pt when the rank gating never fired (short runs)
        if not os.path.exists(os.path.join(results, "model.pt")):
            ckpt.save_best_torch(results, model, cfg)

    timeline["saved"] = time.time()
    # ---- downstream slide extraction ----------------------------------------
    downstream = extras["downstream_dir"]
    if downstream:
        model.eval()
        before = launches.read()
        res, ds_rank = run_inference(model, get_downstream_loader(downstream), device=dev,
                                     group=group, verbose=primary)
        after = launches.read()
        name = os.path.basename(os.path.normpath(downstream)) or "downstream"
        if primary:
            save_pkl(os.path.join(results, f"{name}.pkl"), res)
            print(f"Rank for {name} = {ds_rank}")
            logger.log({"downstream": name, "slides": len(res["slide_ids"]),
                        "launches": {k: after[k] - before[k] for k in after
                                     if after[k] > before[k]}})
            logger.summary(f"{name}_rank", ds_rank)

    timeline["downstream"] = time.time()
    # every rank's weights, to show that they are equal
    print(f"* rank {rank}/{world}: parameters sha256 {param_digest(model)}")
    if primary:
        logger.close()
        print("\n" + 100 * "-" + "\nEnd of experiment, bye!\n" + 100 * "-")
        timeline["end"] = time.time()
        print(f"* Timeline: {json.dumps(timeline)}", flush=True)
    if own_group:
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()

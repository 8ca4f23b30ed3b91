"""MADELEINE multistain pretraining on one device (ref: bin/pretrain.py).

Usage (the flags of scripts/launch_pretrain_withoutStainEncodings.sh, plus --device;
add --add_stain_encoding for scripts/launch_pretrain_withStainEncodings.sh):
    python -m madeleine_torch.cli.pretrain --dataset ACROBAT --csv_fpath <ACROBAT.csv> \
        --data_root_dir <bags> --results_dir <dir> --wsi_encoder abmil --n_heads 4 \
        --patch_embedding_dim 512 --wsi_encoder_hidden_dim 512 --activation softmax \
        --global_loss info-nce --local_loss got --temperature 0.001 --symmetric_cl \
        --lr 0.0001 --batch_size 65 --n_subsamples 2048 --warmup --warmup_epochs 5 \
        --precision bfloat16 [--max_epochs N] [--resume <dir>] [--downstream_dir <dir>] \
        [--checkpoint_every N] [--device cuda]

Reads the cohort CSV (`csv` module) and the per-(case, stain) bags
(``.h5`` where h5py imports, else ``.npz`` or ``.bag``), takes AdamW steps of
InfoNCE + GOT on the card (kernels K6-K14), and writes into
``<results_dir>/<config hash>/``: ``config.json``, ``model_config.txt``,
``metrics.jsonl`` (one record per epoch, with per-step timings and kernel
launches, and one for the downstream pass), ``train_state`` (+
``.meta.json``) when a checkpoint is due, ``model.pt`` +
``model_config.json``, and with --downstream_dir the slide embeddings of
that cohort as ``<name>.pkl``. A run resumes exactly from
``--resume <train_state dir>`` (or from its own results dir's train state).
The card's machine has no pandas or h5py: give it ``.npz`` or ``.bag`` bags.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List

import torch

from madeleine_torch.data.datasets import Prefetcher, SlideDataset, TrainLoader
from madeleine_torch.eval.inference import get_downstream_loader, run_inference
from madeleine_torch.models.factory import create_model
from madeleine_torch.ops import launches
from madeleine_torch.train import checkpoint as ckpt
from madeleine_torch.train.optim import make_optimizer
from madeleine_torch.train.trainer import make_train_step, train_loop
from madeleine_torch.utils.args import build_parser, config_from_args
from madeleine_torch.utils.device import resolve_device
from madeleine_torch.utils.file_utils import print_network, save_pkl
from madeleine_torch.utils.logging import MetricsLogger
from madeleine_torch.utils.seed import set_deterministic_mode

MIN_CHECKPOINT_EPOCH = 20  # ref: bin/pretrain.py:69 (no saves for the first 20 epochs)


def host_batches(loader, load_ms: List[float], pin: bool) -> Iterator[Dict]:
    """The loader's batches, their feats pinned for an asynchronous copy to
    the card when `pin`; appends each batch's host ms (read, subsample,
    collate, pin) to `load_ms`."""
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            return
        if pin:
            batch["feats"] = torch.from_numpy(batch["feats"]).pin_memory()
        load_ms.append((time.perf_counter() - t0) * 1e3)
        yield batch


def main(argv=None) -> str:
    """Run pretraining; returns the results dir."""
    parser = build_parser()
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    extras = cfg._extras
    dev = resolve_device(args.device)
    set_deterministic_mode(cfg.seed)

    results = cfg.RESULTS_SAVE_PATH
    os.makedirs(results, exist_ok=True)
    cfg.save(os.path.join(results, "config.json"))
    print(f"* Running experiment {cfg.EXP_CODE}")
    print(f"* Results dir: {results}")
    logger = MetricsLogger(results, use_wandb=cfg.log_ml, project=extras["wandb_project_name"],
                           run_name=cfg.EXP_CODE, config=cfg.to_dict(), tags=[cfg.cohort])

    # ---- data -----------------------------------------------------------
    dataset = SlideDataset(cfg.dataset, cfg.csv_fpath, cfg.data_root_dir, cfg.MODALITIES,
                           embedding_size=cfg.patch_embedding_dim, sample=cfg.n_subsamples,
                           seed=cfg.seed)
    loader = TrainLoader(dataset, cfg.batch_size, seed=cfg.seed)
    steps_per_epoch = len(loader)
    print(f"* {len(dataset)} cases, {steps_per_epoch} steps/epoch")

    # ---- model / optimizer ----------------------------------------------
    _, model = create_model(cfg, seed=cfg.seed, device=dev)
    print(f"* Model parameters: {sum(p.numel() for p in model.parameters()):,}")
    print_network(model, cfg, results_dir=results)
    optimizer, schedule = make_optimizer(cfg, model.parameters(), steps_per_epoch)
    train_step = make_train_step(cfg, model, optimizer, schedule)

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
        print(f"* Resumed from {src} at epoch {start_epoch} (best_rank={best_rank:.2f})")

    prof = None
    if cfg.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        prof.start()

    # ---- epochs -----------------------------------------------------------
    for epoch in range(start_epoch, cfg.max_epochs):
        print(f"\nTraining for epoch {epoch}...")
        start = time.time()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        loader.set_epoch(epoch)   # the shuffle and subsamples keyed by (seed, epoch)
        load_ms: List[float] = []
        ep_loss, train_rank, agg = train_loop(
            cfg, train_step, Prefetcher(host_batches(loader, load_ms, dev.type == "cuda")),
            epoch, cfg.seed)
        print(f"Done with epoch {epoch}: loss={ep_loss:.3f} rank={train_rank:.3f} "
              f"time={time.time() - start:.1f}s ({agg['n_skipped']} skipped)")
        record = {"train_loss": ep_loss, "train_rank": train_rank,
                  "epoch_time": agg["epoch_time"], "n_steps": agg["n_steps"],
                  "n_skipped": agg["n_skipped"], "epoch": epoch, "loader_ms": load_ms,
                  "steps": agg["steps"]}
        if dev.type == "cuda":
            record["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        logger.log(record, step=epoch)

        improved = epoch > MIN_CHECKPOINT_EPOCH and train_rank > best_rank
        if improved:
            print(f"Better rank: {best_rank} --> {train_rank}. Saving model")
            ckpt.save_best_torch(results, model, cfg)
            best_rank = train_rank
        if improved or (cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0):
            ckpt.save_train_state(
                state_dir, {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                            "updates": train_step.updates},
                metadata={"epoch": epoch, "best_rank": best_rank, "train_rank": train_rank,
                          "loss": float(ep_loss)})

    if prof is not None:
        prof.stop()
        os.makedirs(cfg.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
    print("\nDone with training\n")

    # the final model.pt when the rank gating never fired (short runs)
    if not os.path.exists(os.path.join(results, "model.pt")):
        ckpt.save_best_torch(results, model, cfg)

    # ---- downstream slide extraction ----------------------------------------
    downstream = extras["downstream_dir"]
    if downstream:
        model.eval()
        before = launches.read()
        res, rank = run_inference(model, get_downstream_loader(downstream), device=dev)
        after = launches.read()
        name = os.path.basename(os.path.normpath(downstream)) or "downstream"
        save_pkl(os.path.join(results, f"{name}.pkl"), res)
        print(f"Rank for {name} = {rank}")
        logger.log({"downstream": name, "slides": len(res["slide_ids"]),
                    "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}})
        logger.summary(f"{name}_rank", rank)

    logger.close()
    print("\n" + 100 * "-" + "\nEnd of experiment, bye!\n" + 100 * "-")
    return results


if __name__ == "__main__":
    main()

"""Single-device train step and epoch loop (InfoNCE + GOT).

PyTorch counterpart of `madeleine_tpu/train/trainer.py` (`compute_losses`,
`make_train_step` without a mesh, `train_loop` without a mesh or hosts;
ref: madeleine/utils/trainer.py:20-145):

- per-stain masked InfoNCE between the H&E and each stain's slide
  embeddings, equal to the reference's boolean subsetting (trainer.py:25-33);
- with `local_loss="got"`, GOT between the H&E tokens and each stain's
  tokens, all stain pairs in one batched `got_loss_multi` (kernels K8-K10 on
  the card): per stain pair one shared draw of `got_subsample` token indices
  (the JAX package's reference-style branch, trainer.py:136-147) from a
  generator keyed by the step's seed on a stream of its own;
- mixed precision as in the JAX package (:217-222): feats and a copy of the
  parameters in the compute dtype, f32 master weights in the optimizer;
- a step where no stain has at least 2 valid cases is a no-op that does not
  advance the schedule (the reference's `continue`, trainer.py:120-122), and
  a non-finite loss skips the update (no reference equivalent);
- the epoch's smooth rank on the H&E embeddings (trainer.py:141-143).

The encoder runs through ops/encoder_train.py: kernels K6/K7 on the card
(bf16 only), their plain versions on CPU tensors; with stain encodings the
op also returns the input gradient, and the code table ([n_mod, 32],
`embedding.weight`) is one more AdamW parameter with the configured weight
decay, as optax.adamw treats it in the JAX package. GOT through ops/ipot.py
and ops/got_glue.py (K8-K14). A batch's feats arrive as f32 (pinned by the
caller's loader thread on the card) and are copied to the device
asynchronously, then cast there. GOT with ragged token masks (per-side
subsampling, ROADMAP.md A6), the intra-modality loss, n_views=3 and data
parallelism are not ported.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from madeleine_torch.config import HE_POSITION, MadeleineConfig, compute_dtype
from madeleine_torch.models.madeleine import MADELEINE, forward_train
from madeleine_torch.ops import launches
from madeleine_torch.ops import losses as L
from madeleine_torch.ops.encoder_train import F32_TODO
from madeleine_torch.ops.rank import smooth_rank_measure

WHOLE_VIEW_POSITION = 0  # ref: trainer.py:16
GOT_STREAM = 0x474F54    # keys the GOT subsample draw apart from the dropout masks


def got_generator(seed: int, device) -> torch.Generator:
    """The generator of one step's GOT subsample: keyed by (seed, GOT_STREAM)."""
    key = int(np.random.SeedSequence([seed, GOT_STREAM]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(key)


def compute_losses(cfg: MadeleineConfig, slide_embs: torch.Tensor, token_embs: torch.Tensor,
                   modality_labels: torch.Tensor, sample_mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   got_indices: Optional[Sequence[torch.Tensor]] = None,
                   token_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """slide_embs [bs, n_mod, n_views, e] f32, token_embs [bs, n_mod, t, d],
    modality_labels [bs, n_mod], sample_mask [bs] bool -> (total loss, any
    usable stain (bool tensor), per-stain valid-case counts).

    GOT subsamples min(cfg.got_subsample, t) tokens per stain pair: the
    indices are `got_indices[s]` for stain pair s (1..n_mod-1) when given,
    else `torch.randperm(t, generator=generator)[:sub]`, one draw per pair."""
    if cfg.intra_modality_loss == "info-nce":
        raise NotImplementedError("the intra-modality loss (n_views=3) is not ported "
                                  "(ROADMAP.md D3b)")
    use_got = cfg.local_loss == "got"
    if use_got and token_mask is not None:
        raise NotImplementedError("GOT with ragged token masks (per-side masked subsampling) "
                                  "is not ported (ROADMAP.md A6)")
    n_mod = slide_embs.shape[1]
    dev = slide_embs.device
    he = slide_embs[:, HE_POSITION, WHOLE_VIEW_POSITION]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    any_flag = torch.zeros((), dtype=torch.bool, device=dev)
    metrics = {}
    stain_labels = []
    for stain_idx in range(1, n_mod):
        labels = modality_labels[:, stain_idx] > 0
        if sample_mask is not None:
            labels = labels & sample_mask
        stain_labels.append(labels)

    got_per_stain = None
    if use_got:
        t = token_embs.shape[2]
        sub = min(cfg.got_subsample, t)
        if got_indices is None:
            if generator is None:
                raise ValueError("GOT needs a generator or got_indices")
            got_indices = [torch.randperm(t, generator=generator, device=generator.device)[:sub]
                           for _ in range(1, n_mod)]
        vs, qs = [], []
        for s, stain_idx in enumerate(range(1, n_mod)):
            idx = got_indices[s].to(token_embs.device)
            vs.append(token_embs[:, HE_POSITION, idx])        # shared index set per pair
            qs.append(token_embs[:, stain_idx, idx])
        got_per_stain = L.got_loss_multi(torch.stack(vs), torch.stack(qs),
                                         sample_mask=torch.stack(stain_labels))

    for s, stain_idx in enumerate(range(1, n_mod)):
        labels = stain_labels[s]
        cnt = labels.sum()
        flag = cnt > 1                                    # ref trainer.py:26 (>= 2 for CL)
        stain_total = torch.zeros((), dtype=torch.float32, device=dev)
        if cfg.global_loss == "info-nce":
            stain_total = stain_total + L.info_nce(
                he, slide_embs[:, stain_idx, WHOLE_VIEW_POSITION], temperature=cfg.temperature,
                symmetric=cfg.symmetric_cl, mask=labels)
        if use_got:
            stain_total = stain_total + cfg.local_loss_weight * got_per_stain[s]
        total = total + torch.where(flag, stain_total, torch.zeros_like(stain_total))
        any_flag = any_flag | flag
        metrics[f"n_{cfg.MODALITIES[stain_idx]}"] = cnt
    return total, any_flag, metrics


class TrainStep:
    """One optimizer step on one batch: `step(batch, seed) -> (he_embs,
    metrics)`. `seed` keys the step's dropout masks and, on a stream of its
    own, its GOT subsample. Updates the model's f32 parameters in place;
    `updates` counts the updates applied (the schedule's step)."""

    def __init__(self, cfg: MadeleineConfig, model: MADELEINE, optimizer: torch.optim.Optimizer,
                 schedule):
        if cfg.intra_modality_loss == "info-nce":
            raise NotImplementedError("n_views=3 is not ported (ROADMAP.md D3b)")
        self.cfg, self.model, self.optimizer, self.schedule = cfg, model, optimizer, schedule
        self.dtype = compute_dtype(cfg.precision)
        self.updates = 0

    def __call__(self, batch: Dict[str, object], seed: int):
        cfg, model = self.cfg, self.model
        dev = next(model.parameters()).device
        if dev.type == "cuda" and self.dtype != torch.bfloat16:
            raise NotImplementedError(f"a {self.dtype} train step on the card ({F32_TODO})")
        # copy first (asynchronous from pinned memory), then cast on the device
        feats = torch.as_tensor(batch["feats"]).to(dev, non_blocking=True).to(self.dtype)
        labels = torch.as_tensor(batch["modality_labels"]).to(dev)
        sample_mask = batch.get("sample_mask")
        sample_mask = (torch.ones(feats.shape[0], dtype=torch.bool, device=dev)
                       if sample_mask is None else torch.as_tensor(sample_mask).to(dev))
        token_mask = batch.get("token_mask")
        if token_mask is not None:
            token_mask = torch.as_tensor(token_mask).to(dev)
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        slide, tok = forward_train(model, feats, mask=token_mask, seed=seed)
        total, any_flag, metrics = compute_losses(cfg, slide.float(), tok, labels, sample_mask,
                                                  generator=got_generator(seed, dev),
                                                  token_mask=token_mask)
        ok = bool(any_flag & torch.isfinite(total))
        lr = self.schedule(self.updates)
        if ok:
            total.backward()
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.updates += 1
        he = slide[:, HE_POSITION, WHOLE_VIEW_POSITION].detach().float()
        return he, dict(metrics, loss=total.detach(), skipped=not ok, lr=lr)


def make_train_step(cfg: MadeleineConfig, model: MADELEINE, optimizer: torch.optim.Optimizer,
                    schedule) -> TrainStep:
    return TrainStep(cfg, model, optimizer, schedule)


def step_seed(seed: int, epoch: int, b_idx: int) -> int:
    """The dropout seed of one step: a 32-bit draw keyed by (seed, epoch, batch)."""
    return int(np.random.SeedSequence([seed, epoch, b_idx]).generate_state(1)[0])


def train_loop(cfg: MadeleineConfig, train_step: TrainStep, dataloader: Iterable,
               epoch: int, seed: int, log_every: int = 0
               ) -> Tuple[float, float, Dict[str, object]]:
    """One epoch. Returns (epoch loss summed over applied steps, smooth rank
    of the epoch's H&E embeddings, {epoch_time, n_steps, n_skipped, steps}).
    ``steps`` holds one record per step: its loss, whether it was skipped,
    ``wait_ms`` (host time blocked on the loader), ``step_ms`` (the step's
    time on the device stream, CUDA events, or the host clock on the CPU)
    and the kernel launches it made."""
    embeds, steps, events = [], [], []
    on_cuda = next(train_step.model.parameters()).is_cuda
    t0 = time.time()
    batches = iter(dataloader)
    for b_idx in itertools.count():
        t_wait = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        t_step = time.perf_counter()
        before = launches.read()
        if on_cuda:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        he, metrics = train_step(batch, step_seed(seed, epoch, b_idx))
        if on_cuda:
            events[-1][1].record()
        after = launches.read()
        steps.append({"loss": float(metrics["loss"]), "skipped": metrics["skipped"],
                      "wait_ms": (t_step - t_wait) * 1e3,
                      "step_ms": (time.perf_counter() - t_step) * 1e3,
                      "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}})
        sm = batch.get("sample_mask")
        keep = (np.ones(he.shape[0], bool) if sm is None else np.asarray(sm, bool))
        embeds.append(he.cpu().numpy()[keep])
        if log_every and b_idx % log_every == 0:
            print(f"Loss for batch: {b_idx} = {steps[-1]['loss']:.3f}")
    if on_cuda:
        torch.cuda.synchronize()
        for rec, (start, end) in zip(steps, events):
            rec["step_ms"] = start.elapsed_time(end)
    skips_a = np.asarray([s["skipped"] for s in steps], bool)
    losses_a = np.asarray([s["loss"] for s in steps], np.float64)
    ep_loss = float(losses_a[~skips_a].sum()) if steps else 0.0
    emb = np.concatenate(embeds, axis=0) if embeds else np.zeros((2, 2), np.float32)
    rank = float(smooth_rank_measure(torch.from_numpy(emb)))
    agg = {"epoch_time": time.time() - t0, "n_steps": int((~skips_a).sum()),
           "n_skipped": int(skips_a.sum()), "steps": steps}
    return ep_loss, rank, agg

"""Train step and epoch loop (InfoNCE + GOT + the intra-modality loss), on
one device or data-parallel over a process group.

PyTorch counterpart of `madeleine_tpu/train/trainer.py` (`compute_losses`,
`make_train_step`, `train_loop`; ref: madeleine/utils/trainer.py:20-145):

- per-stain masked InfoNCE between the H&E and each stain's slide
  embeddings, equal to the reference's boolean subsetting (trainer.py:25-33);
- with `local_loss="got"`, GOT between the H&E tokens and each stain's
  tokens, all stain pairs in one batched `got_loss_multi` (kernels K8-K10 on
  the card): without a token mask, per stain pair one shared draw of
  `got_subsample` token indices (the JAX package's reference-style branch,
  trainer.py:136-147) from a generator keyed by the step's seed on a stream
  of its own; with the ragged batches' token mask, a draw per side and bag
  over its valid tokens (`losses.masked_subsample`, trainer.py:129-150), the
  Gumbel noise keyed by the step's seed, the side and the global row;
- with `intra_modality_loss="info-nce"` (n_views=3), per stain the intra
  loss (`losses.make_intra_loss` of `intra_modality_mode_wsi`) between the
  two half-bag views of the H&E and between those of the stain
  (trainer.py:156-187, single device);
- mixed precision as in the JAX package (:217-222): feats and a copy of the
  parameters in the compute dtype, f32 master weights in the optimizer;
- the skip is decided on the device, as JAX's `lax.cond` (:237-248): the
  backward always runs, and `GatedAdamW` keeps the parameters, its moments
  and its count (the schedule's step) where no stain has at least 2 valid
  cases (the reference's `continue`, trainer.py:120-122) or the loss is not
  finite (no reference equivalent). A skipped step so costs a whole step on
  the card, as it does in JAX. The step never reads a device value on the
  host;
- `train_loop` leaves each step's records (loss, skip flag, H&E embeddings,
  CUDA events) on the device, copies them to the host asynchronously and
  reads them MADELEINE_DISPATCH_WINDOW steps later (default 8, JAX's name
  and default, :341-350; 0 reads them at the epoch's end), so the host runs
  up to that many steps ahead of the card;
- the epoch's smooth rank on the H&E embeddings (trainer.py:141-143);
- data parallelism (JAX's mesh lane, :249-290, one process per device
  here): with a process ``group`` each rank runs the step on its rows of
  the global batch. The dropout masks and the ragged GOT noise are keyed by
  global rows, the dense GOT draw and the half split by the step's seed
  alone, so N ranks draw what one process draws. `compute_losses` gathers
  the slide embeddings, labels and sample mask (InfoNCE and the intra loss
  then read the global batch, the counts are global), GOT runs on the local
  tokens with the global thresholds and per-stain sums
  (`losses.got_loss_multi(..., group=)`); every rank back-propagates the
  same replicated loss, and the gradients are summed over ranks in one
  all-reduce (`parallel/collectives.py`) before `GatedAdamW`, unchanged, so
  the skip flag, the loss and the weights are the same on every rank.
  `train_loop` gathers the epoch's H&E embeddings and sample masks in rank
  order (JAX's `allgather_rows`), so the smooth rank, and the checkpoint
  gate, agree on every rank. On NCCL no collective waits on the host (each
  is enqueued on the stream like a kernel); Gloo copies each through it.

The encoder runs through ops/encoder_train.py (kernels K6/K7 on the card,
bf16 or f32: `--precision float32` is the JAX package's parity route) or,
with a non-softmax activation or MADELEINE_NO_FUSED_ENCODER set, through the
per-op lane (ops/preattn.py, ops/gated_logits.py: kernels 15-18, bf16 or
f32 on the card; ops/linear_tok.py: kernels 19-20 in bf16, a plain F.linear
in f32 as in the JAX package; with softmax the training pool of
ops/attn_pool.py, rows 4-5, which also pools the half-bag views); their
plain versions on CPU tensors. With stain encodings the encoder also
returns the input gradient, and the code table ([n_mod, 32],
`embedding.weight`) is one more AdamW parameter with the configured weight
decay, as optax.adamw treats it in the JAX package. GOT through ops/ipot.py
and ops/got_glue.py (K8-K14). A batch's feats arrive as f32 or bf16 (pinned
by the caller's loader on the card) and are copied to the device
asynchronously, then cast there; its small arrays, the token mask of a
ragged batch among them, are pinned here before their copy.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from madeleine_torch.config import HE_POSITION, MadeleineConfig, compute_dtype
from madeleine_torch.models.abmil import drop_kernel_operands
from madeleine_torch.models.madeleine import MADELEINE, forward_train
from madeleine_torch.ops import launches
from madeleine_torch.ops import losses as L
from madeleine_torch.ops.rank import smooth_rank_measure
from madeleine_torch.parallel import collectives
from madeleine_torch.parallel.multihost import allgather_rows
from madeleine_torch.setup import setup_losses
from madeleine_torch.train.optim import GatedAdamW

WHOLE_VIEW_POSITION = 0  # ref: trainer.py:16
GOT_STREAM = 0x474F54    # keys the GOT subsample draw apart from the dropout masks
WINDOW_VAR = "MADELEINE_DISPATCH_WINDOW"   # JAX madeleine_tpu/train/trainer.py:350
DEFAULT_WINDOW = 8


def got_generator(seed: int, device) -> torch.Generator:
    """The generator of one step's GOT subsample: keyed by (seed, GOT_STREAM)."""
    key = int(np.random.SeedSequence([seed, GOT_STREAM]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(key)


def got_gumbel(seed: int, n_mod: int, bs: int, t: int, device, row_start: int = 0
               ) -> torch.Tensor:
    """The Gumbel noise [n_mod - 1, 2, bs, t] of a ragged step's GOT draws:
    stain pair s, side 0 (the H&E tokens) or 1 (the stain's), from
    `losses.gumbel_noise` keyed by (seed, GOT_STREAM) on stream 2 s + side
    and the batch row's global row, row_start + i (a rank's first row under
    data parallelism). A token's noise does not depend on t, so padding a
    batch to a larger bucket draws the same subsample."""
    streams = torch.arange(2 * (n_mod - 1), device=device).reshape(n_mod - 1, 2, 1)
    streams, rows = torch.broadcast_tensors(
        streams, row_start + torch.arange(bs, device=device))
    return L.gumbel_noise(seed, GOT_STREAM, streams, rows, t)


def compute_losses(cfg: MadeleineConfig, slide_embs: torch.Tensor, token_embs: torch.Tensor,
                   modality_labels: torch.Tensor, sample_mask: Optional[torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   got_indices: Optional[Sequence[torch.Tensor]] = None,
                   token_mask: Optional[torch.Tensor] = None, seed: Optional[int] = None,
                   gumbel: Optional[torch.Tensor] = None, group=None, row_start: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """slide_embs [bs, n_mod, n_views, e] f32, token_embs [bs, n_mod, t, d],
    modality_labels [bs, n_mod], sample_mask [bs] bool, token_mask [bs,
    n_mod, t] bool or None -> (total loss, any usable stain (bool tensor),
    per-stain valid-case counts).

    GOT subsamples min(cfg.got_subsample, t) tokens per stain pair. Without
    a token mask: the indices are `got_indices[s]` for stain pair s
    (1..n_mod-1) when given, else `torch.randperm(t, generator=generator)[:sub]`,
    one draw shared by both sides of a pair. With one: each side draws
    from its own bags' valid tokens (`losses.masked_subsample`), on the
    noise `gumbel` [n_mod - 1, 2, bs, t] when given (the tests hand it
    JAX's), else `got_gumbel(seed, ...)`. The intra loss reads views 1 and
    2 (n_views=3).

    With a process ``group`` (JAX's axis_name, :100-110,158-165) the inputs
    are this rank's rows, the first of them global row ``row_start``, and
    every returned value is the global batch's, the same on every rank: the
    slide embeddings, labels and sample mask are gathered in rank order, so
    InfoNCE, the intra loss (InfoNCE, or the MSE modes' mean over the global
    batch) and the counts read the global batch; GOT runs on this rank's
    tokens (`got_loss_multi(..., group=)`)."""
    info_nce, got_multi, intra = setup_losses(cfg)
    use_intra, use_got = intra is not None, got_multi is not None
    n_mod = slide_embs.shape[1]
    dev = slide_embs.device

    def stain_masks(labels_all, smask):
        out = []
        for stain_idx in range(1, n_mod):
            labels = labels_all[:, stain_idx] > 0
            if smask is not None:
                labels = labels & smask
            out.append(labels)
        return out

    stain_labels = stain_masks(modality_labels, sample_mask)      # this rank's rows
    if group is None:
        slide_g, global_labels = slide_embs, stain_labels
    else:   # the global batch's embeddings, labels and sample mask, in rank order
        slide_g = collectives.gather_rows(slide_embs, group, "embeddings")
        smask = (torch.ones(slide_embs.shape[0], dtype=torch.bool, device=dev)
                 if sample_mask is None else sample_mask)
        packed = collectives.gather_rows(
            torch.cat([modality_labels.float(), smask.float()[:, None]], 1), group, "labels")
        global_labels = stain_masks(packed[:, :n_mod], packed[:, n_mod] > 0)
    he = slide_g[:, HE_POSITION, WHOLE_VIEW_POSITION]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    any_flag = torch.zeros((), dtype=torch.bool, device=dev)
    metrics = {}

    got_per_stain = None
    if use_got and token_mask is not None:
        bs, _, t, _ = token_embs.shape
        sub = min(cfg.got_subsample, t)
        if gumbel is None:
            if seed is None:
                raise ValueError("GOT on a ragged batch needs a seed or the Gumbel noise")
            gumbel = got_gumbel(seed, n_mod, bs, t, token_embs.device, row_start)
        vs, qs = [], []
        for s, stain_idx in enumerate(range(1, n_mod)):   # per side: its own mask and noise
            vs.append(L.masked_subsample(token_embs[:, HE_POSITION], token_mask[:, HE_POSITION],
                                         sub, gumbel[s, 0]))
            qs.append(L.masked_subsample(token_embs[:, stain_idx], token_mask[:, stain_idx],
                                         sub, gumbel[s, 1]))
        got_per_stain = got_multi(torch.stack(vs), torch.stack(qs),
                                  sample_mask=torch.stack(stain_labels), group=group)
    elif use_got:
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
        got_per_stain = got_multi(torch.stack(vs), torch.stack(qs),
                                  sample_mask=torch.stack(stain_labels), group=group)

    for s, stain_idx in enumerate(range(1, n_mod)):
        labels = global_labels[s]
        cnt = labels.sum()
        flag = cnt > 1                                    # ref trainer.py:26 (>= 2 for CL)
        stain_total = torch.zeros((), dtype=torch.float32, device=dev)
        if info_nce is not None:
            stain_total = stain_total + info_nce(
                he, slide_g[:, stain_idx, WHOLE_VIEW_POSITION], mask=labels)
        if use_got:
            stain_total = stain_total + cfg.local_loss_weight * got_per_stain[s]
        if use_intra:   # two half-bag views of the H&E and of the stain (ref: trainer.py:51-66)
            l_he = intra(slide_g[:, HE_POSITION, 1], slide_g[:, HE_POSITION, 2],
                         mask=labels, symmetric=cfg.symmetric_cl)
            l_st = intra(slide_g[:, stain_idx, 1], slide_g[:, stain_idx, 2],
                         mask=labels, symmetric=cfg.symmetric_cl)
            stain_total = stain_total + (l_he + l_st)
        total = total + torch.where(flag, stain_total, torch.zeros_like(stain_total))
        any_flag = any_flag | flag
        metrics[f"n_{cfg.MODALITIES[stain_idx]}"] = cnt
    return total, any_flag, metrics


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """A batch array on `dev`: a host array is pinned first, so that its
    copy is asynchronous (a copy from pageable memory waits for the stream)."""
    x = torch.as_tensor(x)
    if dev.type == "cuda" and x.device.type == "cpu" and not x.is_pinned():
        x = x.pin_memory()
    return x.to(dev, non_blocking=True)


class TrainStep:
    """One optimizer step on one batch: `step(batch, seed) -> (he_embs,
    metrics)`, every value a device tensor (the host reads none). `seed`
    keys the step's dropout masks and, on streams of their own, its GOT
    subsample and its half-bag split. The update of the model's f32
    parameters is gated on the device (`GatedAdamW`, which evaluates its own
    schedule: `schedule`, when given, must be that one); `updates` is the
    optimizer's count of applied updates (the schedule's step), a device
    integer. A batch may carry its own half-bag split, ``half_mask`` [t]
    bool (n_views=3), and a ragged batch, whose ``token_mask`` [bs, n_mod,
    t] travels to the card with its feats, its GOT noise ``got_gumbel``
    (`got_gumbel`'s shape), and a dense batch its GOT indices
    ``got_indices`` (one [sub] index tensor per stain pair); the tests hand
    them the JAX package's.

    With a process ``group`` (data parallelism) a batch is this rank's rows
    of the global batch, each rank's the same number (the loaders'
    ``process_index``/``process_count``, or `parallel.mesh.shard_batch`);
    the step keys its masks and draws by global rows, computes the global
    batch's loss (`compute_losses`) and sums the gradients over the group
    before the update. The records it returns are the same on every rank
    but the H&E embeddings, which are this rank's rows."""

    def __init__(self, cfg: MadeleineConfig, model: MADELEINE, optimizer: GatedAdamW,
                 schedule=None, group=None):
        if schedule is not None and schedule is not optimizer.schedule:
            raise ValueError("the train step's schedule is its optimizer's (make_optimizer)")
        self.cfg, self.model, self.optimizer, self.group = cfg, model, optimizer, group
        self.dtype = compute_dtype(cfg.precision)
        self.n_views = 3 if cfg.intra_modality_loss == "info-nce" else 1   # JAX :212

    @property
    def updates(self) -> torch.Tensor:
        return self.optimizer.count

    @updates.setter
    def updates(self, n: int) -> None:
        self.optimizer.count.fill_(int(n))

    def __call__(self, batch: Dict[str, object], seed: int):
        cfg, model = self.cfg, self.model
        dev = next(model.parameters()).device
        # copy first (asynchronous from pinned memory), then cast on the device
        feats = torch.as_tensor(batch["feats"]).to(dev, non_blocking=True)
        copied = batch.get("copied")
        if copied is not None:
            copied.record()   # the native loader refills the ring slot once this completes
        feats = feats.to(self.dtype)
        labels = _to_device(batch["modality_labels"], dev)
        sample_mask = batch.get("sample_mask")
        sample_mask = (torch.ones(feats.shape[0], dtype=torch.bool, device=dev)
                       if sample_mask is None else _to_device(sample_mask, dev))
        token_mask = batch.get("token_mask")
        if token_mask is not None:
            token_mask = _to_device(token_mask, dev)
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        lbs = feats.shape[0]
        rank, world = (0, 1) if self.group is None else (dist.get_rank(self.group),
                                                          dist.get_world_size(self.group))
        slide, tok = forward_train(model, feats, mask=token_mask, n_views=self.n_views,
                                   seed=seed, half_mask=batch.get("half_mask"),
                                   row_start=rank * lbs, global_bs=world * lbs)
        gumbel, got_indices = batch.get("got_gumbel"), batch.get("got_indices")
        total, any_flag, metrics = compute_losses(
            cfg, slide.float(), tok, labels, sample_mask,
            generator=(got_generator(seed, dev) if token_mask is None and got_indices is None
                       else None),
            got_indices=got_indices, token_mask=token_mask, seed=seed,
            gumbel=None if gumbel is None else _to_device(gumbel, dev),
            group=self.group, row_start=rank * lbs)
        ok = any_flag & torch.isfinite(total)
        if total.requires_grad:
            total.backward()   # always, as JAX's value_and_grad; the update is gated
        if self.group is not None:
            collectives.sum_gradients(model.parameters(), self.group)
        lr = self.optimizer.step(ok=ok)
        drop_kernel_operands(model)   # K1's and K2's cached operands may be stale now
        he = slide[:, HE_POSITION, WHOLE_VIEW_POSITION].detach().float()
        return he, dict(metrics, loss=total.detach(), skipped=~ok, lr=lr)


def make_train_step(cfg: MadeleineConfig, model: MADELEINE, optimizer: GatedAdamW,
                    schedule=None, group=None) -> TrainStep:
    return TrainStep(cfg, model, optimizer, schedule, group)


def step_seed(seed: int, epoch: int, b_idx: int) -> int:
    """The dropout seed of one step: a 32-bit draw keyed by (seed, epoch, batch)."""
    return int(np.random.SeedSequence([seed, epoch, b_idx]).generate_state(1)[0])


def dispatch_window() -> int:
    """Steps the host may run ahead of the card (MADELEINE_DISPATCH_WINDOW,
    default 8; 0: read every record at the epoch's end)."""
    return int(os.environ.get(WINDOW_VAR, str(DEFAULT_WINDOW)))


def _host_async(x):
    """A device tensor's copy into pinned host memory, enqueued on the
    current stream (the host does not wait); anything else as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.to("cpu", non_blocking=True) if x.is_cuda else x
    return np.asarray(x)


def train_loop(cfg: MadeleineConfig, train_step: TrainStep, dataloader: Iterable,
               epoch: int, seed: int, log_every: int = 0
               ) -> Tuple[float, float, Dict[str, object]]:
    """One epoch. Returns (epoch loss summed over applied steps, smooth rank
    of the epoch's H&E embeddings, {epoch_time, n_steps, n_skipped, steps}).
    ``steps`` holds one record per step: its loss, whether it was skipped,
    ``wait_ms`` (host time blocked on the loader), ``step_ms`` (the step's
    time on the device stream, CUDA events, or the host clock on the CPU),
    the kernel launches it made (host counters), the batch's token count
    ``bucket`` and, for a ragged batch whose token mask is on the host, its
    count of valid tokens ``valid_tokens`` (None otherwise: a mask on the
    card is not read back).

    No step waits for the card. Each step's loss, skip flag, H&E embeddings
    and sample mask are copied to pinned host memory after it on the stream,
    and an event marks the copy's end; a record is read `dispatch_window()`
    steps later (0: at the epoch's end), and with `log_every` on the steps
    it prints. Under data parallelism (the step's ``group``) the epoch's H&E
    embeddings and sample masks are gathered in rank order at its end, so
    the smooth rank is the global batch's on every rank."""
    window = dispatch_window()
    recs, pending = [], []
    on_cuda = next(train_step.model.parameters()).is_cuda
    t0 = time.time()

    def fetch(rec):
        if on_cuda:
            rec["done"].synchronize()
            rec["step_ms"] = rec.pop("start").elapsed_time(rec.pop("end"))
        del rec["done"]
        rec["loss"] = float(rec["loss"])
        rec["skipped"] = bool(rec["skipped"])
        rec["sample_mask"] = np.asarray(rec["sample_mask"], bool)
        rec["he"] = np.asarray(rec["he"])

    batches = iter(dataloader)
    for b_idx in itertools.count():
        t_wait = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        t_step = time.perf_counter()
        before = launches.read()
        rec = {}
        if on_cuda:
            rec["start"] = torch.cuda.Event(enable_timing=True)
            rec["end"] = torch.cuda.Event(enable_timing=True)
            rec["done"] = torch.cuda.Event()
            rec["start"].record()
        he, metrics = train_step(batch, step_seed(seed, epoch, b_idx))
        if on_cuda:
            rec["end"].record()
        sm, tm = batch.get("sample_mask"), batch.get("token_mask")
        rec["bucket"] = int(batch["feats"].shape[2])
        rec["valid_tokens"] = (None if tm is None or getattr(tm, "is_cuda", False)
                               else int(np.count_nonzero(np.asarray(tm))))
        rec.update(loss=_host_async(metrics["loss"]), skipped=_host_async(metrics["skipped"]),
                   he=_host_async(he),
                   sample_mask=(np.ones(he.shape[0], bool) if sm is None else _host_async(sm)))
        if on_cuda:
            rec["done"].record()
        else:
            rec["done"] = None
        after = launches.read()
        rec.update(wait_ms=(t_step - t_wait) * 1e3, step_ms=(time.perf_counter() - t_step) * 1e3,
                   launches={k: after[k] - before[k] for k in after if after[k] > before[k]})
        recs.append(rec)
        pending.append(rec)
        if window > 0 and len(pending) > window:
            fetch(pending.pop(0))
        if log_every and b_idx % log_every == 0:
            fetch(pending.pop())   # this step's record: a wait for the card on printed steps only
            print(f"Loss for batch: {b_idx} = {rec['loss']:.3f}")
    for rec in pending:
        fetch(rec)
    embeds = [rec.pop("he") for rec in recs]
    keep = [rec.pop("sample_mask") for rec in recs]
    steps = recs
    skips_a = np.asarray([s["skipped"] for s in steps], bool)
    losses_a = np.asarray([s["loss"] for s in steps], np.float64)
    ep_loss = float(losses_a[~skips_a].sum()) if steps else 0.0
    if embeds:
        emb, keep = np.concatenate(embeds, axis=0), np.concatenate(keep, axis=0)
        if train_step.group is not None:   # the global batch's rows, in rank order
            emb, keep = (allgather_rows(emb, train_step.group),
                         allgather_rows(keep, train_step.group))
        emb = emb[keep]
    else:
        emb = np.zeros((2, 2), np.float32)
    rank = float(smooth_rank_measure(torch.from_numpy(emb)))
    agg = {"epoch_time": time.time() - t0, "n_steps": int((~skips_a).sum()),
           "n_skipped": int(skips_a.sum()), "steps": steps}
    return ep_loss, rank, agg

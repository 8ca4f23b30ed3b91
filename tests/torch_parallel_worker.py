"""One rank of the port's data-parallel CPU checks (Gloo), started by
`tests/test_torch_parallel.py` with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):

    python tests/torch_parallel_worker.py <cases.pt> <out dir>

Forms the group with `parallel.multihost.initialize_from_env("cpu")`, runs
every case of <cases.pt> (a list of dicts, see `run_case`) and saves
{case name: result} to <out dir>/rank<r>.pt. Imports the port only (no JAX).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madeleine_torch.config import MadeleineConfig  # noqa: E402
from madeleine_torch.eval.inference import run_inference  # noqa: E402
from madeleine_torch.models.madeleine import MADELEINE  # noqa: E402
from madeleine_torch.ops import encoder_train as et  # noqa: E402
from madeleine_torch.ops.losses import info_nce_global  # noqa: E402
from madeleine_torch.parallel import collectives, multihost  # noqa: E402
from madeleine_torch.parallel.bag_parallel import encode_bag_parallel  # noqa: E402
from madeleine_torch.parallel.mesh import BAG_AXIS, DATA_AXIS, make_mesh, shard_batch  # noqa: E402
from madeleine_torch.train import trainer  # noqa: E402
from madeleine_torch.train.optim import make_optimizer  # noqa: E402


def _model(case) -> MADELEINE:
    model = MADELEINE(MadeleineConfig(**case["cfg"]).finalize())
    model.load_state_dict(case["state_dict"], strict=True)
    return model


def _step(case, group, rank, world):
    """One train step on this rank's rows of case["batch"]: the loss, the
    skip flag, this rank's H&E embeddings, every gradient (summed over the
    ranks), the weights after the step and the collectives' traffic."""
    model = _model(case)
    opt, sched = make_optimizer(model.cfg, model.parameters(), steps_per_epoch=4)
    step = trainer.make_train_step(model.cfg, model, opt, sched, group=group)
    batch = shard_batch(case["batch"], rank, world)
    forward = trainer.forward_train
    if case.get("wrong_offsets"):   # the single-process offsets m * lb on every rank
        trainer.forward_train = lambda *a, **kw: forward(
            *a, **dict(kw, row_start=0, global_bs=None))
    rates = (et.PRE_RATE, et.GATE_RATE)
    if case.get("rates_zero"):
        et.PRE_RATE = et.GATE_RATE = 0.0
    sum_gradients, local = collectives.sum_gradients, {}

    def keep_local(params, grp):   # this rank's gradients, before their sum over ranks
        params = list(params)
        local.update({id(p): p.grad.clone() for p in params if p.grad is not None})
        sum_gradients(params, grp)

    collectives.reset()
    collectives.sum_gradients = keep_local
    try:
        he, metrics = step(batch, case["seed"])
    finally:
        trainer.forward_train = forward
        et.PRE_RATE, et.GATE_RATE = rates
        collectives.sum_gradients = sum_gradients
    return {"he": he, "loss": metrics["loss"], "skipped": bool(metrics["skipped"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None},
            "local_grads": {k: local[id(p)] for k, p in model.named_parameters()
                            if id(p) in local},
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "traffic": collectives.read()}


def _loop(case, group, rank, world):
    """`train_loop` over this rank's rows of case["batches"]: the epoch's
    loss and smooth rank (of the gathered H&E embeddings)."""
    model = _model(case)
    opt, sched = make_optimizer(model.cfg, model.parameters(), steps_per_epoch=4)
    step = trainer.make_train_step(model.cfg, model, opt, sched, group=group)
    batches = [shard_batch(b, rank, world) for b in case["batches"]]
    loss, smooth_rank, agg = trainer.train_loop(model.cfg, step, batches, 0, case["seed"])
    return {"loss": loss, "rank": smooth_rank, "n_steps": agg["n_steps"]}


def _info_nce(case, group, rank, world):
    """`losses.info_nce_global` on this rank's rows: the loss and the
    gradients of this rank's query and key rows."""
    rows = slice(rank * len(case["q"]) // world, (rank + 1) * len(case["q"]) // world)
    q, k = (case[n][rows].clone().requires_grad_(True) for n in ("q", "k"))
    loss = info_nce_global(q, k, group=group, temperature=0.01, symmetric=True,
                           mask=case["mask"][rows])
    loss.backward()
    return {"loss": loss.detach(), "dq": q.grad, "dk": k.grad}


def _bag(case, group, rank, world):
    """This rank's token shard of case["feats"] through `encode_bag_parallel`."""
    feats, mask = case["feats"], case["mask"]
    lt = feats.shape[1] // world
    return encode_bag_parallel(_model(case), feats[:, rank * lt:(rank + 1) * lt], group,
                               mask=mask[:, rank * lt:(rank + 1) * lt],
                               stain_idx=case["stain_idx"])


def _inference(case, group, rank, world):
    res, rank_measure = run_inference(_model(case), case["batches"], device="cpu", group=group,
                                      verbose=False)
    return {"embeds": res["embeds"], "slide_ids": res["slide_ids"], "rank": rank_measure}


def run_case(case, mesh, rank, world):
    if case["kind"] == "bag":
        return _bag(case, mesh.get_group(BAG_AXIS), rank, world)
    group = mesh.get_group(DATA_AXIS)
    run = {"step": _step, "loop": _loop, "inference": _inference,
           "info_nce": _info_nce}[case["kind"]]
    return run(case, group, rank, world)


def main(cases_path: str, out_dir: str) -> None:
    if not multihost.initialize_from_env("cpu", verbose=False):
        raise RuntimeError("no process group: WORLD_SIZE is not set")
    rank, world = multihost.process_info()
    cases = torch.load(cases_path, weights_only=False)
    data_mesh = make_mesh()
    bag_mesh = make_mesh(axis_names=(BAG_AXIS,))
    out = {}
    for case in cases:
        mesh = bag_mesh if case["kind"] == "bag" else data_mesh
        out[case["name"]] = run_case(case, mesh, rank, world)
    # rows and a bool mask gathered in rank order
    out["allgather_rows"] = (multihost.allgather_rows(np.full((2, 3), rank, np.float32)),
                             multihost.allgather_rows(np.asarray([True, rank == 0])))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])

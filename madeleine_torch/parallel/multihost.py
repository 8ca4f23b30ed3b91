"""The process group of a data-parallel run (port of
`madeleine_tpu/parallel/multihost.py`).

PyTorch runs one process per device, where JAX runs one process over N
devices: the port's "mesh" is a process group, started by torchrun
(``torchrun --nproc_per_node N -m madeleine_torch.cli.pretrain ...``), whose
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) takes
the place of JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.

- `initialize_from_env()`: the default group from that environment, NCCL
  on the card (rank r on cuda:LOCAL_RANK) and Gloo on the CPU; a group that
  fails to form raises, nothing drops to one process;
- `local_rows`: a rank's contiguous row block of a global batch (JAX's
  divisibility error);
- `allgather_rows`: the ranks' row blocks concatenated in rank order (the
  inverse of `local_rows`), e.g. the epoch's H&E embeddings for the smooth
  rank, so that it and the checkpoint gate agree on every rank;
- `process_info`, `is_primary`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from madeleine_torch.parallel import collectives
from madeleine_torch.utils.device import resolve_device

ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def local_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` when the card is asked
    for (None means the card), else the CPU. A missing GPU is an error."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize_from_env(device: Optional[Union[str, torch.device]] = None,
                        verbose: bool = True) -> bool:
    """Form the default process group from torchrun's environment when
    WORLD_SIZE is set (False, and nothing done, otherwise; True when a group
    exists). The backend is NCCL when `device` is the card (None means the
    card; the process takes cuda:LOCAL_RANK as its current device), Gloo
    when it is the CPU."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in ENV_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: start the run with "
                           "torchrun, or set all of " + ", ".join(ENV_VARS))
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    if verbose:
        print(f"* torch.distributed: rank {dist.get_rank()}/{dist.get_world_size()} "
              f"({dist.get_backend()}) on {dev}")
    return True


def process_info() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    return process_info()[0] == 0


def local_rows(global_bs: int, process_index: int, process_count: int) -> slice:
    """Rank `process_index`'s contiguous row block of a global batch."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} of {process_count} processes")
    if global_bs % process_count != 0:
        raise ValueError(f"global batch {global_bs} not divisible by "
                         f"{process_count} processes")
    lbs = global_bs // process_count
    return slice(process_index * lbs, (process_index + 1) * lbs)


def group_device(group=None) -> torch.device:
    """Where a collective of `group` takes its tensors: the current card
    under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_rows(local: np.ndarray, group=None) -> np.ndarray:
    """Every rank's rows of `local` (the same shape on every rank),
    concatenated in rank order; `local` itself without a process group."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return local
    arr = np.ascontiguousarray(local)
    as_bool = arr.dtype == np.bool_
    x = torch.from_numpy(arr.view(np.uint8) if as_bool else arr).to(group_device(group))
    out = torch.cat(collectives.all_gather(x, group, "rows")).cpu().numpy()
    return out.view(np.bool_) if as_bool else out

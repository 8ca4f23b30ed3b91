"""The device mesh (port of `madeleine_tpu/parallel/mesh.py`).

The model is about 5 M parameters, so the scale-out is data parallelism:
parameters replicated, the batch's rows split over the ``data`` axis, the
losses' collectives and one gradient all-reduce a step
(`parallel/collectives.py`). A bag too long for one device can also split
its tokens over the ``bag`` axis (`parallel/bag_parallel.py`). Here the mesh
is a `torch.distributed` DeviceMesh over the ranks of the default group,
one device each; an axis's process group is ``mesh.get_group(axis)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from madeleine_torch.parallel.multihost import local_rows

DATA_AXIS = "data"
BAG_AXIS = "bag"
SHARED_KEYS = ("half_mask", "got_indices", "copied")   # a batch's entries every rank takes whole


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,)) -> DeviceMesh:
    """A mesh over every rank of the default group (which must exist): 1-D
    over ``data`` by default; pass axis_names ("data", "bag") with a 2-D
    shape for bag parallelism. On a CUDA group (NCCL) the mesh's device
    type is cuda, else cpu."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.multihost.initialize_from_env)")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(n) for n in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name axes {tuple(axis_names)}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, "
                         f"the group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def shard_batch(batch: Dict, process_index: int, process_count: int) -> Dict:
    """Rank `process_index`'s rows of a global batch: every array, tensor or
    list whose leading length is the batch's (that of ``feats``), and the
    row axis (2) of a ragged step's GOT noise ``got_gumbel``; a half-bag
    split, GOT indices and anything else are shared."""
    bs = len(batch["feats"])
    rows = local_rows(bs, process_index, process_count)
    out = {}
    for k, v in batch.items():
        if k == "got_gumbel":
            v = v[:, :, rows]
        elif (k not in SHARED_KEYS and isinstance(v, (np.ndarray, torch.Tensor, list))
              and len(v) == bs):
            v = v[rows]
        out[k] = v
    return out


def assert_no_large_collective(traffic: Dict[str, Dict[str, int]], max_elems: int,
                               exempt: Sequence[str] = ("grads",)) -> None:
    """The counterpart of `assert_no_large_allgather`: raise if a collective
    counted in `traffic` (`collectives.read()`) sent a tensor of max_elems
    elements or more. Pass one rank's feats shard: a collective that large
    moves bag-sized data between ranks. The gradient buffer is exempt (its
    size is the model's)."""
    big = {k: v["max_numel"] for k, v in traffic.items()
           if k not in exempt and v["max_numel"] >= max_elems}
    if big:
        raise AssertionError(f"collectives moved bag-sized tensors {big} "
                             f"(threshold {max_elems} elements)")

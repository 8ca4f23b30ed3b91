"""Device selection for the port's entry points.

Every entry point runs on the GPU unless the caller asks for the CPU. A
missing GPU is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def full_precision_matmul() -> None:
    """No TF32 anywhere: float32 products run in full float32, as the JAX
    package's Precision.HIGHEST does (abmil.py dot_precision). The f32 MLP
    ahead of the gated_pool kernel relies on it for <=1e-4 parity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and absent;
    the CPU is used only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        _expandable_segments()
    full_precision_matmul()
    return dev


def _expandable_segments() -> None:
    """Let the caching allocator grow its segments in place
    (`expandable_segments`), unless PYTORCH_CUDA_ALLOC_CONF says otherwise.
    A full-bag run changes bucket from batch to batch, and the whole-encoder
    op's blocks of whole bags each want buffers of tens of GB (ops/
    encoder_train.py): with fixed segments the buffers freed at one size sit
    cached in segments a little too small for the next (on an H100 80GB, a
    step at bucket 32768 after one at 16384 ran out of memory with 15 GiB
    reserved but unallocated)."""
    if "PYTORCH_CUDA_ALLOC_CONF" not in os.environ:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")

"""Classification heads on slide embeddings: MLP and ProjHead (ref:
Model.py:218-312).

PyTorch counterpart of `madeleine_tpu/models/heads.py`, for users who
fine-tune a head on top of slide embeddings (`models/madeleine.py::encode_he`).
Block structure: [Linear -> LayerNorm -> ReLU -> Dropout(0.2)] x2 -> Linear
(MLP) and [Linear -> LayerNorm -> ReLU -> Dropout(0.2) -> Linear] (ProjHead).
Parameter names are the JAX package's (`fc1`, `ln1`, `fc2`, `ln2`, `out`);
`models/factory.py::heads_params_from_jax` carries its trees across, and
`models/madeleine.py::init_madeleine` gives fresh weights from a generator.

In training (``train=True`` with a seed) each dropout is the standalone
dropout op (ops/dropout.py: row 21 on a CUDA tensor), one Philox stream per
dropout site, as the JAX package splits its key per layer (heads.py:45);
without a seed, or with ``train=False``, there is no dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from madeleine_torch.models.abmil import layer_norm
from madeleine_torch.ops.dropout import dropout

HEAD_DROPOUT = 0.2  # ref: Model.py:261,297


class MLP(nn.Module):
    """fc1/ln1, fc2/ln2 (input_dim -> input_dim), out (input_dim -> output_dim)."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, input_dim)
        self.ln1 = nn.LayerNorm(input_dim)
        self.fc2 = nn.Linear(input_dim, input_dim)
        self.ln2 = nn.LayerNorm(input_dim)
        self.out = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor, *, seed: Optional[int] = None,
                train: bool = False) -> torch.Tensor:
        return mlp_forward(self, x, seed=seed, train=train)


class ProjHead(nn.Module):
    """fc1/ln1 (input_dim -> input_dim), out (input_dim -> output_dim)."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(input_dim, input_dim)
        self.ln1 = nn.LayerNorm(input_dim)
        self.out = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor, *, seed: Optional[int] = None,
                train: bool = False) -> torch.Tensor:
        return proj_head_forward(self, x, seed=seed, train=train)


def _block(fc: nn.Linear, ln: nn.LayerNorm, x: torch.Tensor, seed: Optional[int],
           site: int) -> torch.Tensor:
    """Linear -> LayerNorm (f32 statistics) -> ReLU -> dropout (with a seed)."""
    x = F.relu(layer_norm(F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype)),
                          ln.weight, ln.bias))
    return x if seed is None else dropout(x, HEAD_DROPOUT, seed, site=site)


def mlp_forward(head: MLP, x: torch.Tensor, *, seed: Optional[int] = None,
                train: bool = False) -> torch.Tensor:
    """(ref: Model.py:239-276) x [..., input_dim] -> [..., output_dim] in x.dtype;
    dropout sites 0 and 1 in training."""
    seed = seed if train else None
    x = _block(head.fc1, head.ln1, x, seed, 0)
    x = _block(head.fc2, head.ln2, x, seed, 1)
    return F.linear(x, head.out.weight.to(x.dtype), head.out.bias.to(x.dtype))


def proj_head_forward(head: ProjHead, x: torch.Tensor, *, seed: Optional[int] = None,
                      train: bool = False) -> torch.Tensor:
    """(ref: Model.py:279-312) x [..., input_dim] -> [..., output_dim] in x.dtype;
    dropout site 0 in training."""
    x = _block(head.fc1, head.ln1, x, seed if train else None, 0)
    return F.linear(x, head.out.weight.to(x.dtype), head.out.bias.to(x.dtype))

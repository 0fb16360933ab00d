"""Plain PyTorch interactions, the ground truth for the CUDA kernels and the
path a CPU tensor takes: the DLRM dot interaction (``csrc/dot_interaction.cu``)
and the FM bi-interaction (``csrc/fm_interaction.cu``)."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def tril_pairs(f: int, self_interaction: bool) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of the packed lower triangle, in ``np.tril_indices``
    row-major order: row i holds columns 0..i-1 (0..i with the diagonal)."""
    return np.tril_indices(f, k=0 if self_interaction else -1)


def num_pairs(f: int, self_interaction: bool) -> int:
    return f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2


def dot_interaction(x: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """(B, F, D) f32 or bf16 -> (B, P) f32: the lower triangle of each
    example's Gram matrix X·Xᵀ, accumulated in f32."""
    xf = x.float()
    gram = torch.bmm(xf, xf.transpose(1, 2))
    rows, cols = tril_pairs(x.shape[1], self_interaction)
    idx = torch.as_tensor(rows * x.shape[1] + cols, device=x.device)
    return gram.reshape(x.shape[0], -1).index_select(1, idx)


def fm_pairwise_vector(x: torch.Tensor) -> torch.Tensor:
    """(B, F, D) f32 or bf16 -> (B, D) f32 bi-interaction pooling,
    0.5·((Σ_f x)² − Σ_f x²), both sums accumulated in f32."""
    xf = x.float()
    s = xf.sum(dim=1)
    return 0.5 * (s * s - (xf * xf).sum(dim=1))


def fm_pairwise(x: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B,) f32: the FM second-order term, the bi-interaction
    summed over D."""
    return fm_pairwise_vector(x).sum(dim=-1)

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


# csrc/dot_interaction.cu's shared-memory budget (opt-in, a block's most)
DOT_SMEM_BYTES = 227 * 1024


def dot_example_bytes(f: int, d: int, self_interaction: bool) -> int:
    """Shared memory one example takes in the dot-interaction kernel: its
    rows padded to a multiple of 4, each row D padded to a multiple of 4 f32
    values, an odd count of 16-byte chunks an example, then its P f32
    outputs (``example_bytes`` in ``csrc/dot_interaction.cu``)."""
    fp, d4 = -(-f // 4) * 4, -(-d // 4) * 4
    return (4 * ((fp * d4 // 4) | 1) + num_pairs(f, self_interaction)) * 4


def dot_in_domain(f: int, d: int, self_interaction: bool) -> bool:
    """Whether the kernel takes (F, D): at least one pair, and one example
    within shared memory; the mirror of ``dot_interaction_tile``."""
    return (f >= 1 and d >= 1 and num_pairs(f, self_interaction) >= 1
            and dot_example_bytes(f, d, self_interaction) <= DOT_SMEM_BYTES)


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

"""Plain PyTorch fused-MLP forward and backward: the ground truth for the
CUDA kernels ``csrc/mlp_fwd.cu`` and ``csrc/mlp_bwd.cu`` and the path a CPU
tensor takes; and :func:`pack_weight_tiles`, the plain version of the
kernels' pre-pass, with the layout it writes (:func:`chain_steps`).

It repeats the rounding of the TPU kernel's body (recsys_tpu's
``kernels/pallas/mlp_tpu.py::_fwd_kernel``): the input is cast to the
matmul dtype; each layer is ``z = h @ W`` accumulated in f32 plus the f32
bias, relu on every layer but the last; and every layer's output, the last
one included, is rounded to the matmul dtype before the final ``.float()``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

# The bf16 chains' packed weight tiles (csrc/mlp_tiles.cuh): TILE_K x
# TILE_N values, k-major, each row padded to TILE_LD with zeros; a chain
# step holds CHUNK column tiles' accumulators at a time.
TILE_K, TILE_N, TILE_LD, CHUNK = 64, 128, 136, 4
# The backward's dW pass (csrc/mlp_bwd.cu, kernel B) owns DW_TILE x DW_TILE
# tiles of a dW_i.
DW_TILE = 128


def mlp_forward(x: torch.Tensor, ws: Sequence[torch.Tensor],
                bs: Sequence[torch.Tensor], mm_bf16: bool = True) -> torch.Tensor:
    """x (B, D0) f32; ws [(D_{i-1}, D_i)] f32; bs [(D_i,)] f32 -> (B, D_k) f32."""
    mm = torch.bfloat16 if mm_bf16 else torch.float32
    h = x.to(mm)
    for i, (w, b) in enumerate(zip(ws, bs)):
        # bf16 x bf16 products are exact in f32, so the f32 matmul of the
        # rounded operands is the f32-accumulated bf16 product
        z = torch.mm(h.float(), w.to(mm).float()) + b.reshape(-1).float()
        if i < len(ws) - 1:
            z = torch.relu(z)
        h = z.to(mm)
    return h.float()


def mlp_backward(x: torch.Tensor, g: torch.Tensor, ws: Sequence[torch.Tensor],
                 bs: Sequence[torch.Tensor], mm_bf16: bool = True):
    """Gradients of :func:`mlp_forward` given the output cotangent ``g``
    (B, D_k) f32 -> (dx (B, D0) f32, [dW_i (D_{i-1}, D_i) f32],
    [db_i f32 shaped like b_i]).

    It repeats the rounding of the TPU kernel's body (``_bwd_kernel``): the
    hidden layers are recomputed as the forward does, each rounded to the
    matmul dtype; ``dh = g`` is rounded; walking the layers in reverse,
    below the last layer ``dh`` is masked by ``h_{i+1} > 0`` and rounded,
    then ``dW_i = h_iᵀ·dh`` and ``db_i = Σ dh`` in f32, then
    ``dh = dh·W_iᵀ`` in f32, rounded."""
    mm = torch.bfloat16 if mm_bf16 else torch.float32
    n = len(ws)
    hs = [x.to(mm)]
    for i in range(n - 1):  # the last layer's output is not needed
        z = torch.mm(hs[-1].float(), ws[i].to(mm).float()) + bs[i].reshape(-1).float()
        hs.append(torch.relu(z).to(mm))
    dh = g.to(mm)
    dws, dbs = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            dh = (dh.float() * (hs[i + 1].float() > 0)).to(mm)
        dws[i] = torch.mm(hs[i].float().t(), dh.float())
        dbs[i] = dh.float().sum(0).reshape(bs[i].shape)
        dh = torch.mm(dh.float(), ws[i].to(mm).float().t()).to(mm)
    return dh.float(), dws, dbs


def chain_steps(dims: Sequence[int], backward: bool = False):
    """The products a bf16 chain kernel runs, in order, as (layer, K, N,
    transposed): the forward's W_0 .. W_{n-1}; the backward's recompute
    W_0 .. W_{n-2}, then W_{n-1}ᵀ .. W_0ᵀ."""
    n = len(dims) - 1
    fwd = [(i, dims[i], dims[i + 1], False) for i in range(n if not backward else n - 1)]
    if not backward:
        return fwd
    return fwd + [(i, dims[i + 1], dims[i], True) for i in range(n - 1, -1, -1)]


def tile_grid(k: int, n: int) -> tuple[int, int]:
    """(k tiles, n tiles) of a (k, n) weight."""
    return -(-k // TILE_K), -(-n // TILE_N)


def packed_tile_count(dims: Sequence[int], backward: bool = False) -> int:
    return sum(a * b for a, b in (tile_grid(k, n) for _, k, n, _ in chain_steps(dims, backward)))


def pack_weight_tiles(ws: Sequence[torch.Tensor], backward: bool = False) -> torch.Tensor:
    """(tiles, TILE_K, TILE_LD) bf16: the weights of :func:`chain_steps`,
    each rounded to bf16 (W_i, or W_iᵀ for a transposed step) and cut into
    TILE_K x TILE_N tiles, rows past K and columns past N zero; in a step,
    chunk by chunk of CHUNK column tiles, and in a chunk k tile by k tile,
    each with its column tiles in order.  What the CUDA pre-pass writes."""
    dims = [ws[0].shape[0], *(w.shape[1] for w in ws)]
    tiles = []
    for i, k, n, transposed in chain_steps(dims, backward):
        w = (ws[i].t() if transposed else ws[i]).to(torch.bfloat16)
        kt, nt = tile_grid(k, n)
        w = F.pad(w, (0, nt * TILE_N - n, 0, kt * TILE_K - k))
        w = w.reshape(kt, TILE_K, nt, TILE_N).permute(0, 2, 1, 3)  # (k tile, n tile, ...)
        for c0 in range(0, nt, CHUNK):
            chunk = w[:, c0:c0 + CHUNK].reshape(-1, TILE_K, TILE_N)
            tiles.append(F.pad(chunk, (0, TILE_LD - TILE_N)))
    return torch.cat(tiles)

"""Plain PyTorch fused embedding backward + optimizer update: the ground
truth for the CUDA kernels of ``csrc/embedding_update.cu`` and the path a
CPU tensor takes.

Both functions take the TPU kernels' own inputs (recsys_tpu's
``kernels/pallas/embedding_update_tpu.py::fused_bwd_adam`` and
``fused_bwd_rowwise_adagrad``) on the port's logical ``(V, D)`` tables,
that is with one vocab row per table row (pack 1):

- ``cot_sorted`` (nc·ch, D): the per-occurrence cotangent rows in host-prep
  order; ``ids2d`` (nc, ch) int32: their vocab ids, padded with the sentinel
  ``nb·block``; ``cptr`` (nb+1,) int32: block k owns chunks
  ``[cptr[k], cptr[k+1])``, its ids ascending and then the sentinel, as
  host prep sorts them (the CUDA kernel ends a walk at the first id past
  its block).  An occurrence adds to the gradient only when its id lies
  in the block whose chunks hold it, so sentinels and padding add
  nothing.
- The gradient is the f32 sum of the cotangent rows per id (duplicates
  sum, as a scatter-add).  With ``mm_bf16`` each row is first rounded to
  bf16, as the TPU kernel feeds its bf16 matmul.
- Every row is updated, touched or not: untouched rows see g = 0 and
  decay.  ``p`` may be f32 or bf16; the math is f32 and the optimizer
  state is always f32.

Both also take the TPU kernels' multi-stream and model-shard forms:

- ``streams`` > 1: ``cot_sorted``, ``ids2d`` and ``cptr`` hold ``streams``
  independently sorted streams one after the other (one a data rank under
  the local data contract), each of ``nc_s = nc / streams`` chunks and its
  own ``cptr`` segment; block k sums every stream's window in turn.
- ``shard_index`` s: the table ``p`` is the model shard of rows
  ``[s·V, (s+1)·V)`` of a table prepped with shard-aligned fences
  (``host_prep_group(shards=)``): its ids stay global, and its blocks'
  pointers are entries ``[s·nb, s·nb + nb]`` of each stream's segment.

The tables and the optimizer state are updated IN PLACE (the TPU kernel
aliases them to its outputs); nothing is returned.
"""
from __future__ import annotations

import numpy as np
import torch


def num_blocks(vp: int, block: int) -> int:
    return -(-vp // block)


def adam_corrections(step: int, b1: float, b2: float) -> tuple[float, float]:
    """Adam's bias corrections ``1/(1-b1^t)`` and ``1/(1-b2^t)`` in f32,
    as the TPU kernel's wrapper computes them outside the kernel."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(b1) ** t)),
            float(one / (one - np.float32(b2) ** t)))


def block_gradient(vp: int, cot_sorted: torch.Tensor, ids2d: torch.Tensor,
                   cptr: torch.Tensor, block: int, mm_bf16: bool, streams: int = 1,
                   shard_index: int = 0) -> torch.Tensor:
    """(vp, D) f32 gradient summed from the sorted cotangent chunks."""
    nc, ch = ids2d.shape
    d = cot_sorted.shape[1]
    nb = num_blocks(vp, block)
    ids = ids2d.reshape(-1).long() - shard_index * vp
    # the block whose chunk window (in its stream) holds each occurrence
    win = cptr.long().view(streams, -1)[:, shard_index * nb:shard_index * nb + nb + 1]
    chunk = torch.arange(nc // streams, device=ids.device).expand(streams, -1)
    owner = torch.searchsorted(win.contiguous(), chunk.contiguous(), right=True) - 1
    owner = owner.reshape(-1).repeat_interleave(ch)
    valid = (ids // block == owner) & (ids >= 0) & (ids < vp)
    rows = torch.where(valid, ids, vp)  # sentinels land in the dropped row vp
    cot = cot_sorted[: nc * ch]
    if mm_bf16:
        cot = cot.bfloat16()
    g = torch.zeros((vp + 1, d), dtype=torch.float32, device=cot.device)
    return g.index_add_(0, rows, cot.float())[:vp]


def fused_adam(p, m, v, cot_sorted, ids2d, cptr, step: int, *, block: int,
               lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               wd: float = 0.0, mm_bf16: bool = True, streams: int = 1,
               shard_index: int = 0) -> None:
    """One dense Adam step (decoupled weight decay ``wd``) on the table
    ``p`` (V, D) and its moments ``m``, ``v`` (V, D) f32, in place."""
    g = block_gradient(p.shape[0], cot_sorted, ids2d, cptr, block, mm_bf16, streams,
                       shard_index)
    c1, c2 = adam_corrections(step, b1, b2)
    p_cur = p.float()
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    upd = lr * (m_new * c1) / (torch.sqrt(v_new * c2) + eps)
    if wd:
        upd = upd + lr * (wd * p_cur)
    p.copy_((p_cur - upd).to(p.dtype))
    m.copy_(m_new)
    v.copy_(v_new)


def fused_rowwise_adagrad(p, acc, cot_sorted, ids2d, cptr, *, block: int,
                          lr: float, eps: float = 1e-8, wd: float = 0.0,
                          mm_bf16: bool = True, streams: int = 1,
                          shard_index: int = 0) -> None:
    """One rowwise AdaGrad step on ``p`` (V, D) with one f32 accumulator
    per row, ``acc`` (V,): ``acc += mean_d(g²)``,
    ``p -= lr·g/(sqrt(acc)+eps) + lr·wd·p``, in place."""
    g = block_gradient(p.shape[0], cot_sorted, ids2d, cptr, block, mm_bf16, streams,
                       shard_index)
    acc_new = acc + (g * g).sum(1) * (1.0 / g.shape[1])
    p_cur = p.float()
    upd = lr * g / (torch.sqrt(acc_new) + eps)[:, None]
    if wd:
        upd = upd + (lr * wd) * p_cur
    p.copy_((p_cur - upd).to(p.dtype))
    acc.copy_(acc_new)

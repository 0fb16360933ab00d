"""Plain PyTorch versions of the probe kernels (``csrc/adam_stream.cu``,
``csrc/perrow_walk.cu``, ``csrc/hot_gather.cu``), the functions of the JAX
package's probe kernels in ``recsys_tpu/tools/stream_probe.py`` and
``recsys_tpu/tools/gather_split_probe.py``.

* ``adam_stream_step_(p, m, v, g)`` -- elementwise Adam with no bias
  correction, in place over p, m and v; each operation rounds once.
* ``perrow_colsum(x)`` -- (n, W) -> (1, W), the column sums in serial row
  order, one row a step.
* ``hot_gather(hot, ids, pack)`` -- rows of a (H, pack·d) hot buffer by hot
  slot id ``slot·pack + sub``; a zero row for an id outside [0, H·pack).
"""
from __future__ import annotations

import torch

ADAM = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)  # the probe's constants


def adam_stream_step_(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor) -> None:
    """``m = b1·m + (1−b1)·g``, ``v = b2·v + (1−b2)·g·g``,
    ``p −= lr·m / (√v + eps)`` with the probe's constants ``ADAM``, in
    place, in the TPU kernel's order."""
    lr, b1, b2, eps = (ADAM[k] for k in ("lr", "b1", "b2", "eps"))
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    p.sub_(lr * m_new / (torch.sqrt(v_new) + eps))
    m.copy_(m_new)
    v.copy_(v_new)


def perrow_colsum(x: torch.Tensor) -> torch.Tensor:
    """(n, W) f32 -> (1, W) f32: ``acc = 0``, then ``acc += x[i]`` for each
    row in order, the serial walk of the TPU kernel."""
    acc = torch.zeros((1, x.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        acc += x[i:i + 1]
    return acc


def hot_gather(hot: torch.Tensor, ids: torch.Tensor, pack: int) -> torch.Tensor:
    """hot (H, pack·d) f32, ids int (any shape) -> (ids.numel(), d) f32:
    row ``id % pack`` of hot row ``id // pack``, zero for an id outside
    [0, H·pack)."""
    rows = hot.reshape(hot.shape[0] * pack, -1)  # (H·pack, d) logical rows
    flat = ids.reshape(-1).long()
    hit = (flat >= 0) & (flat < rows.shape[0])
    out = rows.index_select(0, torch.where(hit, flat, 0))
    return torch.where(hit[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))

"""Loss functions (the port's copy of recsys_tpu.train.losses, the parts
the DLRM and SASRec slices need)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, stable through ``logsigmoid``
    and computed in the logits' type."""
    labels = labels.to(logits.dtype)
    per_ex = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    return per_ex.mean()


def pairwise_bce(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """The NCF/SASRec objective: push positive logits up, negative ones
    down, ``-mean log σ(pos) - mean log(1 - σ(neg))`` through
    ``logsigmoid``.  pos (B,) or (B, L); neg (..., N).  With ``mask`` (the
    shape of pos; the all-position scheme) each mean runs over the masked
    positions only."""
    pos_term = -F.logsigmoid(pos_logits)
    neg_term = -F.logsigmoid(-neg_logits)
    if mask is None:
        return pos_term.mean() + neg_term.mean()
    m = mask.to(pos_term.dtype)
    pos_loss = (pos_term * m).sum() / m.sum().clamp_min(1.0)
    neg_m = m[..., None].expand_as(neg_term)
    return pos_loss + (neg_term * neg_m).sum() / neg_m.sum().clamp_min(1.0)

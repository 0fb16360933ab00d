"""Loss functions (the port's copy of recsys_tpu.train.losses, the parts
the DLRM, SASRec and YoutubeDNN slices need)."""
from __future__ import annotations

import numpy as np
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


def in_batch_sampled_softmax(query_embs: torch.Tensor, item_embs: torch.Tensor,
                             item_log_q: torch.Tensor | None = None,
                             temperature: float = 1.0) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction: query_embs (B, D) and
    item_embs (B, D), row i's item the positive of row i's query and every
    other row's a negative.  ``item_log_q`` (B,), each item's log sampling
    probability, is subtracted from its logit column so popular items are
    not over-penalised as negatives.  Logits in f32."""
    logits = (query_embs.float() @ item_embs.float().T) / temperature
    if item_log_q is not None:
        logits = logits - item_log_q[None, :]
    return F.cross_entropy(logits, torch.arange(logits.shape[0], device=logits.device))


def popularity_log_q(counts, smoothing: float = 1.0) -> torch.Tensor:
    """Per-item log sampling probability from positive counts (V,):
    ``log((counts + smoothing) / total)`` in f32, the ``item_log_q`` table of
    :func:`in_batch_sampled_softmax` (index it with the batch's item ids)."""
    if not isinstance(counts, torch.Tensor):
        counts = torch.from_numpy(np.asarray(counts, np.float32))
    counts = counts.to(torch.float32) + smoothing
    return counts.log() - counts.sum().log()

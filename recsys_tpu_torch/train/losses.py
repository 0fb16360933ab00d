"""Loss functions (the port's copy of recsys_tpu.train.losses): BCE on
logits and on probabilities, the weighted multi-task BCE, the pairwise
objective of NCF and SASRec, the in-batch and the explicit-negative
sampled softmax with logQ correction, the log-uniform sampler, and the
explicit l2 penalty."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, stable through ``logsigmoid``
    and computed in the logits' type."""
    labels = labels.to(logits.dtype)
    per_ex = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    return per_ex.mean()


def bce_probs(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Mean BCE on probabilities (ESMM's heads are products of sigmoids),
    each clipped to [eps, 1 - eps] before its log."""
    p = probs.clamp(eps, 1.0 - eps)
    labels = labels.to(p.dtype)
    return (-(labels * p.log() + (1.0 - labels) * (1.0 - p).log())).mean()


def multi_task_bce(outputs: dict, labels: dict) -> torch.Tensor:
    """Sum of per-task ``bce_with_logits`` losses over the keys of
    ``labels``."""
    total = 0.0
    for name, y in labels.items():
        total = total + bce_with_logits(outputs[name], y)
    return total


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


def log_uniform_candidates(generator: torch.Generator, num_items: int, shape,
                           offset: int = 0, device=None):
    """Log-uniform (Zipfian) negative ids, P(k) = log(1 + 1/(k + 1)) /
    log(num_items + 1) over the 0-based ids of a catalog sorted by
    descending frequency (the law of TF's LogUniformCandidateSampler), and
    ``log_p`` = log1p(1/(k + 1)) − log(num_items + 1), the JAX package's
    formula (which is not log P(k)).  ``offset=1`` shifts the ids past a
    pad row 0.  Draws from ``generator`` (the JAX package draws from a
    ``jax.random`` key: the law is the same, the draws are not).  Returns
    (ids int32, log_p float32) of ``shape``."""
    u = torch.rand(shape, generator=generator, device=device)
    log_n = math.log(num_items + 1.0)
    ids = (torch.exp(u * log_n) - 1.0).to(torch.int32).clamp(0, num_items - 1)
    return ids + offset, torch.log1p(1.0 / (ids + 1.0)) - log_n


def sampled_softmax(query_embs: torch.Tensor, pos_embs: torch.Tensor, neg_embs: torch.Tensor,
                    pos_log_q: torch.Tensor | None = None,
                    neg_log_q: torch.Tensor | None = None,
                    pos_ids: torch.Tensor | None = None, neg_ids: torch.Tensor | None = None,
                    temperature: float = 1.0) -> torch.Tensor:
    """Softmax cross-entropy over [positive, S sampled negatives] with logQ
    correction.  query/pos (B, D); neg (S, D) shared by the batch or (B, S,
    D) per example; ``*_log_q`` the log sampling probabilities, subtracted
    from the logits.  With ``pos_ids`` (B,) and ``neg_ids`` ((S,) or (B,
    S)), a negative equal to its example's positive (an accidental hit) is
    masked to -inf, as TF's ``remove_accidental_hits``.  Logits in f32."""
    pos_logit = (query_embs * pos_embs).sum(-1, keepdim=True) / temperature  # (B, 1)
    q = query_embs.float()
    neg_logits = (q @ neg_embs.float().T if neg_embs.dim() == 2
                  else torch.einsum("bd,bsd->bs", q, neg_embs.float())) / temperature
    if neg_log_q is not None:  # (S,) or (B, S)
        neg_logits = neg_logits - neg_log_q
    if pos_log_q is not None:
        pos_logit = pos_logit - pos_log_q[:, None]
    if pos_ids is not None and neg_ids is not None:
        hit = (neg_ids[None, :] if neg_ids.dim() == 1 else neg_ids) == pos_ids[:, None]
        neg_logits = neg_logits.masked_fill(hit, -torch.inf)
    logits = torch.cat([pos_logit.to(neg_logits.dtype), neg_logits], dim=1)
    return -F.log_softmax(logits, dim=-1)[:, 0].mean()


def l2_regularization(params, scale: float) -> torch.Tensor:
    """``scale`` times the sum of squares of every parameter of a module, or
    of every tensor of an iterable (the JAX ``l2_regularization`` over a
    params pytree; the reference's embed_reg / w_reg)."""
    tensors = list(params.parameters() if isinstance(params, torch.nn.Module) else params)
    if not tensors:
        return torch.zeros(())
    return scale * sum(t.square().sum() for t in tensors)

"""Masked scaled-dot-product attention, plain PyTorch.

Two semantics, as in the JAX package:

* :func:`sdpa` -- the materialised reference of
  ``recsys_tpu/kernels/attention.py``: logits divided by sqrt(d), masked
  logits set to ``NEG_INF``, a softmax over every key.  A query row whose
  keys are all masked softmaxes uniformly over its ``NEG_INF`` logits.
* :func:`flash_attention_fwd` / :func:`flash_attention_bwd` -- the plain
  versions of the flash kernels (``kernels/csrc/flash_attention_*.cu``),
  with the semantics of ``recsys_tpu/kernels/pallas/attention_tpu.py``:
  logits times ``1/sqrt(d)``, a (B, Sk) key-padding mask (nonzero = attend)
  and an optional causal mask ``q_index >= k_index``; a fully masked query
  row gives 0 and lse = ``NEG_INF``, and its gradients are 0.

:func:`materialised_attention` is the route of a head dim outside the flash
kernels' domain (:func:`flash_in_domain`): :func:`sdpa` with the flash
semantics for a row with no key.

The flash versions compute in f32 whatever the input type and return the
output (and the gradients) in the inputs' types, lse (B, H, Sq) in f32.
The backward is written out from P, lse and delta = rowsum(dO·O), the
formulas of the JAX backward kernels, not through autograd.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over the last two axes, (..., Sq, D) x (..., Sk, D); ``mask``
    broadcasts to (..., Sq, Sk), nonzero = attend."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / torch.tensor(d, dtype=torch.float32).sqrt()
    if mask is not None:
        logits = torch.where(mask.bool(), logits, NEG_INF)
    w = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = (w / w.sum(-1, keepdim=True)).to(v.dtype)
    return torch.matmul(w, v)


def flash_in_domain(head_dim: int) -> bool:
    """Whether the flash kernels take this head dim: a multiple of 8 in [8,
    128], where ``flash_attention_{fwd,bwd}_smem_bytes`` is not 0."""
    return 8 <= head_dim <= 128 and head_dim % 8 == 0


def materialised_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor | None = None,
                           causal: bool = False) -> torch.Tensor:
    """The route of a head dim the flash kernels do not take: :func:`sdpa`
    over the key-padding and causal masks combined (the JAX package's
    ``_full_mask``), with the flash semantics for a query row with no key
    to attend (0, where :func:`sdpa` averages every key).  q (B, H, Sq, D),
    k/v (B, H, Sk, D), mask (B, Sk) or None; the gradient is autograd's."""
    keep = keep_mask(mask, q.shape[2], k.shape[2], causal, q.device)
    out = sdpa(q, k, v, keep)
    if keep is None:
        return out
    return torch.where(keep.any(-1, keepdim=True), out, torch.zeros((), dtype=out.dtype))


def softmax_scale(d: int) -> float:
    """The flash kernels' logit scale, ``1/sqrt(d)`` as the JAX kernel
    computes it."""
    return 1.0 / (d ** 0.5)


def keep_mask(mask: torch.Tensor | None, sq: int, sk: int, causal: bool,
              device) -> torch.Tensor | None:
    """(B, 1, Sq, Sk) or (Sq, Sk) bool of the (query, key) pairs attended, or
    None when every pair is."""
    keep = None
    if mask is not None:
        keep = (mask != 0)[:, None, None, :]
    if causal:
        c = (torch.arange(sq, device=device)[:, None]
             >= torch.arange(sk, device=device)[None, :])
        keep = c if keep is None else keep & c
    return keep


def _scores(q, k, keep):
    """f32 logits (B, H, Sq, Sk) times 1/sqrt(d), masked ones ``NEG_INF``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * softmax_scale(q.shape[-1])
    return s if keep is None else torch.where(keep, s, NEG_INF)


def masked_fwd(q, k, v, keep):
    """:func:`flash_attention_fwd` for an explicit ``keep`` (a bool tensor
    broadcasting to (B, H, Sq, Sk), or None for all pairs)."""
    s = _scores(q, k, keep)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.where(l > 0, torch.matmul(p, v.float()) / l.clamp_min(1e-30), 0.0)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    return out.to(q.dtype), lse[..., 0]


def masked_bwd(q, k, v, keep, out, lse, do):
    """:func:`flash_attention_bwd` for an explicit ``keep``."""
    s = _scores(q, k, keep)
    lse = lse[..., None]
    p = torch.where((s > NEG_INF / 2) & (lse > NEG_INF / 2), torch.exp(s - lse), 0.0)
    do32 = do.float()
    delta = (do32 * out.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    ds = p * (torch.matmul(do32, v.float().transpose(-1, -2)) - delta)
    scale = softmax_scale(q.shape[-1])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None, causal: bool = False):
    """q (B, H, Sq, D), k/v (B, H, Sk, D), mask (B, Sk) or None ->
    (out (B, H, Sq, D) in q's dtype, lse (B, H, Sq) f32)."""
    return masked_fwd(q, k, v, keep_mask(mask, q.shape[2], k.shape[2], causal, q.device))


def flash_attention_bwd(q, k, v, mask, out, lse, do, causal: bool = False):
    """(dq, dk, dv) of :func:`flash_attention_fwd` for the output cotangent
    ``do``, from its residuals ``out`` and ``lse``; each in its input's
    dtype."""
    keep = keep_mask(mask, q.shape[2], k.shape[2], causal, q.device)
    return masked_bwd(q, k, v, keep, out, lse, do)

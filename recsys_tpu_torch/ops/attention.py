"""Attention modules: multi-head self-attention, DIN's target attention,
the SASRec transformer block, learned positional embeddings (the port's
copy of ``recsys_tpu/ops/attention.py``).

Layouts follow the JAX package: activations (B, S, D), heads split to
(B, H, S, D/H).  ``Linear.weight`` is the transpose of flax's
``Dense.kernel`` (``convert.sasrec_params_from_jax`` maps one to the
other); LayerNorm uses flax's epsilon, 1e-6.  Attention goes through
:func:`attention`: at a head dim the flash kernels take, ``dispatch.sdpa``
(the kernels on a CUDA tensor, their plain versions on a CPU tensor); at
any other, the materialised softmax, on every device.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.kernels import attention as attn_ref
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.ops.init import dense_init_

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D), contiguous for the kernels."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).permute(0, 2, 1, 3).contiguous()


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None, causal: bool = False) -> torch.Tensor:
    """Masked attention over (B, H, S, D), routed by the head dim alone:
    ``dispatch.sdpa`` (flash) where the kernels take it, else
    ``kernels/attention.py::materialised_attention``, the JAX package's XLA
    route, with a row that has no key to attend set to 0 on both routes.
    AutoInt's two heads over D = 8 (the JAX CLI's default) give head dim 4."""
    if attn_ref.flash_in_domain(q.shape[-1]):
        return dispatch.sdpa(q, k, v, mask, causal=causal)
    return attn_ref.materialised_attention(q, k, v, mask, causal)


class Dropout(nn.Module):
    """Inverted dropout, as flax's: in training, each element is kept with
    probability 1 − rate and scaled by 1/(1 − rate); in eval, the identity.
    The bits come from ``generator`` (a ``torch.Generator`` on the
    activations' device), which ``Trainer`` seeds from its ``seed``, never
    from the global RNG; with none set, the first training call makes one
    seeded 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            self.generator = torch.Generator(device=x.device).manual_seed(0)
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with learned projections and every option of
    the JAX class: ``model_dim`` (default the query's width), a projected
    residual with relu (``use_residual``, AutoInt's interacting layer), an
    output projection (``out_proj``) and ``causal``.  ``wq``, ``wk`` and
    ``wv`` have no bias; keys and values have the queries' width."""

    def __init__(self, in_dim: int, num_heads: int, model_dim: int | None = None,
                 use_residual: bool = True, out_proj: bool = False, causal: bool = False,
                 device=None):
        super().__init__()
        dim = model_dim or in_dim
        self.num_heads = num_heads
        self.use_residual = use_residual
        self.causal = causal
        self.wq = dense_init_(nn.Linear(in_dim, dim, bias=False, device=device))
        self.wk = dense_init_(nn.Linear(in_dim, dim, bias=False, device=device))
        self.wv = dense_init_(nn.Linear(in_dim, dim, bias=False, device=device))
        self.wo = dense_init_(nn.Linear(dim, dim, device=device)) if out_proj else None
        self.wr = (dense_init_(nn.Linear(in_dim, dim, device=device))
                   if use_residual and in_dim != dim else None)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor | None = None,
                v_in: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """q_in (B, Sq, in_dim), k_in/v_in (B, Sk, in_dim) (default: q_in,
        then k_in), mask (B, Sk) key padding (nonzero = attend) or None."""
        k_in = q_in if k_in is None else k_in
        v_in = k_in if v_in is None else v_in
        qh, kh, vh = (split_heads(w(t), self.num_heads)
                      for w, t in ((self.wq, q_in), (self.wk, k_in), (self.wv, v_in)))
        out = merge_heads(attention(qh, kh, vh, mask, causal=self.causal))
        if self.wo is not None:
            out = self.wo(out)
        if self.use_residual:
            res = q_in if self.wr is None else self.wr(q_in)
            out = F.relu(out + res)
        return out


class TargetAttention(nn.Module):
    """DIN's target attention over a padded behaviour sequence: each history
    row is scored against the candidate by an MLP over [q, k, q − k, q·k]
    (``hidden_units`` with sigmoid, then a linear score; ``layers`` holds
    them all, as flax's ``Dense_i``), the padding gets ``NEG_INF`` (−1e9, not −inf), and the softmax weights
    sum the history.  query (B, D), keys (B, L, D), mask (B, L) -> (B, D).
    A history that is all padding scores every row ``NEG_INF`` and so
    averages its pad rows with equal weights, as the JAX module does."""

    def __init__(self, dim: int, hidden_units: Sequence[int] = (32, 16), device=None):
        super().__init__()
        dims = [4 * dim, *hidden_units, 1]
        self.layers = nn.ModuleList(dense_init_(nn.Linear(a, b, device=device))
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        q = query[:, None, :].expand_as(keys)
        h = torch.cat([q, keys, q - keys, q * keys], dim=-1)
        for lin in self.layers[:-1]:
            h = torch.sigmoid(lin(h))
        scores = self.layers[-1](h)[..., 0]  # (B, L)
        scores = torch.where(mask.bool(), scores, attn_ref.NEG_INF)
        scores = scores - scores.max(dim=-1, keepdim=True).values
        e = scores.exp()
        weights = e / e.sum(dim=-1, keepdim=True)
        return torch.einsum("bl,bld->bd", weights.to(keys.dtype), keys)


class PositionalEmbedding(nn.Module):
    """A learned positional embedding (max_len, D) added to a (B, S, D)
    sequence."""

    def __init__(self, max_len: int, dim: int, device=None):
        super().__init__()
        self.pos = nn.Parameter(torch.randn(max_len, dim, device=device) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pos[None, : x.shape[1], :]


class TransformerBlock(nn.Module):
    """The SASRec encoder block: self-attention and a relu FFN of width
    ``ffn_dim or dim``, each followed by dropout and a post-LN residual."""

    def __init__(self, dim: int, num_heads: int = 1, ffn_dim: int | None = None,
                 dropout_rate: float = 0.2, causal: bool = False, device=None):
        super().__init__()
        ffn_dim = ffn_dim or dim
        self.attn = MultiHeadAttention(dim, num_heads, use_residual=False, causal=causal,
                                       device=device)
        self.drop_attn = Dropout(dropout_rate)
        self.ln0 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS, device=device)
        self.ffn0 = dense_init_(nn.Linear(dim, ffn_dim, device=device))
        self.ffn1 = dense_init_(nn.Linear(ffn_dim, dim, device=device))
        self.drop_ffn = Dropout(dropout_rate)
        self.ln1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.ln0(x + self.drop_attn(self.attn(x, x, x, mask)))
        h = self.ffn1(F.relu(self.ffn0(x)))
        return self.ln1(x + self.drop_ffn(h))

"""MIND: multi-interest retrieval with per-example dynamic routing (the
port's copy of ``recsys_tpu/models/match/mind.py``).

History item embeddings route into ``k_max`` interest capsules (B2I
routing, ``CapsuleRouting``), a user MLP maps each capsule, and
label-aware attention weighs the capsules against the target item
(softmax over capsules of (interest · item)^p).  Training scores the
attended user vector against in-batch items (sampled softmax); retrieval
scores every capsule against the catalog and merges the capsules' best
items.

The routing starts from fixed logits that the JAX module draws with
``jax.random.normal(PRNGKey(0), (1, K, L))``.  ``routing_logits``
recomputes that draw in numpy (threefry-2x32, the partitionable counter
layout, JAX's uniform-to-normal map), so both packages route from the
same start without JAX here.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import erfinv
from torch import nn

from recsys_tpu_torch.kernels import embedding as emb_ops
from recsys_tpu_torch.ops.mlp import MLP

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """The threefry-2x32 block cipher (20 rounds) of the counter words
    (x0, x1) under ``key``, as uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def routing_logits(k_max: int, length: int, seed: int = 0) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), (1, k_max, length))``
    as float32, without JAX: 32 random bits an element from threefry-2x32
    under the key (0, seed) on the element's flat index (high word 0, low
    word the index), the two output words XORed; the top 23 bits make a
    uniform on [nextafter(-1, 1), 1) in float32; the normal is
    sqrt(2)·erfinv of it (scipy's erfinv, in float64, where XLA evaluates a
    float32 polynomial: the two agree within 2e-5 up to |z| of about 4)."""
    n = k_max * length
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32((0, seed), np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    bits = b0 ^ b1
    one = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(1.0))
    u = np.maximum(lo, one * (np.float32(1.0) - lo) + lo)
    z = np.sqrt(2.0) * erfinv(u.astype(np.float64))
    return z.astype(np.float32).reshape(1, k_max, length)


def squash(s: torch.Tensor, dim: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """Capsule squash: keeps the direction, maps the norm into [0, 1)."""
    sq = s.square().sum(dim=dim, keepdim=True)
    return (sq / (1.0 + sq)) * s / torch.sqrt(sq + eps)


class CapsuleRouting(nn.Module):
    """Behaviour-to-interest routing: (B, L, D) histories and a (B, L) mask
    -> (B, K, D) capsules.  ``S`` (D, D), drawn N(0, 0.05²), maps the
    behaviours; the logits start from ``routing_logits(K, L)`` for every
    example and take ``iterations - 1`` updates on the behaviours with their
    gradient stopped; the last capsule computation alone carries it.  The
    softmax runs over the capsules, so a padded behaviour (its logits all
    -1e9) gets the weight 1/K in every capsule, as in the JAX module."""

    def __init__(self, dim: int, k_max: int = 4, iterations: int = 3, device=None):
        super().__init__()
        self.k_max = k_max
        self.iterations = iterations
        self.S = nn.Parameter(torch.randn(dim, dim, device=device) * 0.05)
        self._start = {}  # (L, device, dtype) -> the (1, K, L) starting logits

    def start_logits(self, length: int, device, dtype) -> torch.Tensor:
        key = (length, device, dtype)
        if key not in self._start:
            self._start[key] = torch.from_numpy(routing_logits(self.k_max, length)).to(
                device, dtype)
        return self._start[key]

    def forward(self, hist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        u_hat = torch.einsum("bld,de->ble", hist, self.S)
        real = (mask.to(hist.dtype) > 0)[:, None, :]  # (B, 1, L)
        neg = torch.tensor(-1e9, dtype=hist.dtype, device=hist.device)
        b = self.start_logits(hist.shape[1], hist.device, hist.dtype).expand(
            hist.shape[0], -1, -1)
        u_sg = u_hat.detach()
        for _ in range(self.iterations - 1):
            w = torch.softmax(torch.where(real, b, neg), dim=1)  # (B, K, L)
            caps = squash(torch.einsum("bkl,bld->bkd", w, u_sg))
            b = b + torch.einsum("bkd,bld->bkl", caps, u_sg)
        w = torch.softmax(torch.where(real, b, neg), dim=1)
        return squash(torch.einsum("bkl,bld->bkd", w, u_hat))


class LabelAwareAttention(nn.Module):
    """(B, K, D) capsules and (B, D) items -> (B, D): the capsules weighed by
    the softmax over K of max(capsule · item, 1e-9) ** ``pow_p``."""

    def __init__(self, pow_p: float = 2.0):
        super().__init__()
        self.pow_p = pow_p

    def forward(self, capsules: torch.Tensor, item: torch.Tensor) -> torch.Tensor:
        scores = torch.einsum("bkd,bd->bk", capsules, item)
        w = torch.softmax(scores.clamp_min(1e-9).pow(self.pow_p), dim=-1)
        return torch.einsum("bk,bkd->bd", w, capsules)


class MIND(nn.Module):
    """``num_items`` counts the pad id ``pad_id``; ``item_table``
    (num_items, embed_dim) is drawn N(0, 0.05²).  ``forward`` returns
    {'user', 'item', 'interests'}."""

    def __init__(self, num_items: int, embed_dim: int = 32, k_max: int = 4,
                 routing_iterations: int = 3, pow_p: float = 2.0,
                 user_units: Sequence[int] = (64,), pad_id: int = 0,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.num_items = num_items
        # item-id inputs, checked by Trainer
        self.id_vocabs = dict.fromkeys(("hist", "item_id"), num_items)
        self.embed_dim = embed_dim
        self.pad_id = pad_id
        self.item_table = nn.Parameter(torch.randn(num_items, embed_dim, device=device) * 0.05)
        self.routing = CapsuleRouting(embed_dim, k_max, routing_iterations, device=device)
        self.user_mlp = MLP(embed_dim, user_units, out_dim=embed_dim,
                            dropout_rate=dropout_rate, device=device)
        self.label_att = LabelAwareAttention(pow_p)

    def interests(self, batch: dict) -> torch.Tensor:
        """(B, K, D) interest capsules from the (B, L) history."""
        hist = batch["hist"]
        caps = self.routing(emb_ops.gather(self.item_table, hist), hist != self.pad_id)
        b, k, d = caps.shape
        return self.user_mlp(caps.reshape(b * k, d)).reshape(b, k, self.embed_dim)

    def item_embed(self, item_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(item_ids.long(), self.item_table)

    def all_item_embeddings(self) -> torch.Tensor:
        return self.item_table

    def forward(self, batch: dict) -> dict:
        caps = self.interests(batch)
        item = self.item_embed(batch["item_id"])
        return {"user": self.label_att(caps, item), "item": item, "interests": caps}

"""A latent-factor interaction log at MovieLens-protocol scale (the port's
copy of ``recsys_tpu/data/realistic.py::realistic_ratings``), in numpy
only: the ratings are a dict of columns (``user_id``, ``item_id``,
``rating``, ``timestamp``) instead of a pandas DataFrame.  It draws from its
generator in the JAX package's order, so the same seed gives the same
columns bit for bit.  ``return_meta`` (the side features DIN and DSSM use)
comes with those models.
"""
from __future__ import annotations

import numpy as np


def _zipf_probs(v: int, s: float, rng: np.random.Generator) -> np.ndarray:
    """Zipf pmf over v ids, rank order shuffled (ids are hash-like)."""
    p = 1.0 / np.arange(1, v + 1) ** s
    p /= p.sum()
    rng.shuffle(p)
    return p


def realistic_ratings(num_users: int = 100_000, num_items: int = 20_000,
                      mean_len: float = 26.0, min_len: int = 5, max_len: int = 200,
                      latent_dim: int = 16, affinity_scale: float = 4.0,
                      pop_scale: float = 1.0, zipf_s: float = 1.0,
                      drift_scale: float = 6.0, user_batch: int = 1024,
                      seed: int = 0) -> dict:
    """Ratings with collaborative, popularity and sequential structure.

    Users and items are unit vectors; a user's items are Gumbel-top-L draws
    from ``affinity_scale``·affinity + ``pop_scale``·log(Zipf popularity);
    each user's items are ordered by a global drift projection plus noise
    (so the next item is predictable from the history) and timestamped
    0..L-1; ratings 1-5 follow the affinity quantile.  Returns int64
    columns, users 1-based, items 1-based, one row per event."""
    rng = np.random.default_rng(seed)
    u_vec = rng.normal(0, 1, (num_users, latent_dim))
    u_vec /= np.linalg.norm(u_vec, axis=1, keepdims=True)
    v_vec = rng.normal(0, 1, (num_items, latent_dim))
    v_vec /= np.linalg.norm(v_vec, axis=1, keepdims=True)
    log_pop = np.log(_zipf_probs(num_items, zipf_s, rng) + 1e-12)

    lengths = np.clip(
        rng.lognormal(np.log(mean_len) - 0.18, 0.6, num_users), min_len, max_len
    ).astype(np.int64)

    drift_dir = rng.normal(0, 1, latent_dim)
    drift_dir /= np.linalg.norm(drift_dir)
    item_drift = v_vec @ drift_dir  # global "time axis" over items

    users_out, items_out, ratings_out, ts_out = [], [], [], []
    for start in range(0, num_users, user_batch):
        ub = u_vec[start:start + user_batch]
        lb = lengths[start:start + ub.shape[0]]
        aff = ub @ v_vec.T * affinity_scale
        scores = aff + pop_scale * log_pop[None, :]
        scores += rng.gumbel(0, 1.0, scores.shape)
        k = int(lb.max())
        top = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        for r in range(ub.shape[0]):
            n = int(lb[r])
            sel = top[r, :n]
            order = np.argsort(item_drift[sel] * drift_scale + rng.normal(0, 1.0, n),
                               kind="mergesort")
            sel = sel[order]
            a = aff[r, sel]
            # affinity quantile -> rating 1..5
            q = (a - a.min()) / (a.max() - a.min() + 1e-9)
            rating = 1 + np.minimum(4, (q * 4 + rng.random(n)).astype(np.int64))
            users_out.append(np.full(n, start + r + 1, np.int64))
            items_out.append(sel + 1)
            ratings_out.append(rating)
            ts_out.append(np.arange(n, dtype=np.int64))
    return {"user_id": np.concatenate(users_out),
            "item_id": np.concatenate(items_out).astype(np.int64),
            "rating": np.concatenate(ratings_out),
            "timestamp": np.concatenate(ts_out)}

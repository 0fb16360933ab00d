"""Distribution-realistic synthetic datasets at the reference protocols'
scale (the port's copy of ``recsys_tpu/data/realistic.py``), in numpy only:

* ``realistic_criteo``: Criteo-shaped CTR rows, Zipfian categories at the
  Criteo vocabularies, heavy-tailed dense features and a planted logistic
  teacher, with the teacher's oracle AUC;
* ``realistic_ratings``: a latent-factor interaction log at MovieLens
  scale, as a dict of columns (``user_id``, ``item_id``, ``rating``,
  ``timestamp``) instead of a pandas DataFrame; ``return_meta`` adds the
  side features the two-tower models use.

Each draws from its generator in the JAX package's order, so the same seed
gives the same arrays bit for bit.
"""
from __future__ import annotations

import numpy as np

from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema, SparseFeature

# 26 categorical vocabulary sizes of the Criteo sample's magnitudes: a few
# hashed fields of 100k+ ids, mid-size fields of 1k-60k and tiny enums
CRITEO_VOCABS = (
    1460, 583, 250_000, 100_000, 305, 24, 12_000, 633, 3, 60_000,
    5_000, 200_000, 3_194, 27, 14_000, 150_000, 10, 5_652, 2_173, 4,
    240_000, 15, 16, 50_000, 105, 80_000,
)


def _zipf_probs(v: int, s: float, rng: np.random.Generator) -> np.ndarray:
    """Zipf pmf over v ids, rank order shuffled (ids are hash-like)."""
    p = 1.0 / np.arange(1, v + 1) ** s
    p /= p.sum()
    rng.shuffle(p)
    return p


def realistic_criteo(num_examples: int = 1_000_000, embed_dim: int = 16,
                     vocabs: tuple = CRITEO_VOCABS, num_dense: int = 13,
                     target_ctr: float = 0.25, signal_std: float = 1.6,
                     zipf_s: float = 1.05, latent_dim: int = 4, seed: int = 0,
                     teacher: str = "fm"):
    """Criteo-shaped CTR data: Zipfian categories at ``vocabs``, lognormal
    dense counters min-max scaled per column, and a planted logistic teacher
    scaled to ``signal_std`` with its intercept set for ``target_ctr``.

    ``teacher='fm'``: first-order per-id weights, FM-style pairwise dots of
    per-id latent vectors and a dense linear term (plain FM is the Bayes
    form).  ``teacher='mlp'``: a random 2-layer tanh MLP over the
    concatenated field latents and dense features plus a weak first-order
    term, which FM cannot represent.

    Returns ``(schema, data, meta)``: ``data`` holds ``dense`` (N, 13) f32,
    ``sparse`` (N, 26) int32 and ``label`` (N,) f32; ``meta`` the true
    probability ``p_true``, the positive rate ``ctr`` and the teacher's
    ``oracle_auc``, the ceiling any model can reach."""
    rng = np.random.default_rng(seed)
    f = len(vocabs)
    sparse = np.empty((num_examples, f), np.int32)
    for j, v in enumerate(vocabs):
        probs = _zipf_probs(v, zipf_s, rng)
        sparse[:, j] = rng.choice(v, size=num_examples, p=probs)

    raw = rng.lognormal(mean=1.0, sigma=1.5, size=(num_examples, num_dense))
    dense = (raw - raw.min(0)) / (raw.max(0) - raw.min(0) + 1e-9)
    dense = dense.astype(np.float32)

    if teacher == "fm":
        logit = np.zeros(num_examples, np.float64)
        z_sum = np.zeros((num_examples, latent_dim), np.float64)
        z_sq = np.zeros(num_examples, np.float64)
        for j, v in enumerate(vocabs):
            field_scale = 1.0 / np.sqrt(1.0 + j % 7)
            w = rng.normal(0.0, field_scale, v)
            logit += w[sparse[:, j]]
            z = rng.normal(0.0, field_scale / np.sqrt(latent_dim), (v, latent_dim))
            zj = z[sparse[:, j]]
            z_sum += zj
            z_sq += np.einsum("nk,nk->n", zj, zj)
        inter = 0.5 * (np.einsum("nk,nk->n", z_sum, z_sum) - z_sq)
        w_dense = rng.normal(0.0, 1.0, num_dense)
        logit += 1.5 * inter + dense @ w_dense
    elif teacher == "mlp":
        f_in = len(vocabs) * latent_dim + num_dense
        x = np.empty((num_examples, f_in), np.float32)
        logit = np.zeros(num_examples, np.float64)
        for j, v in enumerate(vocabs):
            field_scale = 1.0 / np.sqrt(1.0 + j % 7)
            logit += 0.3 * rng.normal(0.0, field_scale, v)[sparse[:, j]]
            z = rng.normal(0.0, field_scale, (v, latent_dim))
            x[:, j * latent_dim:(j + 1) * latent_dim] = z[sparse[:, j]]
        x[:, -num_dense:] = dense
        h = 64
        w1 = rng.normal(0, 1.0 / np.sqrt(f_in), (f_in, h))
        w2 = rng.normal(0, 1.0 / np.sqrt(h), (h, h))
        w3 = rng.normal(0, 1.0 / np.sqrt(h), (h, 1))
        a = np.tanh(x @ w1)
        a = np.tanh(a @ w2)
        logit += 3.0 * (a @ w3)[:, 0]
        del x, a
    else:
        raise ValueError(f"unknown teacher {teacher!r}")

    logit = signal_std * (logit - logit.mean()) / (logit.std() + 1e-12)
    # intercept for the target positive rate: bisection on mean(sigmoid)
    lo, hi = -20.0, 20.0
    for _ in range(50):
        c = 0.5 * (lo + hi)
        if (1.0 / (1.0 + np.exp(-(logit + c)))).mean() < target_ctr:
            lo = c
        else:
            hi = c
    logit += 0.5 * (lo + hi)
    p_true = 1.0 / (1.0 + np.exp(-logit))
    label = (rng.random(num_examples) < p_true).astype(np.float32)

    schema = FeatureSchema(
        dense=[DenseFeature(f"I{i}") for i in range(num_dense)],
        sparse=[SparseFeature(f"C{i}", int(v), embed_dim) for i, v in enumerate(vocabs)],
    )
    data = {"dense": dense, "sparse": sparse, "label": label}
    meta = {"p_true": p_true.astype(np.float32), "ctr": float(label.mean()),
            "oracle_auc": _auc(label, p_true)}
    return schema, data, meta


def _auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact rank AUC, tied scores sharing their average rank."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    s_sorted = scores[order]
    _, inv, counts = np.unique(s_sorted, return_inverse=True, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    avg = starts + (counts + 1) / 2.0
    ranks[order] = avg[inv]
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def realistic_ratings(num_users: int = 100_000, num_items: int = 20_000,
                      mean_len: float = 26.0, min_len: int = 5, max_len: int = 200,
                      latent_dim: int = 16, affinity_scale: float = 4.0,
                      pop_scale: float = 1.0, zipf_s: float = 1.0,
                      drift_scale: float = 6.0, user_batch: int = 1024,
                      seed: int = 0, return_meta: bool = False, num_cates: int = 200,
                      num_occupations: int = 21):
    """Ratings with collaborative, popularity and sequential structure.

    Users and items are unit vectors; a user's items are Gumbel-top-L draws
    from ``affinity_scale``·affinity + ``pop_scale``·log(Zipf popularity);
    each user's items are ordered by a global drift projection plus noise
    (so the next item is predictable from the history) and timestamped
    0..L-1; ratings 1-5 follow the affinity quantile.  Returns int64
    columns, users 1-based, items 1-based, one row per event.

    ``return_meta=True`` returns (columns, meta): side features drawn after
    the ratings from the same latent vectors, so they carry signal:
    ``item_cate`` (num_items + 1,) int32 in [1, num_cates], the nearest of
    ``num_cates`` random directions (0 the pad); ``user_age_bin`` in [1, 7],
    ``user_gender`` in {1, 2} and ``user_occupation`` in [1,
    num_occupations], each (num_users + 1,) int32, quantised projections of
    the user vectors; ``num_cates`` and ``num_occupations`` as vocabulary
    sizes (one more than the largest id)."""
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
    cols = {"user_id": np.concatenate(users_out),
            "item_id": np.concatenate(items_out).astype(np.int64),
            "rating": np.concatenate(ratings_out),
            "timestamp": np.concatenate(ts_out)}
    if not return_meta:
        return cols
    cat_dirs = rng.normal(0, 1, (latent_dim, num_cates))
    item_cate = np.zeros(num_items + 1, np.int32)
    item_cate[1:] = np.argmax(v_vec @ cat_dirs, axis=1) + 1
    age_proj = u_vec @ rng.normal(0, 1, latent_dim)
    qs = np.quantile(age_proj, np.linspace(0, 1, 8)[1:-1])
    occ_dirs = rng.normal(0, 1, (latent_dim, num_occupations))
    meta = {
        "item_cate": item_cate,
        "num_cates": num_cates + 1,
        "user_age_bin": np.concatenate([[0], np.digitize(age_proj, qs) + 1]).astype(np.int32),
        "user_gender": np.concatenate(
            [[0], (u_vec @ rng.normal(0, 1, latent_dim) > 0) + 1]).astype(np.int32),
        "user_occupation": np.concatenate(
            [[0], np.argmax(u_vec @ occ_dirs, axis=1) + 1]).astype(np.int32),
        "num_occupations": num_occupations + 1,
    }
    return cols, meta

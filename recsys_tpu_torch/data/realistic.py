"""Distribution-realistic synthetic datasets at the reference protocols'
scale (the port's copy of ``recsys_tpu/data/realistic.py``), in numpy only:

* ``realistic_criteo``: Criteo-shaped CTR rows, Zipfian categories at the
  Criteo vocabularies, heavy-tailed dense features and a planted logistic
  teacher, with the teacher's oracle AUC;
* ``realistic_ratings``: a latent-factor interaction log at MovieLens
  scale, as a dict of columns (``user_id``, ``item_id``, ``rating``,
  ``timestamp``) instead of a pandas DataFrame; ``return_meta`` adds the
  side features the two-tower models use;
* ``build_ncf_dataset_fast`` and ``build_din_dataset_fast``: the NCF and
  DIN protocols' splits and negatives from such a log, vectorised;
* ``realistic_multitask``: click and conversion labels on Criteo-shaped
  rows with a shared planted structure (ESMM, MMoE, PLE);
* ``realistic_census``: census-income-format columns with two planted
  tasks, for ``data/census.py``'s loader.

Each draws from its generator in the JAX package's order, so the same seed
gives the same arrays bit for bit.
"""
from __future__ import annotations

import numpy as np

from recsys_tpu_torch.core.features import (DenseFeature, FeatureSchema, SparseFeature,
                                            VarLenSparseFeature)

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


def _true_negatives(rng: np.random.Generator, pos_key: np.ndarray, num_items: int,
                    low: int, users: np.ndarray, n: int) -> np.ndarray:
    """(len(users), n) int32 ids in [low, num_items) that each user never
    interacted with (``pos_key``: the sorted user·num_items + item keys),
    drawn by vectorised rejection as the JAX builders draw them."""
    out = rng.integers(low, num_items, (len(users), n), dtype=np.int64)
    base = users.astype(np.int64) * num_items
    for _ in range(64):
        key = (base[:, None] + out).ravel()
        idx = np.searchsorted(pos_key, key)
        hit = ((idx < len(pos_key)) & (pos_key[np.minimum(idx, len(pos_key) - 1)] == key)
               ).reshape(out.shape)
        n_bad = int(hit.sum())
        if n_bad == 0:
            return out.astype(np.int32)
        out[hit] = rng.integers(low, num_items, n_bad, dtype=np.int64)
    raise RuntimeError("negative sampling failed to converge")


def build_ncf_dataset_fast(ratings: dict, train_neg_num: int = 1, test_neg_num: int = 100,
                           trans_score: int = 1, seed: int = 2020):
    """The NCF protocol, vectorised: events rated ``trans_score`` or more,
    users and items renumbered 0.. in sorted order, each user's events in
    time order (users with fewer than 3 dropped); the last two items are
    the val and test positives, the rest train, each with its true
    negatives (``train_neg_num``, ``test_neg_num``).  Returns (num_users,
    num_items, train, val, test), each a dict of ``user`` (B,),
    ``pos_item`` (B,) and ``neg_item`` (B, N) int32."""
    rng = np.random.default_rng(seed)
    keep = np.asarray(ratings["rating"]) >= trans_score
    user = np.asarray(ratings["user_id"])[keep]
    item = np.asarray(ratings["item_id"])[keep]
    ts = np.asarray(ratings["timestamp"])[keep]
    u_ids, i_ids = np.unique(user), np.unique(item)
    u, i = np.searchsorted(u_ids, user), np.searchsorted(i_ids, item)
    num_users, num_items = len(u_ids), len(i_ids)

    order = np.lexsort((ts, u))
    u, i = u[order], i[order]
    uniq, starts, counts = np.unique(u, return_index=True, return_counts=True)
    keep = counts >= 3  # users with fewer than 3 interactions are dropped
    uniq, starts, counts = uniq[keep], starts[keep], counts[keep]
    ends = starts + counts
    pos_key = np.sort(u.astype(np.int64) * num_items + i)

    tr_users = np.repeat(uniq, counts - 2)
    tr_idx = np.concatenate([np.arange(s, e - 2) for s, e in zip(starts, ends)])

    def split(users, pos, n):
        return {"user": users.astype(np.int32), "pos_item": pos.astype(np.int32),
                "neg_item": _true_negatives(rng, pos_key, num_items, 0, users, n)}

    train = split(tr_users, i[tr_idx], train_neg_num)
    val = split(uniq, i[ends - 2], test_neg_num)
    test = split(uniq, i[ends - 1], test_neg_num)
    return num_users, num_items, train, val, test


def build_din_dataset_fast(ratings: dict, item_cate: np.ndarray, num_cates: int,
                           maxlen: int = 40, embed_dim: int = 8, seed: int = 2020,
                           max_train_positions: int | None = None):
    """The DIN (Amazon-Electronics) protocol, vectorised: each user's
    events in time order (users with fewer than 3 dropped); every position
    t >= 1 gives a positive (its item) and one true negative, both with the
    history of the ``maxlen`` items before t, front-padded with 0; the last
    position goes to test, the one before to val, the rest to train (the
    most recent ``max_train_positions`` a user, where given).  Items are
    1-based (0 the pad); ``item_cate`` (num_items,) maps an item to its
    category.  Returns (schema, train, val, test), each split {'sparse':
    (B, 2) [item, category], 'hist': (B, L), 'hist_cate': (B, L), 'label':
    (B,)}, a positive then its negative."""
    rng = np.random.default_rng(seed)
    u = np.asarray(ratings["user_id"])
    i = np.asarray(ratings["item_id"]).astype(np.int64)
    ts = np.asarray(ratings["timestamp"])
    num_items = int(item_cate.shape[0])  # the pad slot included

    order = np.lexsort((ts, u))
    u, items = u[order], i[order].astype(np.int32)
    uniq, starts, counts = np.unique(u, return_index=True, return_counts=True)
    keep = counts >= 3
    uniq, starts, counts = uniq[keep], starts[keep], counts[keep]
    ends = starts + counts
    pos_key = np.sort(u.astype(np.int64) * num_items + items)

    def positions(kind):
        """(user row, global position of the target) of each example."""
        if kind == "test":
            return np.arange(len(uniq)), ends - 1
        if kind == "val":
            return np.arange(len(uniq)), ends - 2
        # train targets t = 1 .. L-3, the most recent max_train_positions
        reps = counts - 3
        if max_train_positions is not None:
            reps = np.minimum(reps, max_train_positions)
        urow = np.repeat(np.arange(len(uniq)), reps)
        offs = (np.concatenate([np.arange(r) for r in reps])
                if len(reps) else np.zeros(0, np.int64))
        t = (counts - 2)[urow] - reps[urow] + offs
        return urow, starts[urow] + t

    def build(kind):
        urow, tpos = positions(kind)
        m = len(urow)
        win = np.arange(maxlen)[None, :] + (tpos - maxlen)[:, None]
        valid = win >= starts[urow][:, None]
        hist = np.where(valid, items[np.maximum(win, 0)], 0).astype(np.int32)
        negs = _true_negatives(rng, pos_key, num_items, 1, uniq[urow], 1)[:, 0]
        sparse = np.empty((2 * m, 2), np.int32)
        sparse[0::2, 0] = items[tpos]
        sparse[1::2, 0] = negs
        sparse[:, 1] = item_cate[sparse[:, 0]]
        hist2 = np.repeat(hist, 2, axis=0)
        return {"sparse": sparse, "hist": hist2,
                "hist_cate": item_cate[hist2].astype(np.int32),
                "label": np.tile(np.asarray([1.0, 0.0], np.float32), m)}

    return din_schema(num_items, num_cates, embed_dim, maxlen), \
        build("train"), build("val"), build("test")


def din_schema(num_items: int, num_cates: int, embed_dim: int, maxlen: int) -> FeatureSchema:
    """DIN's schema: the candidate ``item`` and ``cate`` fields, and the
    histories ``hist_item`` and ``hist_cate`` sharing their tables."""
    return FeatureSchema(
        sparse=[SparseFeature("item", num_items, embed_dim),
                SparseFeature("cate", num_cates, embed_dim)],
        varlen=[VarLenSparseFeature("hist_item", num_items, embed_dim, max_len=maxlen,
                                    shared_with="item"),
                VarLenSparseFeature("hist_cate", num_cates, embed_dim, max_len=maxlen,
                                    shared_with="cate")])


def _calibrate(logit: np.ndarray, rate: float, signal_std: float) -> np.ndarray:
    """Probabilities from ``logit`` scaled to ``signal_std`` with the
    intercept (bisection) that gives a mean of ``rate``."""
    logit = signal_std * (logit - logit.mean()) / (logit.std() + 1e-12)
    lo, hi = -20.0, 20.0
    for _ in range(50):
        c = 0.5 * (lo + hi)
        if (1 / (1 + np.exp(-(logit + c)))).mean() < rate:
            lo = c
        else:
            hi = c
    return 1 / (1 + np.exp(-(logit + 0.5 * (lo + hi))))


def realistic_multitask(num_examples: int = 1_000_000, embed_dim: int = 16,
                        vocabs: tuple = CRITEO_VOCABS[:12], num_dense: int = 8,
                        target_ctr: float = 0.25, target_cvr: float = 0.15,
                        signal_std: float = 1.6, task_corr: float = 0.6, zipf_s: float = 1.05,
                        latent_dim: int = 4, seed: int = 0):
    """Two tasks on Criteo-shaped rows: click ~ Bern(p_ctr), conversion
    observed only on clicks (ESMM's entire space).  Both task logits share
    a planted component (weight ``task_corr``) beside their own.  Returns
    (schema, data, meta): ``data`` holds ``dense``, ``sparse``, ``click``
    and ``ctcvr`` (click · converted); ``meta`` the rates and both heads'
    oracle AUCs."""
    rng = np.random.default_rng(seed)
    f = len(vocabs)
    sparse = np.empty((num_examples, f), np.int32)
    for j, v in enumerate(vocabs):
        sparse[:, j] = rng.choice(v, size=num_examples, p=_zipf_probs(v, zipf_s, rng))
    raw = rng.lognormal(1.0, 1.5, (num_examples, num_dense))
    dense = ((raw - raw.min(0)) / (raw.max(0) - raw.min(0) + 1e-9)).astype(np.float32)

    def planted(seed_off):
        r = np.random.default_rng(seed + 1000 + seed_off)
        logit = np.zeros(num_examples, np.float64)
        z_sum = np.zeros((num_examples, latent_dim))
        z_sq = np.zeros(num_examples)
        for j, v in enumerate(vocabs):
            fs = 1.0 / np.sqrt(1.0 + j % 7)
            logit += r.normal(0, fs, v)[sparse[:, j]]
            zj = r.normal(0, fs / np.sqrt(latent_dim), (v, latent_dim))[sparse[:, j]]
            z_sum += zj
            z_sq += np.einsum("nk,nk->n", zj, zj)
        inter = 0.5 * (np.einsum("nk,nk->n", z_sum, z_sum) - z_sq)
        return logit + 1.5 * inter + dense @ r.normal(0, 1, num_dense)

    shared = planted(0)
    p_ctr = _calibrate(task_corr * shared + (1 - task_corr) * planted(1), target_ctr,
                       signal_std)
    p_cvr = _calibrate(task_corr * shared + (1 - task_corr) * planted(2), target_cvr,
                       signal_std)
    click = (rng.random(num_examples) < p_ctr).astype(np.float32)
    ctcvr = click * (rng.random(num_examples) < p_cvr).astype(np.float32)
    schema = FeatureSchema(
        dense=[DenseFeature(f"I{i}") for i in range(num_dense)],
        sparse=[SparseFeature(f"C{i}", int(v), embed_dim) for i, v in enumerate(vocabs)])
    data = {"dense": dense, "sparse": sparse, "click": click, "ctcvr": ctcvr}
    meta = {"ctr": float(click.mean()), "ctcvr_rate": float(ctcvr.mean()),
            "oracle_auc_ctr": _auc(click, p_ctr),
            "oracle_auc_ctcvr": _auc(ctcvr, p_ctr * p_cvr)}
    return schema, data, meta


def realistic_census(num_train: int = 200_000, num_test: int = 100_000,
                     target_income: float = 0.12, target_marital: float = 0.33,
                     signal_std: float = 1.4, task_corr: float = 0.5, seed: int = 0):
    """Census-income-format rows with two planted tasks (income over 50k,
    never married) over the same category assignments, sharing a component
    (weight ``task_corr``).  Returns (train, test, meta): ``train`` and
    ``test`` are dicts of the 42 ``census.COLUMNS`` in their order, numpy
    arrays as the JAX package's DataFrame columns hold them: the 7 dense
    columns int64, each categorical column strings " {column}_v{k}", a
    float ``instance_weight``, the income label " 50000+." or " - 50000."
    and ``marital_stat`` " Never married" or another status; ``meta`` the
    rates and the oracle AUC of each head."""
    from recsys_tpu_torch.data.census import (COLUMNS, DENSE_COLS, LABEL_INCOME,
                                              LABEL_MARITAL, SPARSE_COLS)

    rng = np.random.default_rng(seed)
    n = num_train + num_test
    # census-like small enum vocabularies (3..52 categories a column)
    vocabs = [int(v) for v in rng.integers(3, 53, len(SPARSE_COLS))]
    codes = np.empty((n, len(SPARSE_COLS)), np.int32)
    for j, v in enumerate(vocabs):
        codes[:, j] = rng.choice(v, size=n, p=_zipf_probs(v, 1.05, rng))
    dense_raw = rng.lognormal(1.0, 1.2, (n, len(DENSE_COLS)))

    def planted(seed_off):
        r = np.random.default_rng(seed + 500 + seed_off)
        logit = np.zeros(n, np.float64)
        for j, v in enumerate(vocabs):
            logit += r.normal(0, 1.0 / np.sqrt(1 + j % 5), v)[codes[:, j]]
        z = (dense_raw - dense_raw.mean(0)) / (dense_raw.std(0) + 1e-9)
        return logit + z @ r.normal(0, 0.6, len(DENSE_COLS))

    shared = planted(0)
    p_inc = _calibrate(task_corr * shared + (1 - task_corr) * planted(1), target_income,
                       signal_std)
    p_mar = _calibrate(task_corr * shared + (1 - task_corr) * planted(2), target_marital,
                       signal_std)
    y_inc = (rng.random(n) < p_inc).astype(np.int32)
    y_mar = (rng.random(n) < p_mar).astype(np.int32)

    cols = {c: np.round(raw * 10).astype(np.int64) for c, raw in zip(DENSE_COLS, dense_raw.T)}
    for j, c in enumerate(SPARSE_COLS):
        cols[c] = np.char.add(f" {c}_v", codes[:, j].astype(str)).astype(object)
    cols["instance_weight"] = np.round(rng.uniform(100, 5000, n), 2)
    cols[LABEL_INCOME] = np.where(y_inc == 1, " 50000+.", " - 50000.").astype(object)
    others = np.asarray([" Married-civilian spouse present", " Divorced", " Widowed",
                         " Separated", " Married-spouse absent"], object)
    cols[LABEL_MARITAL] = np.where(y_mar == 1, " Never married",
                                   others[rng.integers(0, len(others), n)]).astype(object)
    meta = {"income_rate": float(y_inc.mean()), "marital_rate": float(y_mar.mean()),
            "oracle_auc_income": _auc(y_inc, p_inc),
            "oracle_auc_marital": _auc(y_mar, p_mar)}
    return ({c: cols[c][:num_train] for c in COLUMNS},
            {c: cols[c][num_train:] for c in COLUMNS}, meta)

"""MovieLens-style data for NCF, SASRec, YoutubeDNN, MIND and the two-tower
models (the port's copy of ``recsys_tpu/data/movielens.py::synthetic_ratings``,
``build_ml100k_arrays``, ``build_ncf_dataset``, ``build_sasrec_dataset`` and
``build_seq_retrieval_dataset``, of the user and item frames ``cli
match`` makes, and of the file readers ``create_ml_100k_dataset``,
``create_ncf_dataset`` and ``create_sasrec_dataset``), in numpy only:
ratings, users and items are dicts of columns instead of pandas
DataFrames, read from the files as ``pandas.read_csv`` types them
(``table.read_table``).  The functions that draw random
numbers draw from their generator in the JAX package's order, so the same
seed gives the same arrays bit for bit; the retrieval dataset draws none
and is bit-equal outright.  ``build_sasrec_dataset(use_native=...)`` takes
the native SASRec builder (``data/native.py``), whose negatives follow the
JAX native builder's PCG32 streams; ``create_sasrec_dataset`` takes it
when it builds, as the JAX one does.
"""
from __future__ import annotations

import warnings

import numpy as np

from recsys_tpu_torch.core.features import FeatureSchema, SparseFeature
from recsys_tpu_torch.data import native
from recsys_tpu_torch.data.table import read_table

AGE_BINS = (0, 15, 25, 35, 45, 60, 100)
ML100K_RATINGS = ["user_id", "item_id", "rating", "timestamp"]
ML100K_USERS = ["user_id", "age", "gender", "occupation", "zip"]


def read_ratings(path: str) -> dict:
    """A ratings file as the JAX CLI reads one: an ml-100k ``u.data``
    (``.data``: tab-separated user, item, rating, timestamp, no header),
    else a CSV file with a header whose ``userId`` and ``movieId`` become
    ``user_id`` and ``item_id`` (the ml-latest format)."""
    if str(path).endswith(".data"):
        return read_table(path, sep="\t", names=ML100K_RATINGS)
    cols = read_table(path)
    return {{"userId": "user_id", "movieId": "item_id"}.get(k, k): v for k, v in cols.items()}


def create_ml_100k_dataset(data_dir: str, embed_dim: int = 16, test_size: float = 0.2,
                           seed: int = 2020):
    """``build_ml100k_arrays`` of an ml-100k directory: ``u.data``
    (tab-separated ratings), ``u.user`` (pipe-separated users) and
    ``u.item`` (pipe-separated, latin-1; its item id and release date)."""
    ratings = read_table(f"{data_dir}/u.data", sep="\t", names=ML100K_RATINGS)
    users = read_table(f"{data_dir}/u.user", sep="|", names=ML100K_USERS)
    items = read_table(f"{data_dir}/u.item", sep="|", names=["item_id", "release_date"],
                       usecols=[0, 2], encoding="latin-1")
    return build_ml100k_arrays(ratings, users, items, embed_dim, test_size, seed)


def create_ncf_dataset(path: str, **kw):
    """``build_ncf_dataset`` of an ml-100k ``u.data`` file."""
    return build_ncf_dataset(read_table(path, sep="\t", names=ML100K_RATINGS), **kw)


def create_sasrec_dataset(ratings_csv: str, maxlen: int = 50, test_neg_num: int = 20,
                          min_item_count: int = 5, seed: int = 2020):
    """``build_sasrec_dataset`` of an ml-latest ``ratings.csv`` (header
    userId, movieId, rating, timestamp), through the native builder where
    it builds (``use_native='auto'``)."""
    return build_sasrec_dataset(read_ratings(ratings_csv), maxlen, test_neg_num,
                                min_item_count, seed, use_native="auto")


def synthetic_ratings(num_users: int = 200, num_items: int = 100,
                      events_per_user: tuple = (5, 30), seed: int = 0) -> dict:
    """Synthetic ratings with cluster structure: users prefer items of their
    own hidden cluster.  Returns int64 columns, one row per event."""
    rng = np.random.default_rng(seed)
    user_cluster = rng.integers(0, 4, num_users)
    item_cluster = rng.integers(0, 4, num_items)
    rows = []
    t = 0
    for u in range(num_users):
        n = int(rng.integers(*events_per_user))
        liked = np.flatnonzero(item_cluster == user_cluster[u])
        for _ in range(n):
            if len(liked) > 0 and rng.random() < 0.7:
                i = int(rng.choice(liked))
                r = int(rng.integers(3, 6))
            else:
                i = int(rng.integers(0, num_items))
                r = int(rng.integers(1, 6))
            rows.append((u + 1, i + 1, r, t))
            t += 1
    cols = np.asarray(rows, np.int64).reshape(-1, 4)
    return {name: cols[:, j].copy()
            for j, name in enumerate(("user_id", "item_id", "rating", "timestamp"))}


def synthetic_user_item_frames(num_users: int = 300, num_items: int = 150,
                               seed: int = 0) -> tuple[dict, dict]:
    """The ml-100k-shaped user and item columns ``cli match`` pairs with
    ``synthetic_ratings`` when no files are given: users 1..num_users with
    an age in [10, 70), a gender in {M, F}, an occupation in a..g and a
    zip of "0"; items 1..num_items released in "1995"."""
    rng = np.random.default_rng(seed)
    users = {"user_id": np.arange(1, num_users + 1),
             "age": rng.integers(10, 70, num_users),
             "gender": rng.choice(["M", "F"], num_users),
             "occupation": rng.choice(list("abcdefg"), num_users),
             "zip": np.asarray(["0"] * num_users)}
    items = {"item_id": np.arange(1, num_items + 1),
             "release_date": np.asarray(["1995"] * num_items)}
    return users, items


def _inner_join(left: dict, right: dict, key: str) -> dict:
    """pandas' ``left.merge(right, on=key)`` on dicts of columns where
    ``right`` holds each key once (a user or item file): the rows of
    ``left`` whose key ``right`` holds, in their order, with ``right``'s
    columns added."""
    lk, rk = np.asarray(left[key]), np.asarray(right[key])
    by_key = np.argsort(rk, kind="stable")
    if len(rk) and (rk[by_key][1:] == rk[by_key][:-1]).any():
        raise ValueError(f"the right-hand columns hold a {key} more than once")
    pos = np.minimum(np.searchsorted(rk[by_key], lk), max(len(rk) - 1, 0))
    hit = (rk[by_key][pos] == lk) if len(rk) else np.zeros(len(lk), bool)
    out = {k: np.asarray(v)[hit] for k, v in left.items()}
    ri = by_key[pos[hit]]
    out.update({k: np.asarray(v)[ri] for k, v in right.items() if k != key})
    return out


def age_bins(age: np.ndarray) -> np.ndarray:
    """The bin of each age in the right-closed bins (0, 15], (15, 25], ...,
    (60, 100] as 0..5, and 0 for an age outside them: ``pd.cut(age,
    AGE_BINS, labels=False).fillna(0)`` as float64."""
    age = np.asarray(age, np.float64)
    b = np.searchsorted(AGE_BINS, age, side="left") - 1
    return np.where((b >= 0) & (b < len(AGE_BINS) - 1), b, 0).astype(np.float64)


def build_ml100k_arrays(ratings: dict, users: dict, items: dict, embed_dim: int = 16,
                        test_size: float = 0.2, seed: int = 2020):
    """The ml-100k two-tower protocol: the ratings joined with their users
    and items, label = rating >= 3, ages binned, every id column encoded to
    0..n-1 in sorted order, then an 80/20 split by one permutation from
    ``seed``.  Returns (user_schema, item_schema, train, test); the user
    tower's fields are user_id, age_bin, gender and occupation, the item
    tower's item_id, and each split is a dict of int32 ``user_sparse``,
    ``item_sparse`` and float32 ``label``."""
    df = _inner_join(_inner_join(ratings, users, "user_id"), items, "item_id")
    df["label"] = (df["rating"] >= 3).astype(np.float32)
    df["age_bin"] = age_bins(df["age"])
    user_cols = ["user_id", "age_bin", "gender", "occupation"]
    item_cols = ["item_id"]
    enc = {}
    for col in user_cols + item_cols:
        uniques, codes = np.unique(df[col], return_inverse=True)
        df[col + "_enc"] = codes.reshape(-1).astype(np.int32)
        enc[col] = len(uniques)
    user_schema = FeatureSchema(sparse=[SparseFeature(c, enc[c], embed_dim) for c in user_cols])
    item_schema = FeatureSchema(sparse=[SparseFeature(c, enc[c], embed_dim) for c in item_cols])

    n = len(df["label"])
    idx = np.random.default_rng(seed).permutation(n)
    cut = int(n * (1.0 - test_size))

    def take(sel):
        return {"user_sparse": np.stack([df[c + "_enc"][sel] for c in user_cols], 1),
                "item_sparse": np.stack([df[c + "_enc"][sel] for c in item_cols], 1),
                "label": df["label"][sel]}

    return user_schema, item_schema, take(idx[:cut]), take(idx[cut:])


def build_ncf_dataset(ratings: dict, train_neg_num: int = 1, test_neg_num: int = 100,
                      trans_score: int = 1, seed: int = 2020):
    """The NCF protocol, one user at a time: events rated ``trans_score``
    or more, users and items renumbered 0.. in sorted order, each user's
    items in time order (a stable sort; users with fewer than 3 skipped);
    every item but the last two trains with ``train_neg_num`` negatives,
    the last two are the val and test positives with ``test_neg_num``
    each; a negative is drawn uniformly until it is none of the user's
    items.  Returns (num_users, num_items, train, val, test), each a dict
    of ``user`` (B,), ``pos_item`` (B,) and ``neg_item`` (B, N) int32."""
    rng = np.random.default_rng(seed)
    keep = np.asarray(ratings["rating"]) >= trans_score
    u_ids, u = np.unique(np.asarray(ratings["user_id"])[keep], return_inverse=True)
    i_ids, i = np.unique(np.asarray(ratings["item_id"])[keep], return_inverse=True)
    order = np.lexsort((np.asarray(ratings["timestamp"])[keep], u))
    u, i = u[order], i[order]
    users, starts = np.unique(u, return_index=True)
    num_items = len(i_ids)

    def sample_neg(exclude: set, n: int) -> list:
        out = []
        while len(out) < n:
            cand = int(rng.integers(0, num_items))
            if cand not in exclude:
                out.append(cand)
        return out

    rows = {k: ([], [], []) for k in ("train", "val", "test")}
    for user, s, e in zip(users, starts, [*starts[1:], len(u)]):
        seq = i[s:e].tolist()
        if len(seq) < 3:
            continue
        exclude = set(seq)
        parts = [("train", item, train_neg_num) for item in seq[:-2]]
        parts += [("val", seq[-2], test_neg_num), ("test", seq[-1], test_neg_num)]
        for split, item, n in parts:
            rows[split][0].append(user)
            rows[split][1].append(item)
            rows[split][2].append(sample_neg(exclude, n))

    def pack(us, ps, ns):
        return {"user": np.asarray(us, np.int32), "pos_item": np.asarray(ps, np.int32),
                "neg_item": np.asarray(ns, np.int32)}

    return len(u_ids), num_items, pack(*rows["train"]), pack(*rows["val"]), \
        pack(*rows["test"])


def build_sasrec_dataset(ratings: dict, maxlen: int = 50, test_neg_num: int = 20,
                         min_item_count: int = 5, seed: int = 2020,
                         all_positions: bool = False, use_native: bool | str = False):
    """Returns (num_items, train, val, test), each split a dict of int32
    ``hist`` (N, maxlen), ``pos`` and ``neg``.

    Items seen fewer than ``min_item_count`` times are dropped and the rest
    remapped to 1..N in id order (0 = pad).  Each user's events, in time
    order, give a front-padded history.  Training rows are the exploded
    prefixes (pos (N,), one sampled negative each) or, with
    ``all_positions``, one row per user whose position t predicts the next
    item (pos and neg (N, maxlen)).  Validation targets the second-to-last
    item, test the last, each against ``test_neg_num`` sampled negatives.

    ``use_native`` (``'auto'``, True or False) builds the rows with the
    native builder (``native.build_seq_leave_last2``): the same rows, the
    negatives from its PCG32 stream a user rather than numpy's generator.
    True raises where the library cannot be built; ``'auto'`` then warns
    and takes the numpy builder, as the JAX ``'auto'`` falls back."""
    if use_native:
        try:
            native.library()
        except RuntimeError as e:
            if use_native is True:
                raise
            warnings.warn(f"build_sasrec_dataset: the native builder is unavailable, "
                          f"using the numpy builder ({e})", RuntimeWarning, stacklevel=2)
        else:
            num_items, iid, starts, _ = _kept_sequences(ratings, min_item_count)
            user_off = np.append(starts, len(iid)).astype(np.int64)
            train, val, test = native.build_seq_leave_last2(
                iid, user_off, maxlen, num_items, test_neg_num, seed=seed,
                all_positions=all_positions)
            return num_items, train, val, test
    rng = np.random.default_rng(seed)
    user = np.asarray(ratings["user_id"])
    item = np.asarray(ratings["item_id"])
    ts = np.asarray(ratings["timestamp"])
    vals, counts = np.unique(item, return_counts=True)
    item_ids = vals[counts >= min_item_count]  # sorted
    keep = np.isin(item, item_ids)
    user, item, ts = user[keep], item[keep], ts[keep]
    iid = np.searchsorted(item_ids, item) + 1  # 0 is pad
    num_items = len(item_ids) + 1

    order = np.lexsort((ts, user))  # by user, then time; stable
    user, iid = user[order], iid[order]
    starts = np.flatnonzero(np.r_[True, user[1:] != user[:-1]])
    seqs = np.split(iid, starts[1:]) if len(iid) else []

    def sample_neg(exclude: set, n: int) -> list[int]:
        out = []
        while len(out) < n:
            cand = int(rng.integers(1, num_items))
            if cand not in exclude:
                out.append(cand)
        return out

    def pad(seq: list[int]) -> np.ndarray:
        seq = seq[-maxlen:]
        return np.asarray([0] * (maxlen - len(seq)) + seq, np.int32)

    train_h, train_p, train_n = [], [], []
    val_h, val_p, val_n = [], [], []
    test_h, test_p, test_n = [], [], []
    for seq in seqs:
        seq = seq.tolist()
        if len(seq) < 3:
            continue
        exclude = set(seq)
        if all_positions:
            train_seq = seq[:-2]
            if len(train_seq) >= 2:
                inp = pad(train_seq[:-1])
                tgt = pad(train_seq[1:])
                negs = np.where(tgt > 0, np.asarray(sample_neg(exclude, maxlen), np.int32), 0)
                train_h.append(inp)
                train_p.append(tgt)
                train_n.append(negs)
        else:
            for t in range(1, len(seq) - 2):
                train_h.append(pad(seq[:t]))
                train_p.append(seq[t])
                train_n.append(sample_neg(exclude, 1))
        val_h.append(pad(seq[:-2]))
        val_p.append(seq[-2])
        val_n.append(sample_neg(exclude, test_neg_num))
        test_h.append(pad(seq[:-1]))
        test_p.append(seq[-1])
        test_n.append(sample_neg(exclude, test_neg_num))

    def pack(h, p, n):
        return {"hist": np.stack(h).astype(np.int32), "pos": np.asarray(p, np.int32),
                "neg": np.asarray(n, np.int32)}

    return (num_items, pack(train_h, train_p, train_n), pack(val_h, val_p, val_n),
            pack(test_h, test_p, test_n))


def _kept_sequences(ratings: dict, min_item_count: int):
    """The protocol's common front: items seen fewer than ``min_item_count``
    times dropped, the rest remapped to 1..N over their sorted ids (0 is
    the pad), events stably sorted by (user, timestamp).  Returns
    (num_items, iid in that order, start of each user's run, its length),
    users ascending."""
    user = np.asarray(ratings["user_id"])
    item = np.asarray(ratings["item_id"])
    ts = np.asarray(ratings["timestamp"])
    vals, counts = np.unique(item, return_counts=True)
    item_ids = vals[counts >= min_item_count]  # sorted
    keep = np.isin(item, item_ids)
    user, item, ts = user[keep], item[keep], ts[keep]
    iid = np.searchsorted(item_ids, item) + 1
    order = np.lexsort((ts, user))  # by user, then time; stable
    user, iid = user[order], iid[order]
    starts = np.flatnonzero(np.r_[True, user[1:] != user[:-1]]) if len(user) else \
        np.zeros(0, np.int64)
    lens = np.diff(np.r_[starts, len(user)])
    return len(item_ids) + 1, iid, starts, lens


def _prefix_rows(iid: np.ndarray, start: np.ndarray, t: np.ndarray, maxlen: int,
                 chunk: int = 1 << 17) -> np.ndarray:
    """(R, maxlen) int32: row r holds the last ``maxlen`` items of the
    ``t[r]``-item prefix of the sequence starting at ``iid[start[r]]``,
    padded in front with 0."""
    out = np.zeros((len(t), maxlen), np.int32)
    cols = np.arange(maxlen) - maxlen
    for lo in range(0, len(t), chunk):
        pos = t[lo:lo + chunk, None] + cols  # position within the sequence
        src = start[lo:lo + chunk, None] + np.maximum(pos, 0)
        out[lo:lo + chunk] = np.where(pos >= 0, iid[src], 0)
    return out


def build_seq_retrieval_dataset(ratings: dict, maxlen: int = 20, min_item_count: int = 2,
                                seed: int = 2020):
    """The sequence-retrieval protocol of YoutubeDNN and MIND: predict the
    next item from the padded watch history (in-batch softmax supplies the
    negatives).  Returns (num_items, train, test), each a dict of int32
    ``hist`` (N, maxlen) and ``item_id`` (N,); item ids 1..num_items-1 (0 is
    the pad).  Users with fewer than 3 kept events are dropped; every prefix
    of 1..n-2 items predicts the next item for training, and the n-1 item
    history predicts the last item for test.  ``seed`` is unused (the JAX
    signature's); the function is vectorised over all prefixes at once."""
    del seed
    num_items, iid, starts, lens = _kept_sequences(ratings, min_item_count)
    ok = lens >= 3
    starts, lens = starts[ok], lens[ok]
    n_train = lens - 2
    row_start = np.repeat(starts, n_train)
    # t = 1..n-2 within each user's run
    t = np.arange(n_train.sum()) - np.repeat(np.cumsum(n_train) - n_train, n_train) + 1
    train = {"hist": _prefix_rows(iid, row_start, t, maxlen),
             "item_id": iid[row_start + t].astype(np.int32)}
    test = {"hist": _prefix_rows(iid, starts, lens - 1, maxlen),
            "item_id": iid[starts + lens - 1].astype(np.int32)}
    return num_items, train, test

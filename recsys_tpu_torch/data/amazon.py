"""The Amazon-Electronics behaviour-sequence pipeline of DIN (the port's
copy of ``recsys_tpu/data/amazon.py``), without pandas: reviews and their
items' categories become per-user chronological sequences; every position
t >= 1 gives a positive (the next item) and one random negative, with the
history before t front-padded to ``maxlen``.  Reviews and meta are dicts of
columns (numpy arrays or lists).
"""
from __future__ import annotations

import ast
import json

import numpy as np

from recsys_tpu_torch.data.realistic import din_schema


def _parse_line(line: str) -> dict:
    """One line of an Amazon dump: JSON, or the Python literal (single
    quotes) the original dumps hold, read with ``ast.literal_eval``."""
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return ast.literal_eval(line)


def create_amazon_electronic_dataset(reviews_path: str, meta_path: str, embed_dim: int = 8,
                                     maxlen: int = 40, seed: int = 2020):
    """``build_amazon_arrays`` of a reviews dump (``reviewerID``, ``asin``,
    ``unixReviewTime`` a line) and a meta dump (``asin``, ``categories``; an
    item's category is the last entry of its last category path)."""
    with open(reviews_path) as f:
        lines = [_parse_line(line) for line in f]
    reviews = {k: [r[k] for r in lines] for k in ("reviewerID", "asin", "unixReviewTime")}
    with open(meta_path) as f:
        lines = [_parse_line(line) for line in f]
    meta = {"asin": [m["asin"] for m in lines],
            "category": [m["categories"][-1][-1] for m in lines]}
    return build_amazon_arrays(reviews, meta, embed_dim, maxlen, seed)


def build_amazon_arrays(reviews: dict, meta: dict, embed_dim: int = 8, maxlen: int = 40,
                        seed: int = 2020):
    """reviews {reviewerID, asin, unixReviewTime}, meta {asin, category} ->
    (schema, train, val, test) DIN batches {'sparse': (B, 2) [item,
    category], 'hist': (B, L), 'hist_cate': (B, L), 'label': (B,)}.  Items
    are numbered 1.. in sorted asin order and categories 1.. in sorted
    order (0 the pad of both); reviews of unknown items are dropped.  Users
    are taken in sorted order, each one's reviews stably by time; users
    with fewer than 3 are skipped.  Each position's negative is drawn
    uniformly until it is none of the user's items; the last position goes
    to test, the one before to val, the rest to train."""
    rng = np.random.default_rng(seed)
    meta_asin = np.asarray(meta["asin"])
    item_ids = np.unique(meta_asin)
    imap = {v: i + 1 for i, v in enumerate(item_ids)}  # 0 = pad
    cat_uniques, cates = np.unique(np.asarray(meta["category"]), return_inverse=True)
    item_to_cate = np.zeros(len(item_ids) + 1, np.int32)
    for asin, cate in zip(meta_asin, cates):
        item_to_cate[imap[asin]] = cate + 1  # 0 = pad category
    num_items, num_cates = len(item_ids) + 1, len(cat_uniques) + 1

    user = np.asarray(reviews["reviewerID"])
    asin = np.asarray(reviews["asin"])
    when = np.asarray(reviews["unixReviewTime"])
    known = np.asarray([a in imap for a in asin], bool)
    user, asin, when = user[known], asin[known], when[known]
    order = np.lexsort((when, user))
    user = user[order]
    iid = np.asarray([imap[a] for a in asin[order]], np.int64)
    _, starts = np.unique(user, return_index=True)

    splits = {k: {"sparse": [], "hist": [], "label": []} for k in ("train", "val", "test")}
    for s, e in zip(starts, [*starts[1:], len(user)]):
        seq = iid[s:e].tolist()
        if len(seq) < 3:
            continue
        exclude = set(seq)
        for t in range(1, len(seq)):
            dest = splits["test" if t == len(seq) - 1 else
                          "val" if t == len(seq) - 2 else "train"]
            hist = seq[max(0, t - maxlen):t]
            hist = [0] * (maxlen - len(hist)) + hist
            while True:
                neg = int(rng.integers(1, num_items))
                if neg not in exclude:
                    break
            for item, label in ((seq[t], 1.0), (neg, 0.0)):
                dest["sparse"].append([item, item_to_cate[item]])
                dest["hist"].append(hist)
                dest["label"].append(label)

    def pack(d):
        hist = np.asarray(d["hist"], np.int32)
        return {"sparse": np.asarray(d["sparse"], np.int32), "hist": hist,
                "hist_cate": item_to_cate[hist].astype(np.int32),
                "label": np.asarray(d["label"], np.float32)}

    return (din_schema(num_items, num_cates, embed_dim, maxlen), pack(splits["train"]),
            pack(splits["val"]), pack(splits["test"]))


def synthetic_reviews(num_users: int = 100, num_items: int = 60, seed: int = 0):
    """Synthetic (reviews, meta) columns in the layout ``build_amazon_arrays``
    takes: items A0000.. in 5 categories; each user prefers one category
    and reviews 3 to 14 items, 70% of them from it."""
    rng = np.random.default_rng(seed)
    asins = [f"A{i:04d}" for i in range(num_items)]
    cats = [f"cat{rng.integers(0, 5)}" for _ in range(num_items)]
    meta = {"asin": np.asarray(asins), "category": np.asarray(cats)}
    rows = []
    t = 0
    for u in range(num_users):
        pref = rng.integers(0, 5)
        liked = [a for a, c in zip(asins, cats) if c == f"cat{pref}"]
        for _ in range(int(rng.integers(3, 15))):
            a = rng.choice(liked) if liked and rng.random() < 0.7 else rng.choice(asins)
            rows.append((f"U{u}", str(a), t))
            t += 1
    reviews = {"reviewerID": np.asarray([r[0] for r in rows]),
               "asin": np.asarray([r[1] for r in rows]),
               "unixReviewTime": np.asarray([r[2] for r in rows], np.int64)}
    return reviews, meta

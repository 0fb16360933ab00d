"""The port's data for the two-tower models against the JAX package:
``realistic_ratings(return_meta=True)``, ``build_ml100k_arrays`` (on the
``cli match`` fixture and on frames with ages outside the bins, keys
without a match and unordered files) and the ``protocol dssm`` arrays, all
bit-equal; and the item-embedding export, a file written by either package
loaded by the other.  Inputs come from numpy with a seed."""
import json

import numpy as np
import pandas as pd
import pytest
import torch

from recsys_tpu.data.movielens import build_ml100k_arrays as jax_build_ml100k
from recsys_tpu.data.movielens import synthetic_ratings as jax_synthetic_ratings
from recsys_tpu.data.realistic import realistic_ratings as jax_realistic_ratings
from recsys_tpu.train import export as jax_export
from recsys_tpu_torch.data.movielens import (build_ml100k_arrays, synthetic_ratings,
                                             synthetic_user_item_frames)
from recsys_tpu_torch.data.realistic import realistic_ratings
from recsys_tpu_torch.tools.protocol import dssm_data, dssm_user_feats
from recsys_tpu_torch.train import export


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _schema_fields(schema):
    return [(f.name, f.vocab_size, f.embed_dim) for f in schema.sparse]


@pytest.mark.parametrize("kw", [dict(num_users=2000, num_items=1500, seed=0),
                                dict(num_users=2000, num_items=900, seed=3, num_cates=30,
                                     num_occupations=5, user_batch=300)],
                         ids=["defaults", "small-vocabularies"])
def test_realistic_ratings_meta_is_bit_equal_to_jax(kw):
    frame, jmeta = jax_realistic_ratings(return_meta=True, **kw)
    cols, meta = realistic_ratings(return_meta=True, **kw)
    _equal(cols, {k: frame[k].to_numpy() for k in frame.columns})
    assert meta.keys() == jmeta.keys()
    for k, v in jmeta.items():
        if isinstance(v, np.ndarray):
            assert meta[k].dtype == v.dtype, k
            np.testing.assert_array_equal(meta[k], v, err_msg=k)
        else:
            assert meta[k] == v, k
    # the ratings do not move when the meta is asked for
    _equal(realistic_ratings(**kw), cols)


def _jax_fixture(nu, ni, seed):
    """``recsys_tpu/cli.py`` run_match's synthetic frames, line by line."""
    rng = np.random.default_rng(seed)
    users = pd.DataFrame({
        "user_id": np.arange(1, nu + 1),
        "age": rng.integers(10, 70, nu),
        "gender": rng.choice(["M", "F"], nu),
        "occupation": rng.choice(list("abcdefg"), nu),
        "zip": ["0"] * nu,
    })
    items = pd.DataFrame({"item_id": np.arange(1, ni + 1), "release_date": ["1995"] * ni})
    return users, items


@pytest.mark.parametrize("nu, ni, embed_dim", [(300, 150, 8), (120, 60, 16)])
def test_cli_match_fixture_and_ml100k_arrays_are_bit_equal_to_jax(nu, ni, embed_dim):
    jusers, jitems = _jax_fixture(nu, ni, 0)
    users, items = synthetic_user_item_frames(nu, ni, seed=0)
    for cols, frame in ((users, jusers), (items, jitems)):
        assert list(cols) == list(frame.columns)
        for k in cols:
            assert cols[k].tolist() == frame[k].tolist(), k
    want = jax_build_ml100k(jax_synthetic_ratings(num_users=nu, num_items=ni), jusers, jitems,
                            embed_dim=embed_dim)
    got = build_ml100k_arrays(synthetic_ratings(num_users=nu, num_items=ni), users, items,
                              embed_dim=embed_dim)
    for g, w in zip(got[:2], want[:2]):
        assert _schema_fields(g) == _schema_fields(w)
    _equal(got[2], want[2])
    _equal(got[3], want[3])


def test_ml100k_arrays_on_unordered_files_are_bit_equal_to_jax():
    """Users and items listed out of order, a rating whose user and one whose
    item is missing, ages on the bins' edges and outside them (binned 0)."""
    rng = np.random.default_rng(5)
    n = 400
    ratings = {"user_id": rng.integers(1, 42, n), "item_id": rng.integers(1, 32, n),
               "rating": rng.integers(1, 6, n), "timestamp": rng.permutation(n)}
    users = {"user_id": rng.permutation(np.arange(1, 41)),
             "age": np.r_[[0, 15, 16, 25, 60, 100, 101, -3], rng.integers(1, 99, 32)],
             "gender": rng.choice(["M", "F"], 40),
             "occupation": rng.choice(["writer", "artist", "none", "doctor"], 40),
             "zip": np.asarray(["0"] * 40)}
    items = {"item_id": rng.permutation(np.arange(1, 31)),
             "release_date": np.asarray(["1995"] * 30)}
    want = jax_build_ml100k(pd.DataFrame(ratings), pd.DataFrame(users), pd.DataFrame(items),
                            embed_dim=4, test_size=0.3, seed=7)
    got = build_ml100k_arrays(ratings, users, items, embed_dim=4, test_size=0.3, seed=7)
    assert len(got[2]["label"]) + len(got[3]["label"]) < n  # unmatched rows dropped
    for g, w in zip(got[:2], want[:2]):
        assert _schema_fields(g) == _schema_fields(w)
    _equal(got[2], want[2])
    _equal(got[3], want[3])
    dup = dict(items, item_id=np.r_[items["item_id"][:-1], items["item_id"][0]])
    with pytest.raises(ValueError, match="more than once"):
        build_ml100k_arrays(ratings, users, dup)


def _jax_dssm_arrays(ratings, meta, items):
    """``recsys_tpu/tools/protocol.py`` run_dssm's data lines, line by line."""
    df = ratings.sort_values(["user_id", "timestamp"], kind="mergesort")
    u = df["user_id"].to_numpy()
    i = df["item_id"].to_numpy().astype(np.int32)
    rat = df["rating"].to_numpy()
    uniq, starts, counts = np.unique(u, return_index=True, return_counts=True)
    last = starts + counts - 1
    is_last = np.zeros(len(u), bool)
    is_last[last] = True
    label = (rat >= 3).astype(np.float32)

    def user_feats(user_ids):
        return np.stack([user_ids.astype(np.int32), meta["user_age_bin"][user_ids],
                         meta["user_gender"][user_ids], meta["user_occupation"][user_ids]],
                        axis=1).astype(np.int32)

    def item_feats(item_ids):
        return np.stack([item_ids.astype(np.int32), meta["item_cate"][item_ids]],
                        axis=1).astype(np.int32)

    tr_mask = ~is_last
    test_ok = label[last] > 0
    pos = tr_mask & (label > 0)
    return {
        "user_vocab": int(u.max()) + 1,
        "bce_train": {"user_sparse": user_feats(u[tr_mask]),
                      "item_sparse": item_feats(i[tr_mask]), "label": label[tr_mask]},
        "pair_train": {"user_sparse": user_feats(u[pos]), "item_sparse": item_feats(i[pos]),
                       "item_id": i[pos].astype(np.int32)},
        "pair_counts": np.bincount(i[pos], minlength=items + 1),
        "test_users": uniq[test_ok], "test_items": i[last][test_ok],
        "test_user_feats": user_feats(uniq[test_ok]),
        "catalog": item_feats(np.arange(1, items + 1)),
    }


def test_dssm_protocol_arrays_are_bit_equal_to_jax():
    users, items = 2000, 700
    frame, jmeta = jax_realistic_ratings(num_users=users, num_items=items, seed=2,
                                         return_meta=True)
    # shuffled rows: the protocol sorts them stably by (user, timestamp)
    frame = frame.iloc[np.random.default_rng(0).permutation(len(frame))]
    want = _jax_dssm_arrays(frame, jmeta, items)
    cols, meta = realistic_ratings(num_users=users, num_items=items, seed=2, return_meta=True)
    cols = {k: v[np.random.default_rng(0).permutation(len(v))] for k, v in cols.items()}
    got = dssm_data(cols, meta, items)
    for key in ("bce_train", "pair_train"):
        _equal(got[key], want[key])
    for key in ("pair_counts", "test_users", "test_items", "catalog"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert _schema_fields(got["user_schema"]) == [
        ("user_id", want["user_vocab"], 16), ("age_bin", 9, 16), ("gender", 3, 16),
        ("occupation", jmeta["num_occupations"], 16)]
    assert _schema_fields(got["item_schema"]) == [("item_id", items + 1, 16),
                                                  ("cate", jmeta["num_cates"], 16)]
    np.testing.assert_array_equal(dssm_user_feats(meta, got["test_users"]),
                                  want["test_user_feats"])


@pytest.mark.parametrize("with_ids", [False, True])
def test_export_files_load_in_either_package(tmp_path, with_ids):
    rng = np.random.default_rng(1)
    embs = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.permutation(1000)[:50] if with_ids else None
    meta = {"model": "dssm", "dim": 6}
    export.export_item_embeddings(str(tmp_path / "a" / "port.npz"), torch.from_numpy(embs),
                                  ids, meta)
    jax_export.export_item_embeddings(str(tmp_path / "b" / "jax.npz"), embs, ids, meta)
    for path in (tmp_path / "a" / "port.npz", tmp_path / "b" / "jax.npz"):
        for load in (export.load_item_embeddings, jax_export.load_item_embeddings):
            e, i, m = load(str(path))
            np.testing.assert_array_equal(e, embs)
            assert m == meta
            if with_ids:
                np.testing.assert_array_equal(i, ids)
            else:
                assert i is None
    index, i, m = export.build_index(str(tmp_path / "b" / "jax.npz"), device="cpu")
    assert index.ntotal == 50 and m == meta
    _, top = index.search(embs[:3], 1)
    np.testing.assert_array_equal(top[:, 0], np.argmax(embs[:3] @ embs.T, axis=1))
    with np.load(tmp_path / "a" / "port.npz") as z:
        assert json.loads(bytes(z["metadata"]).decode()) == meta

"""The port's native host library (``recsys_tpu_torch/data/native.py`` on
``csrc/sample_prep.cc``) against the JAX package's (``recsys_tpu.data.native``
on ``native/recsys_native.cc``): the fused update's prep, the sampler, the
shuffle and the SASRec leave-last-2 builder, bit for bit on inputs made from
a numpy seed; the Trainer's prep through it, and a short fit over a stream at
the port's chunk length (1) against the JAX Trainer at 256."""
import jax
import numpy as np
import pandas as pd
import pytest

from recsys_tpu.data import native as jax_native
from recsys_tpu.data.movielens import build_sasrec_dataset as jax_build_sasrec
from recsys_tpu.data.streaming import CriteoStream as JaxCriteoStream
from recsys_tpu.train.streaming_embed import host_prep_group as jax_host_prep
from recsys_tpu_torch.convert import params_from_jax
from recsys_tpu_torch.core.features import FeatureSchema, SparseFeature
from recsys_tpu_torch.data import native
from recsys_tpu_torch.data.movielens import build_sasrec_dataset
from recsys_tpu_torch.data.realistic import realistic_ratings
from recsys_tpu_torch.data.streaming import CriteoStream
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.train import sparse_embed, streaming_embed
from test_torch_fit_stream import STREAM, _pair, tsv  # noqa: F401 (tsv is a fixture)
from test_torch_training import _close_by_share


def _prep_ids(seed=0, vp=1000):
    """Ids of a 1000-row table in blocks of 96 (the last block 40 rows):
    duplicates, blocks no id falls in, a hot row of 600 occurrences whose
    block spans chunks at every ch, and ids in the ragged last block."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, 480, 300), np.full(600, 250),
                          rng.integers(960, vp, 20), rng.integers(0, 480, 50)])
    return rng.permutation(ids).astype(np.int32)


@pytest.mark.parametrize("ch", [1, 8, 16, 256])
def test_fused_prep_is_bit_equal_to_jax_and_the_plain_prep(ch):
    ids, vp, block = _prep_ids(), 1000, 96
    got = native.fused_prep(ids, vp, block, ch)
    blocks = np.unique(ids // block)
    assert len(blocks) < -(-vp // block) and np.bincount(ids)[250] == 600
    for want in (jax_native.fused_prep(ids, 1, vp, block, ch),
                 jax_host_prep(ids, pack=1, vp=vp, block=block, ch=ch, use_native=False),
                 streaming_embed.host_prep_group(ids, vp=vp, block=block, ch=ch)):
        for g, w, name in zip(got, want, ("ids2d", "idx", "cptr")):
            assert g.dtype == np.int32 and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_fused_prep_refuses_ids_outside_the_table():
    with pytest.raises(ValueError, match="outside"):
        native.fused_prep(np.array([3, 10], np.int32), 10, 4, 8)
    with pytest.raises(ValueError, match="positive"):
        native.fused_prep(np.array([3], np.int32), 10, 4, 0)


@pytest.mark.parametrize("ch", [streaming_embed.PREP_CH, 8])
def test_make_host_prep_equals_the_plain_prep_of_each_group(ch):
    """Two groups of several columns each: ``embaux{g}_src`` is the plain
    prep's slot occurrence mapped to its row of the (B·F, D) cotangent, at
    the port's chunk length (the default) and at 8."""
    schema = FeatureSchema(sparse=[SparseFeature(f"C{i}", v, 4)
                                   for i, v in enumerate((30, 700, 5, 90, 300))])
    plan = sparse_embed.build_plan(StackedEmbedding(schema, num_groups=2, perturb_out=True))
    rng = np.random.default_rng(1)
    b = 48
    sparse = np.stack([np.minimum(rng.zipf(1.3, b) - 1, f.vocab_size - 1)
                       for f in schema.sparse], 1).astype(np.int64)
    prep = streaming_embed.make_host_prep(plan, **({} if ch == streaming_embed.PREP_CH
                                                   else {"ch": ch}))
    aux = prep(sparse)
    for g, (cols, offs) in enumerate(zip(plan.group_cols, plan.group_offsets)):
        rows = (sparse[:, cols].astype(np.int32) + np.asarray(offs, np.int32)).T.reshape(-1)
        vp = plan.group_vocab[g]
        ids2d, idx, cptr = streaming_embed.host_prep_group(rows, vp=vp, block=min(512, vp),
                                                           ch=ch)
        tap_row = (np.arange(rows.size) % b) * 5 + np.repeat(cols, b)
        np.testing.assert_array_equal(aux[f"embaux{g}_ids"], ids2d)
        np.testing.assert_array_equal(aux[f"embaux{g}_src"], tap_row[idx])
        np.testing.assert_array_equal(aux[f"embaux{g}_ptr"], cptr)


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_negatives_and_shuffle_match_jax(seed):
    rng = np.random.default_rng(seed)
    excl = [rng.integers(0, 40, rng.integers(0, 30)).tolist() for _ in range(25)]
    np.testing.assert_array_equal(native.sample_negatives(excl, 6, 0, 40, seed=seed),
                                  jax_native.sample_negatives(excl, 6, 0, 40, seed=seed))
    np.testing.assert_array_equal(native.sample_negatives(excl, 3, 5, 60, seed=seed),
                                  jax_native.sample_negatives(excl, 3, 5, 60, seed=seed))
    got = native.shuffle_indices(1000, seed)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_native.shuffle_indices(1000, seed))
    np.testing.assert_array_equal(np.sort(got), np.arange(1000))


def test_sample_negatives_refuses_a_covered_range():
    """Where the JAX library would loop forever, the port raises."""
    with pytest.raises(ValueError, match="covers"):
        native.sample_negatives([[0, 1, 2]], 2, 0, 3)


@pytest.mark.parametrize("all_positions", [False, True])
def test_build_seq_leave_last2_matches_jax(all_positions):
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 30, 40)  # users of 1 and 2 items are skipped
    items = rng.integers(1, 80, lens.sum()).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    got = native.build_seq_leave_last2(items, off, 12, 80, 7, seed=5,
                                       all_positions=all_positions)
    want = jax_native.build_seq_leave_last2(items, off, 12, 80, 7, seed=5,
                                            all_positions=all_positions)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("all_positions", [False, True])
def test_build_sasrec_dataset_native_matches_jax(all_positions):
    ratings = realistic_ratings(num_users=150, num_items=120, seed=2)
    got = build_sasrec_dataset(ratings, maxlen=16, all_positions=all_positions,
                               use_native=True)
    want = jax_build_sasrec(pd.DataFrame(ratings), maxlen=16, all_positions=all_positions,
                            use_native=True)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the same rows as the numpy builder's; only the negatives' stream differs
    plain = build_sasrec_dataset(ratings, maxlen=16, all_positions=all_positions)
    for g, p in zip(got[1:], plain[1:]):
        for k in ("hist", "pos"):
            np.testing.assert_array_equal(g[k], p[k], err_msg=k)


def test_native_builder_unavailable(tmp_path, monkeypatch):
    """True raises where the library does not build; 'auto' warns and takes
    the numpy builder."""
    bad = tmp_path / "sample_prep.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "PREP_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    ratings = realistic_ratings(num_users=150, num_items=120, seed=2)
    try:
        with pytest.raises(RuntimeError, match="failed"):
            build_sasrec_dataset(ratings, maxlen=8, use_native=True)
        with pytest.warns(RuntimeWarning, match="numpy builder"):
            got = build_sasrec_dataset(ratings, maxlen=8, use_native="auto")
    finally:
        native.library.cache_clear()
    want = build_sasrec_dataset(ratings, maxlen=8)
    for g, w in zip(got[1:], want[1:]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_three_steps_over_a_stream_at_the_ports_chunk_length_match_jax(tsv):  # noqa: F811
    """Three steps of fused Adam over a stream: the port preps natively at
    its own chunk length, the JAX Trainer at 256; losses and parameters
    within the stream fit's 1e-5."""
    jt, tt = _pair(tsv, "fused_adam")
    kw = dict(STREAM, shuffle=False)
    jbatches = [b for b, _ in zip(JaxCriteoStream(tsv, **kw), range(3))]
    batches = [b for b, _ in zip(CriteoStream(tsv, **kw), range(3))]
    ch = tt._prep(batches[0]["sparse"])["embaux0_ids"].shape[1]
    assert ch == streaming_embed.PREP_CH == 1
    want = jt.fit(lambda: iter(jbatches), epochs=1, verbose=False)
    got = tt.fit(lambda: iter(batches), epochs=1, verbose=False)
    assert tt.step == int(jt.state.step) == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-5)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params),
                          tt.model.schema, tt.model)
    sd = tt.model.state_dict()
    for name, w in ref.items():
        _close_by_share(name, sd[name].numpy(), w.numpy(), "f32")

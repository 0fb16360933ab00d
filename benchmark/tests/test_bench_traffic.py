"""The traffic generator: the same seed gives the same batches, every id
lies inside its table, and ``zipf`` is skewed where ``uniform`` is not."""
import numpy as np
import pytest

from benchkit import registry

ROWS = [3, 50, 1000, 20000]


def _pool(mix, seed, batch=512, pool=4):
    m = dict(registry.load_json("traffic", mix), pool_batches=pool)
    return registry.generator(m["generator"]).make_pool(m, ROWS, 13, batch, seed)


@pytest.mark.parametrize("mix", ["zipf", "uniform"])
def test_same_seed_same_batches_and_ids_in_range(mix):
    seed = 2**31 + 77  # past 32 bits, as a run's --seed may be
    a, b, c = _pool(mix, seed), _pool(mix, seed), _pool(mix, seed + 1)
    assert len(a) == 4
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["sparse"], c[0]["sparse"])
    for batch in a:
        assert batch["sparse"].dtype == np.int32 and batch["sparse"].shape == (512, 4)
        assert (batch["sparse"] >= 0).all() and (batch["sparse"] < np.array(ROWS)).all()
        assert batch["dense"].shape == (512, 13) and np.isfinite(batch["dense"]).all()
        assert (batch["dense"] >= 0).all()
        assert set(np.unique(batch["label"])) <= {0.0, 1.0}
    labels = np.concatenate([x["label"] for x in a])
    assert 0.2 < labels.mean() < 0.31  # Criteo Kaggle's 25.6%


def _top_share(mix, col=2, top=0.01):
    """The share of a column's ids that fall on its 1% most frequent rows."""
    ids = np.concatenate([x["sparse"][:, col] for x in _pool(mix, 5, batch=4096, pool=4)])
    counts = np.sort(np.bincount(ids, minlength=ROWS[col]))[::-1]
    return counts[:int(ROWS[col] * top)].sum() / ids.size


def test_zipf_is_skewed_and_uniform_is_not():
    assert _top_share("zipf") > 0.35
    assert _top_share("uniform") < 0.03


def test_zipf_hot_rows_are_permuted():
    """The hottest row of a field is not row 0 on most seeds: the fixed
    permutation scatters the ranks over the table."""
    hot = []
    for seed in range(6):
        ids = _pool("zipf", seed)[0]["sparse"][:, 3]
        hot.append(np.bincount(ids).argmax())
    assert sum(h != 0 for h in hot) >= 4

"""The port's file readers against the JAX package's on the same files: the
C++ Criteo parser (``recsys_tpu_torch/data/native.py`` against
``recsys_tpu.data.native``), ``create_criteo_dataset`` (the label-encode
route), ``CriteoStream`` and the three MovieLens readers, all bit-equal.  The files
are the committed ``tests/assets`` ones and small ones written here from a
seed: short rows, empty fields, CRLF line ends, no header, an all-digit
categorical column with gaps."""
import numpy as np
import pandas as pd
import pytest

from recsys_tpu.data import criteo as jax_criteo
from recsys_tpu.data import movielens as jax_movielens
from recsys_tpu.data import native as jax_native
from recsys_tpu.data.streaming import CriteoStream as JaxCriteoStream
from recsys_tpu_torch.data import criteo, movielens, native, table
from recsys_tpu_torch.data.streaming import CriteoStream

ASSETS = "tests/assets"
SAMPLE = f"{ASSETS}/criteo_sample.csv"


def _row(rng, sep, n_fields=40, gaps=0.15):
    label = str(int(rng.random() < 0.3))
    dense = [str(int(v)) if rng.random() > gaps else "" for v in rng.integers(-2, 500, 13)]
    cats = [format(int(v), "x") if rng.random() > gaps else "" for v in rng.integers(0, 4000, 26)]
    return sep.join(([label] + dense + cats)[:n_fields])


def _write(path, lines, newline="\n"):
    with open(path, "w", newline="") as f:
        f.write(newline.join(lines) + newline)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path} of hand-written Criteo files."""
    d = tmp_path_factory.mktemp("criteo")
    rng = np.random.default_rng(3)
    out = {"sample": SAMPLE}
    out["tsv"] = _write(d / "plain.txt", [_row(rng, "\t") for _ in range(150)])
    out["crlf"] = _write(d / "crlf.txt", [_row(rng, "\t") for _ in range(120)], "\r\n")
    # 14..39 fields (a short row keeps the buffer's earlier categoricals),
    # fewer than 14 (skipped), more than 40 (cut), blank lines
    odd = []
    for i in range(160):
        kind = i % 8
        if kind == 3:
            odd.append(_row(rng, "\t", n_fields=int(rng.integers(14, 40))))
        elif kind == 5:
            odd.append(_row(rng, "\t", n_fields=int(rng.integers(1, 14))))
        elif kind == 6:
            odd.append(_row(rng, "\t") + "\textra\t7")
        elif kind == 7 and i % 16 == 7:
            odd.append("")
        else:
            odd.append(_row(rng, "\t"))
    out["odd"] = _write(d / "odd.txt", odd)
    header = ",".join(["label"] + [f"I{i}" for i in range(1, 14)] + [f"C{i}" for i in range(1, 27)])
    out["header"] = _write(d / "header.csv", [header] + [_row(rng, ",") for _ in range(90)], "\r\n")
    return out


@pytest.mark.parametrize("name", ["sample", "tsv", "crlf", "odd", "header"])
@pytest.mark.parametrize("buckets", [1 << 20, 1000])
def test_parse_criteo_is_bit_equal_to_jax(files, name, buckets):
    path = files[name]
    sep, skip = native.detect_format(path)
    assert (sep, skip) == (("," if name in ("sample", "header") else "\t"),
                           name in ("sample", "header"))
    got = native.parse_criteo(path, sep=sep, cat_buckets=buckets, skip_header=skip)
    want = jax_native.parse_criteo(path, sep=sep, cat_buckets=buckets, skip_header=skip)
    assert len(got[0]) > 50
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["sample", "crlf", "odd", "header"])
def test_parse_criteo_chunk_is_bit_equal_to_jax(files, name):
    """Chunk by chunk into reused buffers, against the JAX chunks, and the
    chunks together against the whole-file parse."""
    path = files[name]
    sep, skip = native.detect_format(path)
    rows = 17
    out, jout = native.new_buffers(rows), tuple(np.zeros_like(b) for b in native.new_buffers(rows))
    off = joff = 0
    parts = []
    while True:
        got, off = native.parse_criteo_chunk(path, off, rows, sep=sep, cat_buckets=4096,
                                             skip_header=skip, out=out)
        want, joff = jax_native.parse_criteo_chunk(path, joff, rows, sep=sep, cat_buckets=4096,
                                                   skip_header=skip, out=jout)
        assert off == joff
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if len(got[0]) == 0:
            break
        parts.append(tuple(a.copy() for a in got))
    assert len(parts) > 3
    whole = native.parse_criteo(path, sep=sep, cat_buckets=4096, skip_header=skip)
    if name != "odd":  # a short row there keeps another buffer's categoricals
        for j in range(3):
            np.testing.assert_array_equal(np.concatenate([p[j] for p in parts]), whole[j])


def test_parser_build_failure_raises(tmp_path, monkeypatch):
    """No Python parse stands in for a library that does not build."""
    bad = tmp_path / "criteo_parse.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed"):
            native.parse_criteo(SAMPLE)
    finally:
        native.library.cache_clear()


def _csv_with_gaps(path, rng, rows=120):
    """A Criteo CSV with a header whose C1 is all digits with gaps, C2 all
    digits without, C3 all missing, C4 floats, C5 text with "-1" among it,
    dense columns with gaps and floats."""
    header = ["label"] + [f"I{i}" for i in range(1, 14)] + [f"C{i}" for i in range(1, 27)]
    lines = [",".join(header)]
    for r in range(rows):
        f = _row(rng, ",").split(",")
        f[14] = "" if r % 7 == 0 else str(int(rng.integers(0, 300)))
        f[15] = str(int(rng.integers(-5, 40)))
        f[16] = ""
        f[17] = f"{rng.integers(0, 9)}.{rng.integers(0, 9)}"
        f[18] = "-1" if r % 5 == 0 else f[18]
        f[1] = "" if r % 4 == 0 else f"{rng.random():.3f}"
        lines.append(",".join(f))
    return _write(path, lines)


@pytest.mark.parametrize("route", ["label_encode", "label_encode_part"])
@pytest.mark.parametrize("name", ["sample", "gaps"])
def test_create_criteo_dataset_is_bit_equal_to_jax(tmp_path, route, name):
    path = SAMPLE if name == "sample" else _csv_with_gaps(tmp_path / "gaps.csv",
                                                          np.random.default_rng(5))
    kw = dict(embed_dim=4)
    if route.endswith("part"):
        kw.update(read_part=True, sample_num=77)
    got = criteo.create_criteo_dataset(path, **kw)
    want = jax_criteo.create_criteo_dataset(path, **kw)
    assert ([(f.name, f.vocab_size, f.embed_dim) for f in got[0].sparse]
            == [(f.name, f.vocab_size, f.embed_dim) for f in want[0].sparse])
    assert [f.name for f in got[0].dense] == [f.name for f in want[0].dense]
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_all_digit_column_with_gaps_codes_numbers_first():
    """pandas reads such a column as float64; after fillna("-1") it sorts
    the numbers, then the text: [9.0, 45.0, 123.0, '-1']."""
    col = table.typed_column(["123", "", "9", "45", "9"], "C1", missing="nan")
    assert col.dtype == np.float64
    codes, vocab = criteo.factorize_sorted(col)
    want, uniques = pd.factorize(pd.Series(col, dtype=object).fillna("-1"), sort=True)
    assert list(uniques) == [9.0, 45.0, 123.0, "-1"] and vocab == 4
    np.testing.assert_array_equal(codes, want)


@pytest.mark.parametrize("fields, message", [
    (["1", "inf", "3"], "infinity"),
    (["1", str(2**64), "3"], "outside int64"),
])
def test_typed_column_refuses_what_it_cannot_mirror(fields, message):
    with pytest.raises(ValueError, match=message):
        table.typed_column(fields, "x")


def test_read_table_refuses_a_row_longer_than_the_header(tmp_path):
    path = _write(tmp_path / "long.csv", ["a,b", "1,2", "1,2,3"])
    with pytest.raises(ValueError, match="3 fields"):
        table.read_table(path)


@pytest.mark.parametrize("shuffle", [False, True])
def test_criteo_stream_is_bit_equal_to_jax(files, shuffle):
    """Two files, chunks smaller than a file (rows carried across chunk and
    file ends), two passes (the seed moves with the pass)."""
    paths = [files["tsv"], files["crlf"]]
    kw = dict(batch_size=32, chunk_rows=40, cat_buckets=1 << 12, embed_dim=4,
              shuffle=shuffle, seed=9)
    got, want = CriteoStream(paths, **kw), JaxCriteoStream(paths, **kw)
    assert got.num_rows == want.num_rows == 270
    np.testing.assert_array_equal(got._mn, want._mn)
    np.testing.assert_array_equal(got._scale, want._scale)
    assert [(f.name, f.vocab_size) for f in got.schema.sparse] == \
        [(f.name, f.vocab_size) for f in want.schema.sparse]
    for _ in range(2):
        g, w = list(got), list(want)
        assert len(g) == len(w) == 270 // 32
        for bg, bw in zip(g, w):
            assert bg.keys() == bw.keys()
            for k in bw:
                assert bg[k].dtype == bw[k].dtype
                np.testing.assert_array_equal(bg[k], bw[k])


def test_criteo_stream_takes_a_glob(files):
    s = CriteoStream(files["tsv"].replace("plain.txt", "*.txt"), batch_size=16,
                     cat_buckets=64, shuffle=False)
    assert [p.rsplit("/", 1)[1] for p in s.files] == ["crlf.txt", "odd.txt", "plain.txt"]
    with pytest.raises(ValueError, match="no files"):
        CriteoStream(files["tsv"] + ".none*", batch_size=16)


def _equal_splits(got, want):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_create_ml_100k_dataset_is_bit_equal_to_jax():
    got = movielens.create_ml_100k_dataset(f"{ASSETS}/ml100k", embed_dim=4)
    want = jax_movielens.create_ml_100k_dataset(f"{ASSETS}/ml100k", embed_dim=4)
    for g, w in zip(got[:2], want[:2]):
        assert [(f.name, f.vocab_size) for f in g.sparse] == \
            [(f.name, f.vocab_size) for f in w.sparse]
    _equal_splits(got[2:], want[2:])


def test_create_ncf_dataset_is_bit_equal_to_jax():
    got = movielens.create_ncf_dataset(f"{ASSETS}/ml100k/u.data")
    want = jax_movielens.create_ncf_dataset(f"{ASSETS}/ml100k/u.data")
    assert got[:2] == want[:2]
    _equal_splits(got[2:], want[2:])


def test_create_sasrec_dataset_is_bit_equal_to_jax_python_builder():
    """Both readers take their native builder when it builds (the port's
    since its native builder exists): the port's reader is bit-equal to
    the JAX reader, and its rows (not its negatives, which come from the
    native PCG32 streams) to the JAX Python builder's on the same frame."""
    path = f"{ASSETS}/ml_latest_ratings.csv"
    got = movielens.create_sasrec_dataset(path, maxlen=20)
    want = jax_movielens.create_sasrec_dataset(path, maxlen=20)
    assert got[0] == want[0]
    _equal_splits(got[1:], want[1:])
    frame = pd.read_csv(path).rename(columns={"userId": "user_id", "movieId": "item_id"})
    python = jax_movielens.build_sasrec_dataset(frame, maxlen=20, use_native=False)
    assert got[0] == python[0]
    for g, w in zip(got[1:], python[1:]):
        for k in ("hist", "pos"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_read_ratings_reads_both_formats():
    data = movielens.read_ratings(f"{ASSETS}/ml100k/u.data")
    latest = movielens.read_ratings(f"{ASSETS}/ml_latest_ratings.csv")
    assert set(data) == {"user_id", "item_id", "rating", "timestamp"} <= set(latest)
    assert data["user_id"].dtype == np.int64 and latest["rating"].dtype == np.float64


def test_csv_rate_file_loads_as_jax_loads_it_and_both_readers_count_its_rows(tmp_path):
    """The rate tool's generated CSV (hex tokens and integers with gaps)
    through ``create_criteo_dataset`` bit-equal to the JAX loader; the
    tool's report counts every row in both readers."""
    import json

    from recsys_tpu_torch.tools import csv_rate

    path = str(tmp_path / "rate.csv")
    csv_rate.write_csv(path, 400, seed=1)
    got = criteo.create_criteo_dataset(path, embed_dim=4)
    want = jax_criteo.create_criteo_dataset(path, embed_dim=4)
    assert [f.vocab_size for f in got[0].sparse] == [f.vocab_size for f in want[0].sparse]
    _equal_splits(got[1:], want[1:])
    out = tmp_path / "report.json"
    assert csv_rate.main(["--rows", "300", "--dir", str(tmp_path), "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["native"]["rows"] == report["label_encode"]["rows"] == 300
    assert report["label_encode"]["peak_rss_kib"] >= report["label_encode"]["rss_before_read_kib"]

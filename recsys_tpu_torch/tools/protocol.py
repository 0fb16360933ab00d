"""The quality protocols on the port (the counterpart of the JAX package's
``python -m recsys_tpu.tools.protocol``):

    python -m recsys_tpu_torch.tools.protocol ctr       [--rows 1000000] [--models fm,deepfm,...]
    python -m recsys_tpu_torch.tools.protocol ncf       [--users 100000] [--items 20000]
    python -m recsys_tpu_torch.tools.protocol sasrec    [--users 100000] [--drift-scale 6.0]
    python -m recsys_tpu_torch.tools.protocol seqret    [--users 100000]   # YoutubeDNN recall@10
    python -m recsys_tpu_torch.tools.protocol din       [--users 100000] [--maxlen 40]
    python -m recsys_tpu_torch.tools.protocol multitask [--rows 1000000] [--models esmm,mmoe,ple]
    python -m recsys_tpu_torch.tools.protocol mind      [--users 100000]  # multi-interest recall@10
    python -m recsys_tpu_torch.tools.protocol dssm      [--users 100000] [--models dssm,senet,...]
    python -m recsys_tpu_torch.tools.protocol census    [--rows 200000] [--models mmoe,ple]
        ... [--seed 0] [--device cpu] [--out report.json]

``ctr``: ``realistic_criteo`` rows (26 Zipfian fields at the Criteo
vocabularies, 13 dense features), an 80/20 split by one permutation from
the seed, 10% of train held out for validation, Adam at 1e-3, batch 512, up
to 10 epochs with early stopping on the validation loss (patience 1, best
weights restored), then test AUC, also as a share of the generator's oracle
margin; ``--table-dtype bf16`` keeps the tables in bf16 (their fused or
sparse optimizer state stays f32), ``--embedding-lr`` gives the embedding
optimizer its own rate, ``--embedding-engine`` looks the tables up
through a sharded engine on the JAX runner's mesh, (data, model) =
(max(1, n // 2), min(2, n)) over the world's n ranks (``torchrun``, or one
process).  The sequence modes run on ``realistic_ratings``
(100,000 users, 20,000 items): ``ncf`` leave-last-2 with one train negative
and 100 test negatives, pairwise BCE, HR@10 and NDCG@10 every second epoch;
``sasrec`` leave-last-2 with 20 test negatives, all-position training
(rows from the native builder, as the JAX runner's), HR@10 and NDCG@10;
``seqret`` (YoutubeDNN) and ``mind`` the next-item retrieval protocol
with the logQ-corrected in-batch softmax and recall@10 over the whole
catalog; ``din`` the Amazon protocol on the ratings' categories
(histories of 40, one negative a positive, at most 12 train positions a
user, early stopping) and test AUC; ``dssm`` the two towers
(DSSM and SENet with the in-batch softmax on positives, FM-match with BCE
on rated pairs) with the side features of ``return_meta`` and recall@10 of
each user's last item.  ``multitask``: ESMM, MMoE and PLE on
``realistic_multitask`` rows (80/20 split, 10% validation, early
stopping), AUC of the click and click-and-convert heads; ``census``:
MMoE and PLE on ``realistic_census`` rows written to CSV files and read
back by ``data/census.py``'s loader, AUC of the income and marital heads.
Each mode takes the JAX runner's batch size and epochs unless given, and
prints one JSON object: the JAX report's keys plus ``fit_examples_per_s``
(examples trained per second of ``fit``), a model's in ``ctr``, ``dssm``,
``multitask`` and ``census``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from recsys_tpu_torch.core.features import FeatureSchema, SparseFeature, VarLenSparseFeature
from recsys_tpu_torch.data import census
from recsys_tpu_torch.data.movielens import build_sasrec_dataset, build_seq_retrieval_dataset
from recsys_tpu_torch.data.realistic import (build_din_dataset_fast, build_ncf_dataset_fast,
                                             realistic_census, realistic_criteo,
                                             realistic_multitask, realistic_ratings)
from recsys_tpu_torch.kernels import build, default_device
from recsys_tpu_torch.models.ctr.autoint import AutoInt
from recsys_tpu_torch.models.ctr.dcn import DCN
from recsys_tpu_torch.models.ctr.deep_crossing import DeepCrossing
from recsys_tpu_torch.models.ctr.deepfm import DeepFM
from recsys_tpu_torch.models.ctr.din import DIN
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.models.ctr.esmm import ESMM
from recsys_tpu_torch.models.ctr.fm import FM
from recsys_tpu_torch.models.ctr.mmoe import MMoE
from recsys_tpu_torch.models.ctr.ple import PLE
from recsys_tpu_torch.models.ctr.wide_deep import WideDeep
from recsys_tpu_torch.models.match.fm_match import FMMatch
from recsys_tpu_torch.models.match.mind import MIND
from recsys_tpu_torch.models.match.ncf import NCF
from recsys_tpu_torch.models.match.sasrec import SASRec
from recsys_tpu_torch.models.match.two_tower import TwoTower
from recsys_tpu_torch.models.match.youtube_dnn import YoutubeDNN
from recsys_tpu_torch.train import losses
from recsys_tpu_torch.train.loop import Trainer
from recsys_tpu_torch.train.metrics import auc_exact, hit_rate_ndcg_at_k, recall_at_k
from recsys_tpu_torch.train.retrieval import topk_scores

CTR_MODELS = {"fm": FM, "deepfm": DeepFM, "widedeep": WideDeep,
              "deepcrossing": DeepCrossing, "dcn": DCN, "dlrm": DLRM, "autoint": AutoInt}
DEFAULT_CTR_MODELS = "fm,deepfm,widedeep,deepcrossing,dcn,dlrm,autoint"
DEFAULT_DSSM_MODELS = "dssm,senet,fm_match"
# mode: (batch size, epochs) when not given, as the JAX runner's main
MODE_DEFAULTS = {"ctr": (512, 10), "ncf": (1024, 8), "sasrec": (256, 5), "seqret": (1024, 5),
                 "din": (1024, 3), "multitask": (512, 5), "mind": (1024, 5),
                 "dssm": (2048, 4), "census": (512, 5)}
MODE_ROWS = {"ctr": 1_000_000, "multitask": 1_000_000, "census": 200_000}
DEFAULT_MULTITASK_MODELS = "esmm,mmoe,ple"
DEFAULT_CENSUS_MODELS = "mmoe,ple"
DIN_MAXLEN = 40  # the JAX runner's din default; the other sequence modes take 50


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


TABLE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def ctr_model_kwargs(name: str, embedding_optimizer: str | None = None,
                     table_dtype: str = "f32", embedding_engine: str | None = None,
                     mesh=None) -> dict:
    """The protocol's options for model ``name``: DLRM computes in bf16;
    an embedding optimizer needs the tables' tap; ``table_dtype`` is the
    tables' (master) dtype; ``embedding_engine`` their lookup on ``mesh``."""
    kw = {"compute_dtype": torch.bfloat16} if name == "dlrm" else {}
    if embedding_optimizer:
        kw["sparse_embed_grads"] = True
    embed_kw = {}
    if table_dtype != "f32":
        embed_kw["param_dtype"] = TABLE_DTYPES[table_dtype]
    if embedding_engine:
        embed_kw.update(engine=embedding_engine, mesh=mesh)
    if embed_kw:
        kw["embed_kw"] = embed_kw
    return kw


def protocol_mesh(device=None):
    """The JAX runner's mesh for the sharded engines: (data, model) =
    (max(1, n // 2), min(2, n)) over the world's n ranks."""
    from recsys_tpu_torch.parallel.mesh import init_distributed, make_mesh

    _, n = init_distributed(device)
    return make_mesh(data=max(1, n // 2), model=min(2, n), device=device)


def _warm_process(schema, data, batch_size: int, device) -> None:
    """One throwaway 2-batch fit and predict of a DeepFM, so the kernels'
    build and CUDA's start-up stay out of the first model's ``seconds``."""
    t0 = time.time()
    small = {k: v[:2 * batch_size] for k, v in data.items()}
    tr = Trainer(DeepFM(schema), device=device)
    tr.fit(small, batch_size=batch_size, epochs=1, val_data=small, verbose=False)
    tr.predict(small)
    _log(f"process warmup {time.time() - t0:.1f}s (excluded from per-model seconds)")


def run_ctr(rows: int = 1_000_000, models=tuple(DEFAULT_CTR_MODELS.split(",")),
            embed_dim: int = 16, batch_size: int = 512, epochs: int = 10, seed: int = 0,
            patience: int | None = 1, lr: float = 1e-3,
            embedding_optimizer: str | None = None, teacher: str = "fm",
            embedding_lr: float | None = None, table_dtype: str = "f32",
            embedding_engine: str | None = None, device=None) -> dict:
    """The CTR AUC protocol on ``device`` (default the card); returns the
    report.  ``patience=None`` lifts early stopping (fixed ``epochs``);
    ``embedding_lr`` the embedding optimizer's rate (without an
    ``embedding_optimizer`` it goes unused, as in the JAX runner);
    ``table_dtype`` 'f32' or 'bf16' the tables'; ``embedding_engine``
    ('psum', 'dedup', 'a2a', 'a2a_pipelined') the sharded lookup on
    ``protocol_mesh``."""
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(f"table_dtype={table_dtype!r} not in {tuple(TABLE_DTYPES)}")
    t0 = time.time()
    schema, data, meta = realistic_criteo(num_examples=rows, embed_dim=embed_dim, seed=seed,
                                          teacher=teacher)
    _log(f"generated {rows} rows in {time.time() - t0:.1f}s "
         f"(ctr={meta['ctr']:.3f}, oracle AUC={meta['oracle_auc']:.4f})")
    idx = np.random.default_rng(seed).permutation(rows)
    cut = int(rows * 0.8)
    train = {k: v[idx[:cut]] for k, v in data.items()}
    test = {k: v[idx[cut:]] for k, v in data.items()}
    mesh = protocol_mesh(device) if embedding_engine else None
    _warm_process(schema, train, batch_size, device)

    out = {"rows": rows, "oracle_auc": round(meta["oracle_auc"], 4),
           "ctr": round(meta["ctr"], 4), "models": {}}
    if embedding_engine:
        out["embedding_engine"] = embedding_engine
    if embedding_optimizer:
        out["embedding_optimizer"] = embedding_optimizer
    out["teacher"] = teacher
    if table_dtype != "f32":
        out["table_dtype"] = table_dtype
    if patience is None:
        out["early_stopping"] = "lifted"
    n_fit = int(cut * 0.9)  # fit's training part after its validation split
    for name in models:
        t0 = time.time()
        torch.manual_seed(seed)  # each model's initial weights follow the seed alone
        tr = Trainer(CTR_MODELS[name](schema, **ctr_model_kwargs(
                         name, embedding_optimizer, table_dtype, embedding_engine, mesh)),
                     learning_rate=lr, embedding_optimizer=embedding_optimizer,
                     embedding_lr=embedding_lr if embedding_optimizer else None,
                     device=device, mesh=mesh)
        t_fit = time.time()
        hist = tr.fit(train, batch_size=batch_size, epochs=epochs, validation_split=0.1,
                      early_stopping_patience=patience, verbose=False)
        fit_s = time.time() - t_fit
        auc = tr.evaluate_auc(test)
        epochs_ran = len(hist["loss"])
        if "a2a_dropped" in hist:  # ids the capacity dropped, as the JAX report has them
            out.setdefault("a2a_dropped", {})[name] = int(sum(hist["a2a_dropped"]))
        out["models"][name] = {
            "test_auc": round(float(auc), 4),
            "pct_of_oracle": round(100 * (auc - 0.5) / (meta["oracle_auc"] - 0.5), 1),
            "epochs_ran": epochs_ran,
            "seconds": round(time.time() - t0, 1),
            "fit_examples_per_s": round(epochs_ran * (n_fit - n_fit % batch_size) / fit_s, 1),
        }
        _log(f"{name}: AUC {auc:.4f} ({out['models'][name]['pct_of_oracle']}% of oracle "
             f"margin, {epochs_ran} epochs, {out['models'][name]['seconds']}s)")
        del tr
    return out


def _warm_kernels(device) -> None:
    """Build the kernels before a timed fit, so nvcc stays out of
    ``fit_examples_per_s``."""
    if default_device(device).type == "cuda":
        build.libraries()


def _timed_fit(tr: Trainer, train: dict, batch_size: int, epochs: int, **kw):
    """``tr.fit``; returns (history, examples trained per second of fit)."""
    t0 = time.time()
    hist = tr.fit(train, batch_size=batch_size, epochs=epochs, **kw)
    n = len(next(iter(train.values())))
    b = min(batch_size, n)
    return hist, round(len(hist["loss"]) * (n - n % b) / (time.time() - t0), 1)


def ncf_loss(out, batch):
    return losses.pairwise_bce(out["pos_logits"], out["neg_logits"])


def ranked_eval(test: dict, readings: list | None = None):
    """NCF's ``fit`` hook: HR@10 and NDCG@10 of the test rows' positives
    among their negatives, each reading appended to ``readings`` (with the
    seconds it took) where given."""
    def eval_fn(trainer):
        t0 = time.time()
        out = trainer.predict(test)
        hr, ndcg = hit_rate_ndcg_at_k(out["pos_logits"], out["neg_logits"], k=10)
        if readings is not None:
            readings.append((hr, ndcg, time.time() - t0))
        return {"HR@10": hr, "NDCG@10": ndcg}
    return eval_fn


def run_ncf(users: int = 100_000, items: int = 20_000, batch_size: int = 1024,
            epochs: int = 8, seed: int = 0, device=None) -> dict:
    """NCF leave-last-2: one true negative a train positive and 100 a test
    user, pairwise BCE, Adam at 1e-3; HR@10 and NDCG@10 of each user's
    last item every second epoch, the last reading and the best reported
    (``fit_examples_per_s`` leaves the readings' time out)."""
    t0 = time.time()
    ratings = realistic_ratings(num_users=users, num_items=items, seed=seed)
    nu, ni, train, _, test = build_ncf_dataset_fast(ratings)
    _log(f"built {len(train['user'])} train rows / {nu} users / {ni} items "
         f"in {time.time() - t0:.1f}s")
    torch.manual_seed(seed)
    readings = []
    tr = Trainer(NCF(nu, ni), loss_fn=ncf_loss, learning_rate=1e-3, device=device)
    t0 = time.time()
    hist = tr.fit(train, batch_size=batch_size, epochs=epochs, verbose=True,
                  eval_fn=ranked_eval(test, readings), eval_every=2)
    fit_s = time.time() - t0 - sum(r[2] for r in readings)
    n = len(train["user"])
    b = min(batch_size, n)
    best = max(r[:2] for r in readings) if readings else (0.0, 0.0)
    last = readings[-1] if readings else (0.0, 0.0)
    return {"users": nu, "items": ni, "train_rows": n, "HR@10": round(last[0], 4),
            "NDCG@10": round(last[1], 4), "best_HR@10": round(best[0], 4),
            "random_HR@10": round(10 / 101, 4),
            "fit_examples_per_s": round(len(hist["loss"]) * (n - n % b) / fit_s, 1)}


def run_sasrec(users: int = 100_000, items: int = 20_000, maxlen: int = 50,
               batch_size: int = 256, epochs: int = 5, seed: int = 0,
               drift_scale: float = 6.0, device=None) -> dict:
    """SASRec leave-last-2 with 20 test negatives, all-position training
    with pairwise BCE, HR@10 and NDCG@10 of the last item."""
    t0 = time.time()
    ratings = realistic_ratings(num_users=users, num_items=items, seed=seed,
                                drift_scale=drift_scale)
    ni, train, _, test = build_sasrec_dataset(ratings, maxlen=maxlen, test_neg_num=20,
                                              all_positions=True, use_native="auto")
    _log(f"built {len(train['hist'])} train sequences / {ni} items in {time.time() - t0:.1f}s")
    _warm_kernels(device)
    torch.manual_seed(seed)
    model = SASRec(num_items=ni, embed_dim=64, max_len=maxlen)

    def loss_fn(out, batch):
        return losses.pairwise_bce(out["pos_logits"], out["neg_logits"], mask=out.get("mask"))

    tr = Trainer(model, loss_fn=loss_fn, learning_rate=1e-3, device=device)
    _, rate = _timed_fit(tr, train, batch_size, epochs, verbose=True)
    out = tr.predict(test)
    hr, ndcg = hit_rate_ndcg_at_k(out["pos_logits"], out["neg_logits"], k=10)
    return {"users": users, "items": ni, "maxlen": maxlen, "drift_scale": drift_scale,
            "HR@10": round(hr, 4), "NDCG@10": round(ndcg, 4),
            "random_HR@10": round(10 / 21, 4), "fit_examples_per_s": rate}


def run_din(users: int = 100_000, items: int = 20_000, maxlen: int = DIN_MAXLEN,
            batch_size: int = 1024, epochs: int = 3, seed: int = 0, device=None) -> dict:
    """DIN on the Amazon protocol over ``realistic_ratings`` with its item
    categories: histories of ``maxlen``, one true negative a positive, at
    most 12 train positions a user, the second-to-last position the
    validation set (early stopping, patience 1), the last the test set;
    test AUC."""
    t0 = time.time()
    ratings, meta = realistic_ratings(num_users=users, num_items=items, seed=seed,
                                      return_meta=True)
    schema, train, val, test = build_din_dataset_fast(
        ratings, meta["item_cate"], meta["num_cates"], maxlen=maxlen, max_train_positions=12,
        seed=seed)
    _log(f"built {len(train['label'])} train rows / {len(test['label'])} test rows "
         f"in {time.time() - t0:.1f}s")
    torch.manual_seed(seed)
    tr = Trainer(DIN(schema), learning_rate=1e-3, device=device)
    hist, rate = _timed_fit(tr, train, batch_size, epochs, val_data=val,
                            early_stopping_patience=1, verbose=True)
    auc = tr.evaluate_auc(test)
    return {"users": users, "items": items, "maxlen": maxlen,
            "train_rows": int(len(train["label"])), "test_auc": round(float(auc), 4),
            "epochs_ran": len(hist["loss"]), "fit_examples_per_s": rate}


def multitask_model(name: str, schema, tasks: tuple, labels: tuple, device=None):
    """The multi-task protocols' and CLI's model ``name`` (esmm, mmoe, ple)
    for two tasks read from the batch keys ``labels``: (model, loss_fn,
    heads, from_logits).  ESMM trains its ``ctr`` and ``ctcvr``
    probabilities with ``bce_probs`` (the first half of the sparse fields
    the user side); MMoE and PLE name their heads ``tasks`` and train their
    logits with ``multi_task_bce``.  ``heads`` are the outputs scored
    against ``labels``."""
    if name == "esmm":
        def loss_fn(out, batch):
            return losses.bce_probs(out["ctr"], batch[labels[0]]) + \
                losses.bce_probs(out["ctcvr"], batch[labels[1]])
        return (ESMM(schema, num_user_fields=len(schema.sparse) // 2, device=device), loss_fn,
                ("ctr", "ctcvr"), False)
    if name not in ("mmoe", "ple"):
        raise ValueError(f"unknown multi-task model {name!r}: choose from esmm, mmoe, ple")

    def loss_fn(out, batch):
        return losses.multi_task_bce(out, {t: batch[k] for t, k in zip(tasks, labels)})
    return ((MMoE if name == "mmoe" else PLE)(schema, task_names=tasks, device=device), loss_fn,
            tasks, True)


def head_aucs(preds: dict, test: dict, heads: tuple, labels: tuple, from_logits: bool,
              names: tuple) -> dict:
    """{f"auc_{name}": exact AUC of head against label} (sigmoid first for
    logits), rounded to 4 places."""
    out = {}
    for head, label, name in zip(heads, labels, names):
        p = preds[head]
        if from_logits:
            p = torch.sigmoid(torch.from_numpy(p)).numpy()
        out[f"auc_{name}"] = round(float(auc_exact(p, test[label])), 4)
    return out


def _warm_multitask(schema, data: dict, batch_size: int, device) -> None:
    """One throwaway 2-batch fit and predict of an MMoE over ``data``'s
    label keys, so CUDA's start-up stays out of the first model's
    ``seconds``."""
    t0 = time.time()
    small = {k: v[:2 * batch_size] for k, v in data.items()}
    label_keys = tuple(k for k in small if k not in ("dense", "sparse"))
    tasks = tuple(f"t{i}" for i in range(len(label_keys)))
    model, loss_fn, _, _ = multitask_model("mmoe", schema, tasks, label_keys)
    tr = Trainer(model, loss_fn=loss_fn, device=device)
    tr.fit(small, batch_size=batch_size, epochs=1, val_data=small, verbose=False)
    tr.predict(small)
    _log(f"process warmup {time.time() - t0:.1f}s (excluded from per-model seconds)")


def _fit_models(models, schema, train: dict, val: dict, test: dict, tasks: tuple,
                labels: tuple, names: tuple, batch_size: int, epochs: int, seed: int,
                device) -> dict:
    """Each multi-task model trained with early stopping on ``val``
    (patience 1), then its heads' test AUCs: {model: row}."""
    out = {}
    for name in models:
        t0 = time.time()
        torch.manual_seed(seed)
        model, loss_fn, heads, from_logits = multitask_model(name, schema, tasks, labels)
        tr = Trainer(model, loss_fn=loss_fn, learning_rate=1e-3, device=device)
        hist, rate = _timed_fit(tr, train, batch_size, epochs, val_data=val,
                                early_stopping_patience=1, verbose=False)
        row = {"epochs_ran": len(hist["loss"]), "seconds": round(time.time() - t0, 1),
               **head_aucs(tr.predict(test), test, heads, labels, from_logits, names),
               "fit_examples_per_s": rate}
        out[name] = row
        _log(f"{name}: {row}")
        del tr
    return out


def run_multitask(rows: int = 1_000_000, models=tuple(DEFAULT_MULTITASK_MODELS.split(",")),
                  batch_size: int = 512, epochs: int = 5, seed: int = 0, device=None) -> dict:
    """ESMM, MMoE and PLE on ``realistic_multitask`` rows: an 80/20 split
    by one permutation from the seed, 10% of train held out for validation
    (early stopping, patience 1), Adam at 1e-3; the exact AUC of the click
    and the click-and-convert heads, beside the generator's oracles."""
    t0 = time.time()
    schema, data, meta = realistic_multitask(num_examples=rows, seed=seed)
    _log(f"generated {rows} rows in {time.time() - t0:.1f}s (oracle ctr "
         f"{meta['oracle_auc_ctr']:.4f}, ctcvr {meta['oracle_auc_ctcvr']:.4f})")
    idx = np.random.default_rng(seed).permutation(rows)
    cut = int(rows * 0.8)
    train = {k: v[idx[:cut]] for k, v in data.items()}
    test = {k: v[idx[cut:]] for k, v in data.items()}
    _warm_multitask(schema, train, batch_size, device)
    fit_cut = int(cut * 0.9)  # fit's validation split, as validation_split=0.1 cuts it
    fit = {k: v[:fit_cut] for k, v in train.items()}
    val = {k: v[fit_cut:] for k, v in train.items()}
    labels = ("click", "ctcvr")
    return {"rows": rows, "oracle_auc_ctr": round(meta["oracle_auc_ctr"], 4),
            "oracle_auc_ctcvr": round(meta["oracle_auc_ctcvr"], 4),
            "models": _fit_models(models, schema, fit, val, test, labels, labels, labels,
                                  batch_size, epochs, seed, device)}


def run_census(rows: int = 200_000, models=tuple(DEFAULT_CENSUS_MODELS.split(",")),
               batch_size: int = 512, epochs: int = 5, seed: int = 0, device=None) -> dict:
    """The census-income protocol through the loader: ``realistic_census``
    rows (``rows`` train, half as many test) written to CSV files in a
    temporary directory and read back by ``census.create_census_dataset``
    (label parsing, per-column codes, the test file split 1:1 into val and
    test); MMoE and PLE with early stopping on val (patience 1); the exact
    AUC of the income and marital heads."""
    unknown = [m for m in models if m not in ("mmoe", "ple")]
    if unknown:
        raise ValueError(f"census protocol supports mmoe/ple, got {unknown}")
    t0 = time.time()
    n_test = max(rows // 2, 1)
    train_cols, test_cols, meta = realistic_census(num_train=rows, num_test=n_test, seed=seed)
    with tempfile.TemporaryDirectory(prefix="census_") as tmp:
        paths = (os.path.join(tmp, "census-income.data"), os.path.join(tmp, "census-income.test"))
        census.write_columns(paths[0], train_cols)
        census.write_columns(paths[1], test_cols)
        _log(f"generated census files ({rows}+{n_test} rows) in {time.time() - t0:.1f}s "
             f"(oracle income {meta['oracle_auc_income']:.4f}, marital "
             f"{meta['oracle_auc_marital']:.4f})")
        t0 = time.time()
        schema, train, val, test = census.create_census_dataset(*paths)
    _log(f"loader parsed + encoded in {time.time() - t0:.1f}s ({len(schema.sparse)} sparse, "
         f"{len(schema.dense)} dense fields)")
    _warm_multitask(schema, train, batch_size, device)
    return {"rows": rows, "oracle_auc_income": round(meta["oracle_auc_income"], 4),
            "oracle_auc_marital": round(meta["oracle_auc_marital"], 4),
            "models": _fit_models(models, schema, train, val, test, ("income", "marital"),
                                  ("label_income", "label_marital"), ("income", "marital"),
                                  batch_size, epochs, seed, device)}


def logq_softmax(log_q: torch.Tensor | None):
    """The retrieval models' loss: the in-batch sampled softmax of their
    {'user', 'item'} outputs, corrected by ``log_q[batch['item_id']]``
    (uncorrected when ``log_q`` is None)."""
    def loss_fn(out, batch):
        lq = None if log_q is None else log_q[batch["item_id"].long()]
        return losses.in_batch_sampled_softmax(out["user"], out["item"], item_log_q=lq)
    return loss_fn


def _retrieval_data(users: int, items: int, maxlen: int, seed: int):
    t0 = time.time()
    ratings = realistic_ratings(num_users=users, num_items=items, seed=seed)
    ni, train, test = build_seq_retrieval_dataset(ratings, maxlen=maxlen)
    _log(f"built {len(train['hist'])} train rows / {ni} items in {time.time() - t0:.1f}s")
    return ni, train, test


def run_seqret(users: int = 100_000, items: int = 20_000, maxlen: int = 50,
               batch_size: int = 1024, epochs: int = 5, seed: int = 0, device=None) -> dict:
    """YoutubeDNN next-item retrieval: the logQ-corrected in-batch softmax,
    then recall@10 over the whole catalog in 8192-user blocks (top-k
    kernel)."""
    ni, train, test = _retrieval_data(users, items, maxlen, seed)
    _warm_kernels(device)
    torch.manual_seed(seed)
    schema = FeatureSchema(varlen=[VarLenSparseFeature("hist_item", ni, 32, max_len=maxlen)])
    model = YoutubeDNN(schema, num_items=ni, embed_dim=32)
    dev = default_device(device)
    log_q = losses.popularity_log_q(np.bincount(train["item_id"], minlength=ni)).to(dev)
    tr = Trainer(model, loss_fn=logq_softmax(log_q), learning_rate=1e-3, device=dev)
    _, rate = _timed_fit(tr, train, batch_size, epochs, verbose=True)
    model.eval()
    hits = []
    with torch.inference_mode():
        item_embs = model.all_item_embeddings()
        for s in range(0, len(test["item_id"]), 8192):
            u = model.user_embed({"hist": torch.from_numpy(test["hist"][s:s + 8192]).to(dev)})
            hits.append(topk_scores(u, item_embs, k=10)[1].cpu().numpy())
    r = recall_at_k(np.concatenate(hits), test["item_id"])
    return {"users": users, "items": ni, "recall@10": round(r, 4),
            "random_recall@10": round(10 / ni, 5), "fit_examples_per_s": rate}


def merge_capsule_topk(values: np.ndarray, ids: np.ndarray, k: int) -> np.ndarray:
    """Each user's K capsules' top-k lists, (B, K·k) values and ids, merged
    into the k best distinct items: descending by value (a stable sort, so
    equal values keep their capsule order), each item at its first
    occurrence, padded with -1 where fewer than k are distinct.  Returns
    (B, k) int64.  Vectorised; the JAX runner loops over the rows."""
    order = np.argsort(-values, axis=1, kind="mergesort")
    ranked = np.take_along_axis(ids, order, 1).astype(np.int64)
    by_id = np.argsort(ranked, axis=1, kind="stable")  # earlier rank first
    sorted_ids = np.take_along_axis(ranked, by_id, 1)
    first_sorted = np.ones(ranked.shape, bool)
    first_sorted[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
    first = np.zeros(ranked.shape, bool)
    np.put_along_axis(first, by_id, first_sorted, 1)
    slot = np.cumsum(first, axis=1) - 1  # place among the distinct items
    keep = first & (slot < k)
    merged = np.full((ranked.shape[0], k), -1, np.int64)
    rows, cols = np.nonzero(keep)
    merged[rows, slot[rows, cols]] = ranked[rows, cols]
    return merged


MIND_BLOCK = 4096  # users a serving block of run_mind: 16,384 capsule queries
TOWER_BLOCK = 8192  # users (and catalog rows) a block of run_dssm


def mind_block_topk(model, hist: np.ndarray, item_embs: torch.Tensor, k: int = 10):
    """One serving block of ``run_mind``: the capsules of the (B, L) ``hist``
    ids, each capsule's top-k over ``item_embs`` (the top-k kernel on a card)
    and their merge.  Returns (queries (B·K, D), values, catalog rows, the
    merged (B, k) ids)."""
    caps = model.interests({"hist": torch.from_numpy(hist).to(item_embs.device)})
    b, km, d = caps.shape
    q = caps.reshape(b * km, d)
    v, i = topk_scores(q, item_embs, k=k)
    return q, v, i, merge_capsule_topk(v.cpu().numpy().reshape(b, km * k),
                                       i.cpu().numpy().reshape(b, km * k), k)


def run_mind(users: int = 100_000, items: int = 20_000, maxlen: int = 50,
             batch_size: int = 1024, epochs: int = 5, seed: int = 0, device=None) -> dict:
    """MIND multi-interest retrieval: the logQ-corrected in-batch softmax,
    then each capsule's top-10 over the whole catalog (top-k kernel on the
    (B·K, D) capsules, 4096 users a block), merged into 10 distinct items a
    user, and recall@10."""
    ni, train, test = _retrieval_data(users, items, maxlen, seed)
    _warm_kernels(device)
    torch.manual_seed(seed)
    model = MIND(num_items=ni, embed_dim=32, k_max=4)
    dev = default_device(device)
    log_q = losses.popularity_log_q(np.bincount(train["item_id"], minlength=ni)).to(dev)
    tr = Trainer(model, loss_fn=logq_softmax(log_q), learning_rate=1e-3, device=dev)
    _, rate = _timed_fit(tr, train, batch_size, epochs, verbose=True)
    model.eval()
    with torch.inference_mode():
        item_embs = model.all_item_embeddings()
        hits = [mind_block_topk(model, test["hist"][s:s + MIND_BLOCK], item_embs)[3]
                for s in range(0, len(test["item_id"]), MIND_BLOCK)]
    r = recall_at_k(np.concatenate(hits), test["item_id"])
    return {"users": users, "items": ni, "k_max": 4, "recall@10": round(r, 4),
            "random_recall@10": round(10 / ni, 5), "fit_examples_per_s": rate}


def dssm_user_feats(meta: dict, user_ids: np.ndarray) -> np.ndarray:
    """(B, 4) int32 user fields: id, age bin, gender, occupation."""
    return np.stack([user_ids.astype(np.int32), meta["user_age_bin"][user_ids],
                     meta["user_gender"][user_ids], meta["user_occupation"][user_ids]],
                    axis=1).astype(np.int32)


def dssm_item_feats(meta: dict, item_ids: np.ndarray) -> np.ndarray:
    """(B, 2) int32 item fields: id, category."""
    return np.stack([item_ids.astype(np.int32), meta["item_cate"][item_ids]],
                    axis=1).astype(np.int32)


def dssm_data(ratings: dict, meta: dict, items: int) -> dict:
    """The ``dssm`` protocol's arrays from ``realistic_ratings(...,
    return_meta=True)``: events stably sorted by (user, timestamp); each
    user's last event held out, a test pair where its rating is 3 or more;
    the rest train FM-match on rating >= 3 labels (``bce_train``) and the
    towers on their positives (``pair_train``, with ``pair_counts``, the
    positives' item counts for logQ); ``catalog`` holds items 1..items."""
    order = np.lexsort((ratings["timestamp"], ratings["user_id"]))  # stable
    u = np.asarray(ratings["user_id"])[order]
    i = np.asarray(ratings["item_id"])[order].astype(np.int32)
    rat = np.asarray(ratings["rating"])[order]
    uniq, starts, counts = np.unique(u, return_index=True, return_counts=True)
    last = starts + counts - 1
    is_last = np.zeros(len(u), bool)
    is_last[last] = True
    label = (rat >= 3).astype(np.float32)  # the reference's label threshold
    tr_mask = ~is_last
    test_ok = label[last] > 0  # a held-out item must pass the threshold
    pos = tr_mask & (label > 0)
    user_schema = FeatureSchema(sparse=[
        SparseFeature("user_id", int(u.max()) + 1, 16),
        SparseFeature("age_bin", 9, 16),
        SparseFeature("gender", 3, 16),
        SparseFeature("occupation", meta["num_occupations"], 16),
    ])
    item_schema = FeatureSchema(sparse=[
        SparseFeature("item_id", items + 1, 16),
        SparseFeature("cate", meta["num_cates"], 16),
    ])
    return {
        "user_schema": user_schema, "item_schema": item_schema,
        "bce_train": {"user_sparse": dssm_user_feats(meta, u[tr_mask]),
                      "item_sparse": dssm_item_feats(meta, i[tr_mask]),
                      "label": label[tr_mask]},
        "pair_train": {"user_sparse": dssm_user_feats(meta, u[pos]),
                       "item_sparse": dssm_item_feats(meta, i[pos]),
                       "item_id": i[pos].astype(np.int32)},
        "pair_counts": np.bincount(i[pos], minlength=items + 1),
        "test_users": uniq[test_ok], "test_items": i[last][test_ok],
        "catalog": dssm_item_feats(meta, np.arange(1, items + 1)),
    }


def tower_item_embeddings(model, catalog: np.ndarray, device) -> torch.Tensor:
    """The item tower over the (N, fields) ``catalog`` in TOWER_BLOCK rows."""
    return torch.cat([model.item_embed({"item_sparse": torch.from_numpy(
        catalog[s:s + TOWER_BLOCK]).to(device)}) for s in range(0, len(catalog), TOWER_BLOCK)])


def tower_block_topk(model, meta: dict, users: np.ndarray, item_embs: torch.Tensor,
                     k: int = 10):
    """One serving block of ``run_dssm``: the user tower on ``users``' side
    features and its top-k over ``item_embs`` (the catalog of items
    1..items; the top-k kernel on a card).  Returns (queries, values,
    catalog rows, item ids = rows + 1)."""
    q = model.user_embed({"user_sparse": torch.from_numpy(
        dssm_user_feats(meta, users)).to(item_embs.device)})
    v, i = topk_scores(q, item_embs, k=k)
    return q, v, i, i.cpu().numpy() + 1


def run_dssm(users: int = 100_000, items: int = 20_000,
             models=tuple(DEFAULT_DSSM_MODELS.split(",")), batch_size: int = 2048,
             epochs: int = 4, seed: int = 0, device=None) -> dict:
    """Two-tower retrieval with side features: DSSM and SENet-DSSM trained
    with the logQ-corrected in-batch softmax on positives, FM-match with
    BCE on rated pairs (label rating >= 3); recall@10 of each test user's
    last item over the whole catalog (top-k kernel, 8192 users a block)."""
    t0 = time.time()
    ratings, meta = realistic_ratings(num_users=users, num_items=items, seed=seed,
                                      return_meta=True)
    data = dssm_data(ratings, meta, items)
    _log(f"built {len(data['bce_train']['label'])} train rows / "
         f"{len(data['test_users'])} test users in {time.time() - t0:.1f}s")
    _warm_kernels(device)
    dev = default_device(device)
    out = {"users": users, "items": items, "random_recall@10": round(10 / items, 5),
           "models": {}}
    for name in models:
        t0 = time.time()
        torch.manual_seed(seed)
        if name == "fm_match":
            model = FMMatch(data["user_schema"], data["item_schema"])
            train = data["bce_train"]
            tr = Trainer(model, learning_rate=1e-3, device=dev)
        else:
            model = TwoTower(data["user_schema"], data["item_schema"], out_dim=32,
                             use_senet=(name == "senet"), output_mode="pair")
            train = data["pair_train"]
            log_q = losses.popularity_log_q(data["pair_counts"]).to(dev)
            tr = Trainer(model, loss_fn=logq_softmax(log_q), learning_rate=1e-3, device=dev)
        _, rate = _timed_fit(tr, train, batch_size, epochs, verbose=False)
        model.eval()
        with torch.inference_mode():
            item_embs = tower_item_embeddings(model, data["catalog"], dev)
            tu = data["test_users"]
            hits = [tower_block_topk(model, meta, tu[s:s + TOWER_BLOCK], item_embs)[3]
                    for s in range(0, len(tu), TOWER_BLOCK)]
        r = recall_at_k(np.concatenate(hits), data["test_items"])
        out["models"][name] = {"recall@10": round(r, 4),
                               "seconds": round(time.time() - t0, 1),
                               "fit_examples_per_s": rate}
        _log(f"{name}: recall@10 {r:.4f}")
        del tr
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.protocol")
    p.add_argument("mode", help=f"one of {', '.join(MODE_DEFAULTS)}")
    p.add_argument("--rows", type=int, default=0,
                   help="ctr and multitask rows (default 1,000,000), census train rows "
                        "(default 200,000)")
    p.add_argument("--users", type=int, default=100_000)
    p.add_argument("--items", type=int, default=20_000)
    p.add_argument("--models", default=None,
                   help=f"ctr: {DEFAULT_CTR_MODELS}; dssm: {DEFAULT_DSSM_MODELS}; "
                        f"multitask: {DEFAULT_MULTITASK_MODELS}; census: "
                        f"{DEFAULT_CENSUS_MODELS}")
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=0, help="0: the mode's default")
    p.add_argument("--epochs", type=int, default=0, help="0: the mode's default")
    p.add_argument("--maxlen", type=int, default=0,
                   help=f"history length (default 50; din {DIN_MAXLEN})")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--patience", type=int, default=1,
                   help="early-stopping patience (ctr); 0 lifts early stopping")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--teacher", default="fm", choices=["fm", "mlp"])
    p.add_argument("--embedding-optimizer", default=None,
                   choices=["lazy_adam", "rowwise_adagrad", "fused_adam",
                            "fused_rowwise_adagrad"])
    p.add_argument("--embedding-lr", type=float, default=None,
                   help="ctr: the embedding optimizer's own rate (unused without "
                        "--embedding-optimizer)")
    p.add_argument("--embedding-engine", default=None,
                   choices=["psum", "dedup", "a2a", "a2a_pipelined"],
                   help="ctr: the sharded table lookup, on the mesh (max(1, n // 2), "
                        "min(2, n)) of the world's n ranks")
    p.add_argument("--table-dtype", default="f32", choices=list(TABLE_DTYPES),
                   help="ctr: the tables' master dtype")
    p.add_argument("--drift-scale", type=float, default=6.0,
                   help="sasrec generator's sequence drift; 2.0 does not saturate HR@10")
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None, help="also write the JSON report here")
    args = p.parse_args(argv)
    if args.mode not in MODE_DEFAULTS:
        p.error(f"unknown mode {args.mode!r}: choose from {', '.join(MODE_DEFAULTS)}")
    if args.rows < 0:
        p.error(f"--rows must be positive, got {args.rows}")
    batch_size = args.batch_size or MODE_DEFAULTS[args.mode][0]
    epochs = args.epochs or MODE_DEFAULTS[args.mode][1]
    rows = args.rows or MODE_ROWS.get(args.mode)
    maxlen = args.maxlen or (DIN_MAXLEN if args.mode == "din" else 50)
    if args.mode == "ctr":
        rep = run_ctr(rows, (args.models or DEFAULT_CTR_MODELS).split(","),
                      args.embed_dim, batch_size, epochs, args.seed,
                      patience=args.patience or None, lr=args.lr,
                      embedding_optimizer=args.embedding_optimizer, teacher=args.teacher,
                      embedding_lr=args.embedding_lr, table_dtype=args.table_dtype,
                      embedding_engine=args.embedding_engine, device=args.device)
    elif args.mode == "ncf":
        rep = run_ncf(args.users, args.items, batch_size, epochs, args.seed, device=args.device)
    elif args.mode == "sasrec":
        rep = run_sasrec(args.users, args.items, maxlen, batch_size, epochs, args.seed,
                         drift_scale=args.drift_scale, device=args.device)
    elif args.mode == "seqret":
        rep = run_seqret(args.users, args.items, maxlen, batch_size, epochs, args.seed,
                         device=args.device)
    elif args.mode == "din":
        rep = run_din(args.users, args.items, maxlen, batch_size, epochs, args.seed,
                      device=args.device)
    elif args.mode == "multitask":
        rep = run_multitask(rows, (args.models or DEFAULT_MULTITASK_MODELS).split(","),
                            batch_size, epochs, args.seed, device=args.device)
    elif args.mode == "census":
        rep = run_census(rows, (args.models or DEFAULT_CENSUS_MODELS).split(","), batch_size,
                         epochs, args.seed, device=args.device)
    elif args.mode == "mind":
        rep = run_mind(args.users, args.items, maxlen, batch_size, epochs, args.seed,
                       device=args.device)
    else:
        rep = run_dssm(args.users, args.items, (args.models or DEFAULT_DSSM_MODELS).split(","),
                       batch_size, epochs, args.seed, device=args.device)
    rep["mode"] = args.mode
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        if os.path.getsize(args.out) <= 2:
            raise RuntimeError(f"the report written to {args.out!r} is empty")
    print(payload)


if __name__ == "__main__":
    main()

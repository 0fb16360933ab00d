"""Experiment runner CLI of the port (the counterpart of ``python -m
recsys_tpu.cli``): one entry point for the ported tasks, on the card unless
``--device`` names another.

    python -m recsys_tpu_torch.cli ctr --model fm|deepfm|widedeep|deepcrossing|dcn|dlrm|autoint
                                       [--data criteo.csv [--sample-num N] | --data 'day_*' --stream]
    python -m recsys_tpu_torch.cli din       [--reviews r.json --meta m.json]
    python -m recsys_tpu_torch.cli multitask --model esmm|mmoe|ple [--census train test]
    python -m recsys_tpu_torch.cli match     --model dssm|senet|fm [--ml100k DIR]
    python -m recsys_tpu_torch.cli ncf       [--ratings u.data]
    python -m recsys_tpu_torch.cli sasrec    [--ratings ratings.csv]
    python -m recsys_tpu_torch.cli youtube   [--ratings u.data|ratings.csv]
    python -m recsys_tpu_torch.cli mind      [--ratings u.data|ratings.csv]
        ... [--epochs 10] [--batch-size 512] [--lr 1e-3] [--device cpu]

Each task trains on the JAX CLI's synthetic data unless given files
(``synthetic_ctr`` rows; ``synthetic_ratings`` with ml-100k-shaped users
and items; ``synthetic_reviews`` for din; ``synthetic_multitask`` for
multitask) with its defaults: Adam at 1e-3; ``ctr``, ``din`` and
``multitask`` with early stopping (patience 1); ``ncf`` with HR@10 and
NDCG@10 every second epoch on its epoch lines; then prints the JAX CLI's
result line (``test AUC:``, ``<head> AUC:`` a head, ``test HR@10=...
NDCG@10=...`` or ``recall@10: ... over N items``), and returns a dict of
the fit's per-epoch ``loss`` and the printed metrics.

The files: ``ctr --data`` reads a Criteo CSV with a header and
label-encodes it (``--sample-num`` rows, when given); a glob, or
``--stream``, streams Criteo files through the C++ parser instead
(``data.streaming.CriteoStream``, categoricals hashed into 2^20 buckets a
field), trains on the stream with no validation and prints ``final train
loss:``.  ``match --ml100k`` reads an ml-100k directory, ``ncf --ratings``
its ``u.data``, ``sasrec``, ``youtube`` and ``mind --ratings`` a ratings
file (``u.data``, or an ml-latest CSV with a header).  ``din`` reads an
Amazon reviews and meta dump, ``multitask --census`` the census-income
train and test files.

``ctr`` also runs on a (data, model) mesh of processes, as the JAX CLI
runs on its devices: ``--mesh-model N`` row-shards the tables over a model
axis of N (the data axis takes the other ranks), ``--embedding-engine
psum|dedup|a2a|a2a_pipelined`` picks the sharded lookup (one group table,
so one a2a exchange a step) and ``--capacity-factor`` the a2a engines'
capacity (<= 0: the exact mode, nothing dropped).  Several ranks come from
torchrun (``torchrun --nproc-per-node 4 -m recsys_tpu_torch.cli ctr
--mesh-model 2 --embedding-engine a2a --device cpu``); without it the
mesh is one process.  Every rank reads the same data and prints its lines.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from recsys_tpu_torch.core.features import FeatureSchema, VarLenSparseFeature
from recsys_tpu_torch.data.amazon import (build_amazon_arrays, create_amazon_electronic_dataset,
                                          synthetic_reviews)
from recsys_tpu_torch.data.census import create_census_dataset
from recsys_tpu_torch.data.criteo import create_criteo_dataset
from recsys_tpu_torch.data.movielens import (build_ml100k_arrays, build_ncf_dataset,
                                             build_sasrec_dataset, build_seq_retrieval_dataset,
                                             create_ml_100k_dataset, create_ncf_dataset,
                                             read_ratings, synthetic_ratings,
                                             synthetic_user_item_frames)
from recsys_tpu_torch.data.streaming import CriteoStream
from recsys_tpu_torch.data.synthetic import synthetic_ctr, synthetic_multitask
from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.models.ctr.din import DIN
from recsys_tpu_torch.models.match.fm_match import FMMatch
from recsys_tpu_torch.models.match.mind import MIND
from recsys_tpu_torch.models.match.ncf import NCF
from recsys_tpu_torch.models.match.sasrec import SASRec
from recsys_tpu_torch.models.match.two_tower import DSSM, SENetDSSM
from recsys_tpu_torch.models.match.youtube_dnn import YoutubeDNN
from recsys_tpu_torch.parallel.mesh import make_mesh
from recsys_tpu_torch.tools.protocol import (CTR_MODELS, head_aucs, logq_softmax,
                                             multitask_model, ncf_loss, ranked_eval)
from recsys_tpu_torch.train import losses
from recsys_tpu_torch.train.loop import Trainer
from recsys_tpu_torch.train.metrics import hit_rate_ndcg_at_k, recall_at_k
from recsys_tpu_torch.train.retrieval import BruteForceIndex, topk_scores

DEFAULT_CAPACITY_FACTOR = 2.0  # the JAX CLI's; read by the a2a engines only


def ctr_mesh(args, kw: dict):
    """The mesh of ``ctr``'s flags (None without them and without a world
    of several ranks), with the tables' options it sets in ``kw``."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.mesh_model <= 1 and args.embedding_engine == "gather" and world == 1:
        return None
    mesh = make_mesh(model=max(args.mesh_model, 1), device=args.device)
    embed_kw = kw.setdefault("embed_kw", {})
    embed_kw["mesh"] = mesh  # tables built straight into their row shards
    if args.embedding_engine != "gather":
        # one group table: ONE a2a exchange pair a train step
        embed_kw.update(engine=args.embedding_engine, num_groups=1,
                        capacity_factor=(args.capacity_factor if args.capacity_factor > 0
                                         else None))  # <= 0: the exact mode
    return mesh


def run_ctr(args):
    stream = None
    if args.data and (args.stream or any(c in args.data for c in "*?[")):
        # the files stream chunk by chunk: host memory holds one chunk
        stream = CriteoStream(args.data, batch_size=args.batch_size, embed_dim=args.embed_dim)
        schema, train, test = stream.schema, stream, None
    elif args.data:
        schema, train, test = create_criteo_dataset(
            args.data, embed_dim=args.embed_dim, read_part=args.sample_num > 0,
            sample_num=args.sample_num)
    else:
        schema, data = synthetic_ctr(num_examples=20000, embed_dim=args.embed_dim, seed=0)
        cut = int(0.8 * len(data["label"]))
        train = {k: v[:cut] for k, v in data.items()}
        test = {k: v[cut:] for k, v in data.items()}
    kw = {}
    if args.embedding_optimizer:
        kw["sparse_embed_grads"] = True
    if args.bf16:
        if args.model != "dlrm":
            raise SystemExit("--bf16 compute is wired for --model dlrm")
        kw["compute_dtype"] = torch.bfloat16
    mesh = ctr_mesh(args, kw)
    tr = Trainer(CTR_MODELS[args.model](schema, **kw), learning_rate=args.lr,
                 embedding_optimizer=args.embedding_optimizer or None, device=args.device,
                 mesh=mesh)
    if stream is not None:
        hist = tr.fit(train, epochs=args.epochs)
        print(f"final train loss: {hist['loss'][-1]:.5f}")
        return {"loss": hist["loss"]}
    hist = tr.fit(train, batch_size=args.batch_size, epochs=args.epochs, validation_split=0.1,
                  early_stopping_patience=1)
    auc = tr.evaluate_auc(test)
    print(f"test AUC: {auc:.4f}")
    res = {"loss": hist["loss"], "auc": auc}
    if "a2a_dropped" in hist:
        res["a2a_dropped"] = hist["a2a_dropped"]
    return res


def run_match(args):
    if args.ml100k:
        user_schema, item_schema, train, test = create_ml_100k_dataset(
            args.ml100k, embed_dim=args.embed_dim)
    else:
        nu, ni = 300, 150
        users, items = synthetic_user_item_frames(nu, ni, seed=0)
        user_schema, item_schema, train, test = build_ml100k_arrays(
            synthetic_ratings(num_users=nu, num_items=ni), users, items,
            embed_dim=args.embed_dim)
    use_softmax = args.retrieval_loss == "softmax" and args.model != "fm"
    if args.model == "fm":
        model = FMMatch(user_schema, item_schema)
        dim, normalize = user_schema.embed_dim, False  # FM-match trains on inner products
    else:
        maker = SENetDSSM if args.model == "senet" else DSSM
        model = maker(user_schema, item_schema, out_dim=32, gamma=10.0,
                      output_mode="pair" if use_softmax else "score")
        dim, normalize = 32, True  # the towers train and score by cosine

    if use_softmax:
        # positives only, the in-batch items as negatives, logQ-corrected
        # unless --no-logq; --retrieval-loss bce is the reference protocol
        keep = train["label"] > 0.5
        train = {k: v[keep] for k, v in train.items()}
        log_q = None
        if args.logq:
            log_q = losses.popularity_log_q(np.bincount(
                train["item_sparse"][:, 0], minlength=item_schema.sparse[0].vocab_size)).to(
                default_device(args.device))

        def loss_fn(out, batch):
            lq = None if log_q is None else log_q[batch["item_sparse"][:, 0].long()]
            return losses.in_batch_sampled_softmax(
                F.normalize(out["user"], dim=-1, eps=1e-8),
                F.normalize(out["item"], dim=-1, eps=1e-8), item_log_q=lq, temperature=0.1)

        tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr, device=args.device)
        hist = tr.fit(train, batch_size=args.batch_size or 512, epochs=args.epochs)
    else:
        tr = Trainer(model, learning_rate=args.lr, device=args.device)
        hist = tr.fit(train, batch_size=args.batch_size or 512, epochs=args.epochs,
                      validation_split=0.1, early_stopping_patience=1)

    n_items = item_schema.sparse[0].vocab_size
    model.eval()
    pos = test["label"] > 0.5
    with torch.inference_mode():
        catalog = torch.arange(n_items, dtype=torch.int32, device=tr.device)[:, None]
        item_embs = model.item_embed({"item_sparse": catalog})
        u = model.user_embed({"user_sparse": torch.from_numpy(test["user_sparse"][pos]).to(
            tr.device)})
    index = BruteForceIndex(dim, normalize=normalize, device=tr.device)
    index.add(item_embs)
    _, ids = index.search(u, 10)
    r = recall_at_k(ids, test["item_sparse"][pos, 0])
    print(f"recall@10: {r:.4f} over {n_items} items (random {10 / n_items:.4f})")
    return {"loss": hist["loss"], "recall@10": r, "num_items": n_items}


def run_din(args):
    """DIN on an Amazon reviews and meta dump (``--reviews``, ``--meta``) or
    on ``synthetic_reviews(300, 100)`` at max_len 20; early stopping on the
    val split, then test AUC."""
    if args.reviews and args.meta:
        schema, train, val, test = create_amazon_electronic_dataset(
            args.reviews, args.meta, embed_dim=args.embed_dim)
    else:
        schema, train, val, test = build_amazon_arrays(
            *synthetic_reviews(num_users=300, num_items=100), embed_dim=args.embed_dim,
            maxlen=20)
    tr = Trainer(DIN(schema), learning_rate=args.lr, device=args.device)
    hist = tr.fit(train, batch_size=args.batch_size or 32, epochs=args.epochs, val_data=val,
                  early_stopping_patience=1)
    auc = tr.evaluate_auc(test)
    print(f"test AUC: {auc:.4f}")
    return {"loss": hist["loss"], "auc": auc}


def run_multitask(args):
    """ESMM, MMoE or PLE on the census-income files (``--census train
    test``: income and marital tasks) or on ``synthetic_multitask(20000)``
    (ctr and cvr, the last 20% the val and test rows); early stopping, then
    each head's exact AUC."""
    if args.census:
        schema, train, val, test = create_census_dataset(*args.census)
        tasks = ("income", "marital")
    else:
        schema, data = synthetic_multitask(num_examples=20000)
        flat = {"sparse": data["sparse"],
                **{f"label_{k}": v for k, v in data["labels"].items()}}
        cut = int(0.8 * len(data["sparse"]))
        train = {k: v[:cut] for k, v in flat.items()}
        test = val = {k: v[cut:] for k, v in flat.items()}
        tasks = ("ctr", "cvr")
    labels = tuple(f"label_{t}" for t in tasks)
    model, loss_fn, heads, from_logits = multitask_model(args.model, schema, tasks, labels)
    tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr, device=args.device)
    hist = tr.fit(train, batch_size=args.batch_size or 128, epochs=args.epochs, val_data=val,
                  early_stopping_patience=1)
    aucs = head_aucs(tr.predict(test), test, heads, labels, from_logits, heads)
    for head in heads:
        print(f"{head} AUC: {aucs[f'auc_{head}']:.4f}")
    return {"loss": hist["loss"], **aucs}


def run_ncf(args):
    """NCF on an ml-100k ``u.data`` (``--ratings``) or on
    ``synthetic_ratings(300, 150)``: pairwise BCE, HR@10 and NDCG@10 of the
    test rows every second epoch (on the epoch lines)."""
    if args.ratings:
        nu, ni, train, _, test = create_ncf_dataset(args.ratings)
    else:
        nu, ni, train, _, test = build_ncf_dataset(synthetic_ratings(num_users=300,
                                                                     num_items=150))
    tr = Trainer(NCF(nu, ni), loss_fn=ncf_loss, learning_rate=args.lr, device=args.device)
    hist = tr.fit(train, batch_size=args.batch_size or 128, epochs=args.epochs,
                  eval_fn=ranked_eval(test), eval_every=2)
    return {"loss": hist["loss"], **{k: hist[k] for k in ("HR@10", "NDCG@10") if k in hist}}


def _ratings(args) -> dict:
    """``--ratings``' file, or ``synthetic_ratings(300, 150)``."""
    if args.ratings:
        return read_ratings(args.ratings)
    return synthetic_ratings(num_users=300, num_items=150)


def run_sasrec(args):
    ni, train, _, test = build_sasrec_dataset(_ratings(args), maxlen=args.maxlen,
                                              all_positions=not args.sasrec_prefix)
    model = SASRec(num_items=ni, embed_dim=64, max_len=args.maxlen)

    def loss_fn(out, batch):
        return losses.pairwise_bce(out["pos_logits"], out["neg_logits"], mask=out.get("mask"))

    tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr, device=args.device)
    hist = tr.fit(train, batch_size=args.batch_size or 128, epochs=args.epochs, verbose=True)
    out = tr.predict(test)
    hr, ndcg = hit_rate_ndcg_at_k(out["pos_logits"], out["neg_logits"], k=10)
    print(f"test HR@10={hr:.4f} NDCG@10={ndcg:.4f}")
    return {"loss": hist["loss"], "HR@10": hr, "NDCG@10": ndcg, "num_items": ni,
            "train_rows": len(train["hist"]), "test_rows": len(test["hist"])}


def run_seq_retrieval(args):
    """YoutubeDNN or MIND: the in-batch sampled softmax, then recall@10 over
    the whole catalog."""
    ni, train, test = build_seq_retrieval_dataset(_ratings(args), maxlen=args.maxlen)
    if args.model == "mind":
        model = MIND(num_items=ni, embed_dim=args.embed_dim * 4, k_max=4)
    else:
        schema = FeatureSchema(varlen=[VarLenSparseFeature("hist_item", ni, args.embed_dim * 4,
                                                           max_len=args.maxlen)])
        model = YoutubeDNN(schema, num_items=ni, embed_dim=args.embed_dim * 4)
    # logQ from the train stream's item counts (ids 1-based, 0 the pad)
    log_q = losses.popularity_log_q(np.bincount(train["item_id"], minlength=ni)).to(
        default_device(args.device)) if args.logq else None
    tr = Trainer(model, loss_fn=logq_softmax(log_q), learning_rate=args.lr, device=args.device)
    hist = tr.fit(train, batch_size=args.batch_size or 256, epochs=args.epochs, verbose=True)
    model.eval()
    with torch.inference_mode():
        items = model.all_item_embeddings()
        queries = {"hist": torch.from_numpy(test["hist"]).to(tr.device)}
        if args.model == "mind":
            caps = model.interests(queries)  # (B, K, D)
            ids = torch.topk(torch.matmul(caps, items.T).amax(dim=1), 10).indices
        else:
            ids = topk_scores(model.user_embed(queries), items, k=10)[1]
    r = recall_at_k(ids.cpu().numpy(), test["item_id"])
    print(f"recall@10: {r:.4f} over {ni} items (random {10 / ni:.4f})")
    return {"loss": hist["loss"], "recall@10": r, "num_items": ni}


def _refuse(args) -> None:
    """SystemExit for the models ``multitask`` does not take."""
    if args.task == "multitask" and args.model not in ("esmm", "mmoe", "ple"):
        raise SystemExit(f"multitask takes --model esmm, mmoe or ple, not {args.model!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="recsys_tpu_torch")
    p.add_argument("task", choices=["ctr", "din", "multitask", "match", "ncf", "sasrec",
                                    "youtube", "mind"])
    p.add_argument("--model", default="fm")
    p.add_argument("--data", default=None,
                   help="criteo csv with a header, or a glob of criteo files to stream")
    p.add_argument("--stream", action="store_true",
                   help="stream --data through the C++ parser (hashed categoricals)")
    p.add_argument("--reviews", default=None)
    p.add_argument("--meta", default=None)
    p.add_argument("--census", nargs=2, default=None)
    p.add_argument("--ml100k", default=None)
    p.add_argument("--ratings", default=None)
    p.add_argument("--embed-dim", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--maxlen", type=int, default=50)
    p.add_argument("--sample-num", type=int, default=0,
                   help="read only the first N rows of --data")
    p.add_argument("--embedding-optimizer", default="",
                   choices=["", "lazy_adam", "rowwise_adagrad", "fused_adam",
                            "fused_rowwise_adagrad"],
                   help="table update of the ctr task: lazy_adam and rowwise_adagrad "
                        "update the touched rows only; fused_* run the fused "
                        "embedding-update kernels (exact dense semantics)")
    p.add_argument("--embedding-engine", default="gather",
                   choices=["gather", "psum", "dedup", "a2a", "a2a_pipelined"],
                   help="ctr: the sharded table lookup (a2a = all-to-all id exchange over "
                        "the model axis)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="ctr: model-axis size for row-sharding the tables (the data axis "
                        "takes the other ranks)")
    p.add_argument("--capacity-factor", type=float, default=DEFAULT_CAPACITY_FACTOR,
                   help="a2a engines' owner-bucket capacity; <= 0 is the exact mode")
    p.add_argument("--bf16", action="store_true", help="bf16 compute (DLRM)")
    p.add_argument("--retrieval-loss", choices=["softmax", "bce"], default="softmax")
    p.add_argument("--no-logq", dest="logq", action="store_false",
                   help="no logQ popularity correction in the in-batch softmax losses")
    p.add_argument("--sasrec-prefix", action="store_true",
                   help="exploded-prefix training instead of all-position")
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args(argv)
    _refuse(args)
    if args.task in ("youtube", "mind"):
        args.model = args.task
    return {"ctr": run_ctr, "din": run_din, "multitask": run_multitask, "match": run_match,
            "ncf": run_ncf, "sasrec": run_sasrec, "youtube": run_seq_retrieval,
            "mind": run_seq_retrieval}[args.task](args)


if __name__ == "__main__":
    main()

"""The CTR quality protocol on the port (the counterpart of the JAX
package's ``python -m recsys_tpu.tools.protocol ctr``):

    python -m recsys_tpu_torch.tools.protocol ctr [--rows 1000000] [--models fm,deepfm,...]
                                                  [--device cpu] [--out report.json]

``realistic_criteo`` rows (26 Zipfian fields at the Criteo vocabularies, 13
dense features), an 80/20 split by one permutation from the seed, 10% of
train held out for validation, Adam at 1e-3, batch 512, up to 10 epochs
with early stopping on the validation loss (patience 1, best weights
restored), then test AUC, also as a share of the generator's oracle margin.
It prints one JSON object, the JAX report's keys plus each model's
``fit_examples_per_s`` (examples trained per second of ``fit``, the
validation passes included).  Only the ``ctr`` mode is ported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from recsys_tpu_torch.data.realistic import realistic_criteo
from recsys_tpu_torch.models.ctr.autoint import AutoInt
from recsys_tpu_torch.models.ctr.dcn import DCN
from recsys_tpu_torch.models.ctr.deep_crossing import DeepCrossing
from recsys_tpu_torch.models.ctr.deepfm import DeepFM
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.models.ctr.fm import FM
from recsys_tpu_torch.models.ctr.wide_deep import WideDeep
from recsys_tpu_torch.train.loop import Trainer

CTR_MODELS = {"fm": FM, "deepfm": DeepFM, "widedeep": WideDeep,
              "deepcrossing": DeepCrossing, "dcn": DCN, "dlrm": DLRM, "autoint": AutoInt}
DEFAULT_CTR_MODELS = "fm,deepfm,widedeep,deepcrossing,dcn,dlrm,autoint"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ctr_model_kwargs(name: str, embedding_optimizer: str | None = None) -> dict:
    """The protocol's options for model ``name``: DLRM computes in bf16;
    a fused embedding optimizer needs the tables' tap."""
    kw = {"compute_dtype": torch.bfloat16} if name == "dlrm" else {}
    if embedding_optimizer:
        kw["sparse_embed_grads"] = True
    return kw


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
            device=None) -> dict:
    """The CTR AUC protocol on ``device`` (default the card); returns the
    report.  ``patience=None`` lifts early stopping (fixed ``epochs``)."""
    t0 = time.time()
    schema, data, meta = realistic_criteo(num_examples=rows, embed_dim=embed_dim, seed=seed,
                                          teacher=teacher)
    _log(f"generated {rows} rows in {time.time() - t0:.1f}s "
         f"(ctr={meta['ctr']:.3f}, oracle AUC={meta['oracle_auc']:.4f})")
    idx = np.random.default_rng(seed).permutation(rows)
    cut = int(rows * 0.8)
    train = {k: v[idx[:cut]] for k, v in data.items()}
    test = {k: v[idx[cut:]] for k, v in data.items()}
    _warm_process(schema, train, batch_size, device)

    out = {"rows": rows, "oracle_auc": round(meta["oracle_auc"], 4),
           "ctr": round(meta["ctr"], 4), "models": {}}
    if embedding_optimizer:
        out["embedding_optimizer"] = embedding_optimizer
    out["teacher"] = teacher
    if patience is None:
        out["early_stopping"] = "lifted"
    n_fit = int(cut * 0.9)  # fit's training part after its validation split
    for name in models:
        t0 = time.time()
        torch.manual_seed(seed)  # each model's initial weights follow the seed alone
        tr = Trainer(CTR_MODELS[name](schema, **ctr_model_kwargs(name, embedding_optimizer)),
                     learning_rate=lr, embedding_optimizer=embedding_optimizer,
                     device=device)
        t_fit = time.time()
        hist = tr.fit(train, batch_size=batch_size, epochs=epochs, validation_split=0.1,
                      early_stopping_patience=patience, verbose=False)
        fit_s = time.time() - t_fit
        auc = tr.evaluate_auc(test)
        epochs_ran = len(hist["loss"])
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.protocol")
    p.add_argument("mode", choices=["ctr"])
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--models", default=DEFAULT_CTR_MODELS)
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--patience", type=int, default=1,
                   help="early-stopping patience; 0 lifts early stopping")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--teacher", default="fm", choices=["fm", "mlp"])
    p.add_argument("--embedding-optimizer", default=None,
                   choices=["fused_adam", "fused_rowwise_adagrad"])
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None, help="also write the JSON report here")
    args = p.parse_args(argv)
    if args.rows <= 0:
        p.error(f"--rows must be positive, got {args.rows}")
    rep = run_ctr(args.rows, args.models.split(","), args.embed_dim, args.batch_size,
                  args.epochs, args.seed, patience=args.patience or None, lr=args.lr,
                  embedding_optimizer=args.embedding_optimizer, teacher=args.teacher,
                  device=args.device)
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

"""The DLRM family: the port's DLRM training step for a configuration
(``configs/<name>.json`` with ``"family": "dlrm"``), started from the
benchmark's own weights, and the plain reference run from the same start.

The system under test is ``recsys_tpu_torch.train.loop.Trainer.train_step``
on a ``recsys_tpu_torch.models.ctr.dlrm.DLRM`` built with
``sparse_embed_grads=True`` and the configuration's port options.  The
benchmark makes the weights from the seed on the device, in one generator
call a table and one a dense layer, and writes them into the program's
parameters; the reference draws the same values again by itself.

Leaves are named alike on both sides: ``bottom.{i}.weight``,
``bottom.{i}.bias``, ``top.{i}.weight``, ``top.{i}.bias`` and
``table.{t}``, one table a categorical field.
"""
from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import numpy as np
import torch

from benchkit.seeds import DENSE, TABLE, sub_seed

TABLE_SCALE = 0.05  # tables draw U[0, TABLE_SCALE), the port's own table law


def _reference():
    path = Path(__file__).resolve().parents[1] / "reference" / "dlrm.py"
    spec = importlib.util.spec_from_file_location("bench_reference_dlrm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dims(config: dict) -> dict:
    """The tower widths of a configuration: ``bottom`` and ``top`` as
    [in, hidden..., out], the fields F, the pairs P and D."""
    d = int(config["arch_sparse_feature_size"])
    rows = [int(v) for v in config["table_rows"]]
    bottom = [int(x) for x in config["arch_mlp_bot"]]
    if bottom[-1] != d:
        raise ValueError(f"the bottom MLP ends at {bottom[-1]}, not D = {d}")
    if config.get("arch_interaction_op", "dot") != "dot" or config.get(
            "arch_interaction_itself", False):
        raise ValueError("the family runs the dot interaction without self pairs")
    fields = len(rows)
    pairs = (fields + 1) * fields // 2
    top = [d + pairs] + [int(x) for x in config["arch_mlp_top"]]
    if top[-1] != 1:
        raise ValueError(f"the top MLP ends at {top[-1]}, not 1")
    return {"d": d, "rows": rows, "num_dense": bottom[0], "bottom": bottom, "top": top,
            "fields": fields, "pairs": pairs}


def make_dense(config: dict, seed: int, device) -> dict:
    """{leaf: tensor} of the MLPs: weights (out, in) normal of variance
    1/in, biases zero, from one generator."""
    dm = dims(config)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, DENSE))
    out = {}
    for tower in ("bottom", "top"):
        widths = dm[tower]
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            out[f"{tower}.{i}.weight"] = torch.randn((b, a), generator=gen,
                                                     device=device) * (1.0 / a) ** 0.5
            out[f"{tower}.{i}.bias"] = torch.zeros(b, device=device)
    return out


def fill_table(out: torch.Tensor, seed: int, t: int) -> torch.Tensor:
    """Field t's table drawn into ``out`` in place, in one generator call."""
    gen = torch.Generator(device=out.device).manual_seed(sub_seed(seed, TABLE, t))
    return out.uniform_(0.0, TABLE_SCALE, generator=gen)


class Program:
    """The port's DLRM and its ``Trainer`` for one configuration, holding
    the benchmark's weights for ``seed``."""

    def __init__(self, config: dict, seed: int, device):
        from recsys_tpu_torch.core.features import DenseFeature, FeatureSchema, SparseFeature
        from recsys_tpu_torch.models.ctr.dlrm import DLRM
        from recsys_tpu_torch.train.loop import Trainer

        sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (
            lambda: None)
        self.marks = []  # (set-up stage, time.time() at its end)
        dm, port = dims(config), config["port"]
        self.config, self.seed = config, seed
        self.b1 = float(port["adam"]["b1"])
        schema = FeatureSchema(
            dense=[DenseFeature(f"dense_{i}") for i in range(dm["num_dense"])],
            sparse=[SparseFeature(f"cat_{t}", v, dm["d"]) for t, v in enumerate(dm["rows"])])
        model = DLRM(schema, bottom_units=dm["bottom"][1:-1], top_units=dm["top"][1:-1],
                     compute_dtype=getattr(torch, port["compute_dtype"]),
                     fused_mlps=bool(port["fused_mlps"]),
                     dense_microbatch=int(port["dense_microbatch"]),
                     sparse_embed_grads=True,
                     embed_kw={"param_dtype": getattr(torch, port["table_dtype"])},
                     device=device)
        sync()
        self.marks.append(("DLRM built", time.time()))
        with torch.no_grad():
            for name, w in make_dense(config, seed, device).items():
                tower, i, kind = name.split(".")
                getattr(getattr(model, tower).layers[int(i)], kind).copy_(w)
            for t in range(dm["fields"]):
                fill_table(model.embedding.table(t).data, seed, t)
        sync()
        self.marks.append(("weights written", time.time()))
        self.model = model
        self.trainer = Trainer(model, learning_rate=float(port["learning_rate"]),
                               embedding_optimizer=port["embedding_optimizer"],
                               embedding_fused_bf16=bool(port["embedding_fused_bf16"]),
                               device=device)
        adam = port["adam"]
        opt = self.trainer.optimizer.defaults
        if (opt["betas"], opt["eps"]) != ((adam["b1"], adam["b2"]), adam["eps"]):
            raise ValueError(f"the program's Adam {opt['betas']}, {opt['eps']} is not the "
                             f"configuration's {adam}")

    def step(self, batch: dict) -> torch.Tensor:
        """The timed call: one ``Trainer.train_step`` on a host batch."""
        return self.trainer.train_step(batch)

    def dense_leaves(self) -> dict:
        out = {}
        for tower in ("bottom", "top"):
            for i, lin in enumerate(getattr(self.model, tower).layers):
                out[f"{tower}.{i}.weight"], out[f"{tower}.{i}.bias"] = lin.weight, lin.bias
        return out

    def check_steps(self, batches: list) -> dict:
        """Runs the first ``len(batches)`` steps through the timed call and
        reads: each step's loss, each leaf's first gradient as the
        optimizer holds it after step 1 (Adam's first moment over 1 - b1),
        and each leaf's change over the steps, against the weights drawn
        again from the seed."""
        dense0 = {k: p.detach().clone() for k, p in self.dense_leaves().items()}
        tables = self.trainer.tables()
        norm = torch.linalg.vector_norm
        losses = [float(self.step(batches[0]))]
        state = self.trainer.optimizer.state
        # a leaf the optimizer holds no moment of got no gradient
        grad = {k: float(norm(state[p]["exp_avg"])) / (1.0 - self.b1) if p in state else 0.0
                for k, p in self.dense_leaves().items()}
        for t in range(len(tables)):
            m = self.trainer.emb_state[f"table_{t}"]["m"]
            grad[f"table.{t}"] = float(norm(m)) / (1.0 - self.b1)
        losses += [float(self.step(b)) for b in batches[1:]]
        with torch.no_grad():
            change = {k: float(norm(p - dense0[k])) for k, p in self.dense_leaves().items()}
            for t in range(len(tables)):
                p = tables[f"table_{t}"]
                start = fill_table(torch.empty(p.shape, dtype=torch.float32, device=p.device),
                                   self.seed, t)
                change[f"table.{t}"] = float(norm(start.sub_(p.float())))
                del start
        return {"loss": losses, "grad_norm": grad, "change_norm": change}


def reference_readings(config: dict, seed: int, batches: list, device, *, quant=None,
                       half_batch: bool = False) -> dict:
    """The plain reference's readings of the same steps from the same
    start, on compact tables of the rows the batches touch."""
    dm, adam = dims(config), config["port"]["adam"]
    sparse = [torch.from_numpy(np.asarray(b["sparse"])).to(device).long() for b in batches]
    tables, rows = [], []
    for t, v in enumerate(dm["rows"]):
        used = torch.unique(torch.cat([s[:, t] for s in sparse]))
        full = fill_table(torch.empty((v, dm["d"]), device=device), seed, t)
        tables.append(full.index_select(0, used))
        rows.append(used)
        del full
    ref_batches = [{
        "sparse": torch.stack([torch.searchsorted(rows[t], s[:, t].contiguous()) for t in range(len(rows))],
                              1),
        "dense": torch.from_numpy(np.asarray(b["dense"])).to(device),
        "label": torch.from_numpy(np.asarray(b["label"])).to(device),
    } for s, b in zip(sparse, batches)]
    return _reference().train(make_dense(config, seed, device), tables, ref_batches,
                              lr=float(config["port"]["learning_rate"]), b1=adam["b1"],
                              b2=adam["b2"], eps=adam["eps"], quant=quant,
                              half_batch=half_batch)

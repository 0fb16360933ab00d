"""Rank-side cases of the multi-device checks.

Each function runs on every rank of a world started by
``parallel.spawn.spawn``: it builds its mesh, runs the port's code on its
part of the inputs and returns numpy results made whole (all-gathered over
the mesh), which the caller holds against a reference: the JAX package in
the CPU tests (``tests/test_torch_parallel*.py``), the gather and the
one-rank step on the card (``chip_smoke.py``).  The inputs are numpy
arrays; ``device`` is the ranks' (``cuda``: every rank on the current
card).  Nothing here imports JAX.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.parallel import embedding_sharding as es
from recsys_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_gather, all_reduce,
                                            make_mesh)

def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy (a CPU tensor's ``numpy()`` shares its memory, and the
    optimizers go on updating it in place)."""
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def data_rows(mesh, x):
    """This rank's rows of a global array (its data shard)."""
    n, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    b = len(x) // n
    return x[d * b:(d + 1) * b]


def lookups(shape, table: np.ndarray, rows: np.ndarray, weights: np.ndarray, cases,
            device: str = "cpu", only_rank0: bool = False) -> dict | None:
    """Each case ``(label, engine, kwargs)`` looks ``rows`` (global, split
    over the data axis) up in ``table`` row-sharded (column-sharded for
    ``cols``) over the model axis, and takes the gradient of
    ``sum(out * weights)``.  Returns {label: (out (whole batch), the whole
    table's gradient (summed over the data axis), dropped ids or None)}
    (None on every rank but 0 with ``only_rank0``)."""
    mesh = make_mesh(*shape, device=device)
    full = _tensor(table, device)
    rows_l = _tensor(data_rows(mesh, rows), device)
    w_l = _tensor(data_rows(mesh, weights), device)
    fns = {"psum": es.sharded_gather, "dedup": es.sharded_gather_dedup,
           "a2a": es.sharded_gather_a2a, "a2a_pipelined": es.sharded_gather_a2a_pipelined,
           "cols": es.sharded_gather_cols}
    out = {}
    for label, engine, kw in cases:
        cut = es.shard_table_cols if engine == "cols" else es.shard_table
        shard = cut(full, mesh).clone().requires_grad_()
        res = fns[engine](shard, rows_l, mesh, **kw)
        emb, dropped = res if isinstance(res, tuple) else (res, None)
        (emb.float() * w_l).sum().backward()
        grad = all_reduce(shard.grad, mesh, DATA_AXIS)
        grad = all_gather(grad, mesh, MODEL_AXIS, dim=1 if engine == "cols" else 0)
        out[label] = (_numpy(all_gather(emb.detach(), mesh, DATA_AXIS)), _numpy(grad),
                      None if dropped is None else int(dropped))
    return None if only_rank0 and mesh.rank else out


def unique_static(ids: np.ndarray) -> tuple:
    """``unique_with_counts_static`` on one rank (no mesh needed)."""
    u, inv = es.unique_with_counts_static(torch.from_numpy(ids))
    return u.numpy(), inv.numpy()


def topk(shape, queries: np.ndarray, items: np.ndarray, k: int, normalize: bool = False,
         device: str = "cpu") -> tuple:
    """``topk_scores_sharded`` on the mesh: (values, ids, launches of the
    top-k kernel on this rank)."""
    from recsys_tpu_torch.train.retrieval import topk_scores_sharded

    mesh = make_mesh(*shape, device=device)
    before = dispatch.LAUNCHES["topk_scores"]
    v, i = topk_scores_sharded(mesh, _tensor(queries, device), _tensor(items, device), k,
                               normalize)
    return _numpy(v), _numpy(i), dispatch.LAUNCHES["topk_scores"] - before


# -- training -----------------------------------------------------------------

def dlrm(schema, mesh=None, embed_mesh: bool = False, embed_kw: dict | None = None, **kw):
    """A DLRM of ``schema`` (``kw`` its options) for ``mesh``: its tables
    are built into their shards with ``embed_mesh``, and an explicit
    ``engine`` in ``embed_kw`` gets the mesh.  Bind the other arguments
    with ``functools.partial`` to make the ``model_fn`` of the cases."""
    from recsys_tpu_torch.models.ctr.dlrm import DLRM

    embed_kw = dict(embed_kw or {})
    if embed_mesh or embed_kw.get("engine", "gather") != "gather":
        embed_kw["mesh"] = mesh
    return DLRM(schema, embed_kw=embed_kw, **kw)


def whole_state(trainer, keep=None) -> dict:
    """The trainer's model state, embedding optimizer state and dense Adam
    first moments (``exp_avg.{name}``), each row-sharded tensor
    all-gathered over the model axis: {name: array},
    only the names that start with one of the prefixes ``keep`` (a tuple)
    when it is given."""
    out = {}
    for name, t in trainer.model.state_dict().items():
        if trainer.table_shards.get(name, 1) > 1:
            t = all_gather(t, trainer.mesh, MODEL_AXIS)
        if keep is None or name.startswith(keep):
            out[name] = _numpy(t)
    for name, st in (trainer.emb_state or {}).items():
        for k, t in st.items():
            if trainer._shards.get(name, 1) > 1:
                t = all_gather(t, trainer.mesh, MODEL_AXIS)
            if keep is None or f"emb_state.{name}.{k}".startswith(keep):
                out[f"emb_state.{name}.{k}"] = _numpy(t)
    for name, p in trainer.model.named_parameters():  # the dense Adam's first moment
        m = trainer.optimizer.state.get(p, {}).get("exp_avg")
        if m is not None and (keep is None or name.startswith(keep)):
            if trainer.table_shards.get(name, 1) > 1:
                m = all_gather(m, trainer.mesh, MODEL_AXIS)
            out[f"exp_avg.{name}"] = _numpy(m)
    return out


def _trainer(shape, model_fn, state, contract, trainer_kw, device, seed=None):
    from recsys_tpu_torch.train.loop import Trainer

    mesh = make_mesh(*shape, device=device) if shape is not None else None
    if seed is not None:
        torch.manual_seed(seed)
    model = model_fn(mesh)
    if state is not None:  # a whole state; a table built into its shard takes its rows
        from recsys_tpu_torch.parallel.sharding_rules import shard_state

        whole = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
        if mesh is not None:
            cut, mine = shard_state(whole, model, mesh), model.state_dict()
            whole = {k: cut[k] if cut[k].shape == mine[k].shape else v
                     for k, v in whole.items()}
        model.load_state_dict(whole)
    return Trainer(model, mesh=mesh, data_contract=contract, device=device, **trainer_kw)


def train_steps(shape, model_fn, state: dict | None, batches: list, contract: str = "global",
                trainer_kw: dict | None = None, device: str = "cpu",
                count_launches: bool = False, seed: int | None = None,
                keep=None, first_state: bool = False, only_rank0: bool = False) -> dict:
    """``Trainer.train_step`` over the global ``batches`` (this rank's rows
    of each under the local contract) from the whole ``state`` (None: the
    init of ``model_fn(mesh)`` after ``torch.manual_seed(seed)``), on the
    mesh of ``shape`` (None: no mesh).  Returns {'losses', 'state' (whole,
    the names that ``keep``'s prefixes start), with ``first_state`` also
    'first_state' (the same after the first step), 'dropped', 'launches'
    (the kernels' counts over the steps, with ``count_launches``),
    'seconds' (the steps' after the first)}; with ``only_rank0`` the
    states on rank 0 only."""
    tr = _trainer(shape, model_fn, state, contract, trainer_kw or {}, device, seed)
    if contract == "local" and tr.mesh is not None:
        batches = [{k: data_rows(tr.mesh, v) for k, v in b.items()} for b in batches]
    if only_rank0 and tr.mesh is not None and tr.mesh.rank:
        keep = ()  # gathered with every rank, kept on rank 0
    before = dict(dispatch.LAUNCHES)
    out = {"losses": [], "dropped": []}
    for i, batch in enumerate(batches):
        if i == 1:
            t0 = time.perf_counter()
        out["losses"].append(float(tr.train_step(batch)))
        out["dropped"].append(None if tr.last_dropped is None else int(tr.last_dropped))
        if i == 0 and first_state:
            out["first_state"] = whole_state(tr, keep)
    out["seconds"] = time.perf_counter() - t0 if len(batches) > 1 else None
    launches = {k: v - before[k] for k, v in dispatch.LAUNCHES.items() if v != before[k]}
    out["launches"] = launches if count_launches else None
    out["state"] = whole_state(tr, keep)
    return out


def fit(shape, model_fn, state, data: dict, fit_kw: dict, contract: str = "global",
        trainer_kw: dict | None = None, device: str = "cpu", predict: bool = True,
        eval_batch: int | None = None) -> dict:
    """``Trainer.fit`` on the mesh (under the local contract each rank
    gets its data shard's rows), then ``evaluate_loss``, ``evaluate_auc``
    and (global contract) ``predict`` over ``data`` in batches of
    ``eval_batch`` (default the fit's); 'state' is the whole state after."""
    tr = _trainer(shape, model_fn, state, contract, trainer_kw or {}, device)
    mine = data if contract == "global" or tr.mesh is None else \
        {k: data_rows(tr.mesh, v) for k, v in data.items()}
    hist = tr.fit(mine, verbose=False, **fit_kw)
    bs = eval_batch or fit_kw.get("batch_size", 512)
    out = {"history": hist, "loss": tr.evaluate_loss(mine, bs), "auc": tr.evaluate_auc(mine, bs),
           "state": whole_state(tr)}
    if predict:
        out["predict"] = tr.predict(mine, bs)
    return out


def checkpoint(shape, other_shape, path: str, model_fn, batches: list,
               trainer_kw: dict | None = None, device: str = "cpu") -> dict:
    """Train a step, ``save_sharded`` under ``path``, restore into a fresh
    trainer of another init on the same mesh, and into one on
    ``other_shape``.  Returns {'equal': restored state bit-equal,
    'table_share': the largest share of a sharded table in one saved
    block, 'refused': the
    other mesh's error or None, 'next_loss_equal': the next step's loss
    after the restore equals the saved trainer's}."""
    from recsys_tpu_torch.train.checkpoint import restore_sharded, save_sharded

    torch.manual_seed(0)
    tr = _trainer(shape, model_fn, None, "global", trainer_kw or {}, device)
    tr.train_step(batches[0])
    save_sharded(path, tr)
    torch.manual_seed(1)
    fresh = _trainer(shape, model_fn, None, "global", trainer_kw or {}, device)
    restore_sharded(path, fresh)
    a, b = whole_state(tr), whole_state(fresh)
    equal = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a) and \
        fresh.step == tr.step
    # the largest share of a row-sharded table that one saved block holds
    share = 0.0
    for f in os.listdir(path):
        if f.startswith("manifest_r"):
            with open(os.path.join(path, f)) as fh:
                for e in json.load(fh):
                    if tr.table_shards.get(e["key"][len("model."):], 1) > 1:
                        share = max(share, (e["rows"][1] - e["rows"][0]) / e["shape"][0])
    next_equal = float(tr.train_step(batches[1])) == float(fresh.train_step(batches[1]))
    refused = None
    other = _trainer(other_shape, model_fn, None, "global", trainer_kw or {}, device)
    try:
        restore_sharded(path, other)
    except ValueError as e:
        refused = str(e)
    return {"equal": equal, "table_share": share, "refused": refused,
            "next_loss_equal": next_equal}


def run_jobs(jobs: list) -> list:
    """[fn(*args, **kwargs) for (fn, args, kwargs) in jobs]: several cases
    in one spawned world."""
    return [fn(*args, **kw) for fn, args, kw in jobs]


def mesh_facts(shape, model_fn, device: str = "cpu") -> dict:
    """This rank's place on the mesh of ``shape``, its axis groups, the
    sharding rules' placement of ``model_fn(mesh)`` (built after
    ``torch.manual_seed(0)``) and its tables made whole, and the mesh's
    refusals: another shape of the world, and ``predict`` under the local
    contract."""
    from recsys_tpu_torch.parallel.sharding_rules import param_shardings
    from recsys_tpu_torch.train.loop import Trainer

    mesh = make_mesh(*shape, device=device)
    torch.manual_seed(0)
    model = model_fn(mesh)
    tables = {}
    for name, t in model.state_dict().items():
        if name.startswith("embedding.table_"):
            g = int(name.rsplit("_", 1)[1])
            k = model.embedding.table_shards.get(g, 1)
            tables[name] = _numpy(all_gather(t, mesh, MODEL_AXIS) if k > 1 else t)
    errors = {}
    try:
        make_mesh(mesh.size(DATA_AXIS) + 1, mesh.size(MODEL_AXIS), device=device)
    except ValueError as e:
        errors["make_mesh"] = str(e)
    tr = Trainer(model, mesh=mesh, data_contract="local", device=device)
    try:
        tr.predict({"sparse": np.zeros((4, len(model.schema.sparse)), np.int32),
                    "dense": np.zeros((4, model.schema.num_dense), np.float32)})
    except NotImplementedError as e:
        errors["predict"] = str(e)
    return {"coords": (mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS)),
            "ranks": {a: mesh.ranks(a) for a in (DATA_AXIS, MODEL_AXIS)},
            "shardings": param_shardings(model, mesh), "tables": tables,
            "table_shards": dict(model.embedding.table_shards), "errors": errors}

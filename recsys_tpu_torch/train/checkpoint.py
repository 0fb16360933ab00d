"""Checkpoints of a ``Trainer`` (the port of
``recsys_tpu/train/checkpoint.py``): ``save``/``restore`` of the whole
state in one file, and ``save_sharded``/``restore_sharded`` on a mesh.

A checkpoint holds what the JAX package's ``TrainState`` holds: the step
count, the model's ``state_dict`` (parameters, the embedding tables among
them, and BatchNorm buffers), the dense optimizer's ``state_dict`` and the
embedding optimizer's state (``emb_state``: Adam's m and v, or rowwise
AdaGrad's acc).  The files are ``torch.save``'s, read back with
``torch.load(weights_only=True)`` onto the trainer's device.

The sharded form is a directory: every rank writes the blocks it holds
the first replica of (a row-sharded table's rows and their optimizer state
by the ranks of data index 0, every other tensor by rank 0), one block a
file ``r{rank}_{n}.pt``, and a manifest ``manifest_r{rank}.json`` of each
block's tensor, global shape and row range; rank 0 also writes
``skeleton.pt``, the state with its tensors named.  No rank ever holds a
whole sharded table.  Restore gives each rank exactly its blocks, and
refuses a checkpoint whose blocks do not match the trainer's layout (a
changed mesh).
"""
from __future__ import annotations

import json
import os

import torch
import torch.distributed as dist


def save(path: str, trainer) -> None:
    """Write ``trainer``'s state to ``path`` (its directory made as needed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_state(trainer), tmp)
    os.replace(tmp, path)  # a reader never sees half a checkpoint


def restore(path: str, trainer):
    """Load the checkpoint at ``path`` into ``trainer`` (built like the one
    saved: same model, optimizers and embedding optimizer) in place;
    returns ``trainer``."""
    _load(torch.load(path, map_location=trainer.device, weights_only=True), trainer, path)
    return trainer


def _load(state: dict, trainer, path: str) -> None:
    mine = trainer.emb_state or {}
    if ({n: sorted(st) for n, st in state["emb_state"].items()}
            != {n: sorted(st) for n, st in mine.items()}):
        raise ValueError(f"{path}: embedding optimizer state of tables "
                         f"{sorted(state['emb_state'])}, the trainer has {sorted(mine)}")
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    with torch.no_grad():
        for name, st in state["emb_state"].items():
            for k, v in st.items():
                mine[name][k].copy_(v)
    trainer.step = int(state["step"])


def _state(trainer) -> dict:
    return {"step": trainer.step, "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.state_dict(), "emb_state": trainer.emb_state or {}}


def _sharded_keys(trainer) -> set:
    """The flattened keys of the tensors that are row shards on a mesh: the
    sharded tables, their optimizer state and their dense Adam moments."""
    tables = {n for n, k in trainer.table_shards.items() if k > 1}
    keys = {f"model.{n}" for n in tables}
    keys |= {f"emb_state.{n.rsplit('.', 1)[-1]}.{k}"
             for n in tables for k in ("m", "v", "acc")}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    params = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    keys |= {f"optimizer.state.{i}.{k}" for i, p in enumerate(params)
             if names.get(id(p)) in tables for k in ("exp_avg", "exp_avg_sq")}
    return keys


def _flatten(tree, prefix: str, out: dict):
    """``tree`` with every tensor replaced by its key, the tensors in ``out``."""
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
        return {"__tensor__": prefix}
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, f"{prefix}.{i}", out) for i, v in enumerate(tree))
    return tree


def _unflatten(tree, tensors: dict):
    if isinstance(tree, dict):
        if set(tree) == {"__tensor__"}:
            return tensors[tree["__tensor__"]]
        return {k: _unflatten(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, tensors) for v in tree)
    return tree


def _blocks(trainer) -> tuple[dict, dict]:
    """(skeleton, {key: (tensor, global shape, [row lo, row hi], whether
    this rank holds its first replica)}) of this rank's state."""
    tensors = {}
    skeleton = _flatten(_state(trainer), "", tensors)
    mesh, sharded = trainer.mesh, _sharded_keys(trainer)
    rank = 0 if mesh is None else mesh.rank
    out = {}
    for key, t in tensors.items():
        if key in sharded and t.dim() >= 1:
            n, s = mesh.size("model"), mesh.index("model")
            rows = t.shape[0]
            out[key] = (t, [rows * n, *t.shape[1:]], [s * rows, (s + 1) * rows],
                        mesh.index("data") == 0)
        else:
            rows = t.shape[0] if t.dim() else 0
            out[key] = (t, list(t.shape), [0, rows], rank == 0)
    return skeleton, out


def save_sharded(path: str, trainer) -> None:
    """Write this rank's blocks of ``trainer``'s state under the directory
    ``path`` (every rank calls it with the same path), one block a file."""
    os.makedirs(path, exist_ok=True)
    skeleton, blocks = _blocks(trainer)
    rank = 0 if trainer.mesh is None else trainer.mesh.rank
    manifest = []
    for key, (t, shape, rows, first) in blocks.items():
        if not first:
            continue  # another rank holds this block's first replica
        name = f"r{rank}_{len(manifest)}.pt"
        torch.save(t.detach().cpu().clone(), os.path.join(path, name))
        manifest.append({"key": key, "file": name, "shape": shape, "rows": rows})
    if rank == 0:
        torch.save(skeleton, os.path.join(path, "skeleton.pt"))
    with open(os.path.join(path, f"manifest_r{rank}.json"), "w") as f:
        json.dump(manifest, f)
    if dist.is_initialized():
        dist.barrier()


def restore_sharded(path: str, trainer):
    """Load a ``save_sharded`` checkpoint into ``trainer`` (built like the
    one saved, on a mesh of the same model axis) in place: each tensor from
    the block of this rank's rows; returns ``trainer``.  Raises ValueError
    where no block matches (the mesh or the model changed)."""
    blocks = {}  # key: [(global shape, row range, file)]
    for name in sorted(os.listdir(path)):
        if name.startswith("manifest_r"):
            with open(os.path.join(path, name)) as f:
                for e in json.load(f):
                    blocks.setdefault(e["key"], []).append((e["shape"], e["rows"], e["file"]))
    skeleton = torch.load(os.path.join(path, "skeleton.pt"), weights_only=True)
    sharded, mesh = _sharded_keys(trainer), trainer.mesh
    tensors = {}
    for key, found in blocks.items():
        shape = found[0][0]
        rows = shape[0] if shape else 0
        want = [0, rows]
        if key in sharded:
            n, s = mesh.size("model"), mesh.index("model")
            want = [s * rows // n, (s + 1) * rows // n]
        f = next((f for _, r, f in found if r == want), None)
        if f is None:
            raise ValueError(f"{path}: no saved block of {key} {shape} holds rows {want} "
                             "(mesh or model changed since the save?)")
        tensors[key] = torch.load(os.path.join(path, f), map_location=trainer.device,
                                  weights_only=True)
    _load(_unflatten(skeleton, tensors), trainer, path)
    return trainer


class BestCheckpointer:
    """Keeps the best checkpoint on disk: ``update(metric, trainer)`` saves
    when ``metric`` beats the best so far (lower is better with
    ``mode='min'``) and returns whether it did; ``sharded`` writes the
    sharded form (``path`` a directory)."""

    def __init__(self, path: str, mode: str = "min", sharded: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode={mode!r} not in ('min', 'max')")
        self.path = path
        self.mode = mode
        self.sharded = sharded
        self.best: float | None = None

    def update(self, metric: float, trainer) -> bool:
        better = (self.best is None or (self.mode == "min" and metric < self.best)
                  or (self.mode == "max" and metric > self.best))
        if better:
            self.best = metric
            (save_sharded if self.sharded else save)(self.path, trainer)
        return better

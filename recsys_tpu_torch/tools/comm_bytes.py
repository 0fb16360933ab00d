"""The bytes each embedding engine's collectives move a step, counted (the
port of ``recsys_tpu/tools/comm_bytes.py``).

The a2a engines exist for their traffic: a rank sends O(N/S) ids and
O(N·D/S) vectors each way, where the psum engine sums the whole (N, D)
output over the model axis.  Each rank of a (data, model) world looks its
data shard's ids up through every engine (psum, dedup, a2a, a2a at
capacity factor 1.25, a2a with dedup, a2a_pipelined) and takes the gradient
of ``sum(out**2)`` with respect to its table shard, inside
``Mesh.tally``: each collective call adds its count and its result's bytes
(``parallel/mesh.py``).  The JAX tool reads the same from compiled HLO.

``shard_grad_sync`` is the one collective after the lookup that every
engine shares: the all-reduce of the shard's gradient over the data axis
(``Trainer`` sums the gradients so).  The JAX tool's pattern does not
match that all-reduce, the HLO's ROOT instruction, so its engines' counts
leave it out; so do the port's.

The world runs through ``parallel/spawn.py``: gloo ranks on the CPU
(``--device cpu``), NCCL across cards where there are as many as ranks,
else gloo ranks on the one card.  Counts are a property of the program,
so every backend and device reads the same.

Run: python -m recsys_tpu_torch.tools.comm_bytes [--data 4] [--model 2]
        [--batch 4096] [--vocab 100000] [--d 16] [--fields 8]
        [--device cpu] [--out FILE]
One JSON object on stdout, a table on stderr; bytes are per rank per step
of an f32 table.  A table of another dtype moves its own element size:
the tally counts each tensor in its logical dtype.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.parallel import embedding_sharding as es
from recsys_tpu_torch.parallel.mesh import DATA_AXIS, all_reduce, make_mesh
from recsys_tpu_torch.parallel.spawn import spawn
from recsys_tpu_torch.tools.mesh_check import data_rows

DTYPE = "float32"  # the table's, as the JAX tool's

# engine -> (lookup, its options), the JAX tool's six
ENGINES = {
    "psum": (es.sharded_gather, {}),
    "dedup": (es.sharded_gather_dedup, {}),
    "a2a": (es.sharded_gather_a2a, {"dedup": False}),
    "a2a_cf1.25": (es.sharded_gather_a2a, {"capacity_factor": 1.25}),
    "a2a_dedup": (es.sharded_gather_a2a, {"dedup": True}),
    "a2a_pipelined": (es.sharded_gather_a2a_pipelined, {"dedup": True}),
}


def inputs(batch: int, vocab: int, d: int, fields: int, n_model: int, seed: int = 0):
    """(table (V, D) f64, rows (batch, fields) int32) drawn as the JAX tool
    draws them; V is ``vocab`` padded to a multiple of the model axis."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab + (-vocab) % n_model, d))
    rows = rng.integers(0, vocab, (batch, fields)).astype(np.int32)
    return table, rows


def rank_counts(shape, batch: int, vocab: int, d: int, fields: int, dtype: str = DTYPE,
                device: str = "cpu", seed: int = 0) -> dict:
    """On one rank of a world of ``shape`` = (data, model): {'engines':
    {engine: {kind: {'count', 'bytes'}}}, 'shard_grad_sync': {kind: ...}}."""
    mesh = make_mesh(*shape, device=device)
    table, rows = inputs(batch, vocab, d, fields, shape[1], seed)
    full = torch.from_numpy(table).to(device=device, dtype=getattr(torch, dtype))
    shard = es.shard_table(full, mesh).clone().requires_grad_()
    rows_l = torch.from_numpy(data_rows(mesh, rows)).to(device)
    out = {"engines": {}}
    for engine, (lookup, kw) in ENGINES.items():
        with mesh.tally() as ops:
            emb = lookup(shard, rows_l, mesh, **kw)
            (grad,) = torch.autograd.grad((emb.float() ** 2).sum(), shard)
        out["engines"][engine] = ops
    with mesh.tally() as ops:
        all_reduce(grad, mesh, DATA_AXIS)
    out["shard_grad_sync"] = ops
    return out


def backend_for(device: torch.device, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def run(shape=(4, 2), batch: int = 4096, vocab: int = 100_000, d: int = 16, fields: int = 8,
        *, device) -> dict:
    backend = backend_for(device, shape[0] * shape[1])
    ranks = spawn(rank_counts, shape[0] * shape[1], shape, batch, vocab, d, fields, DTYPE,
                  device.type, device=device.type, backend=backend)
    return report(ranks, shape, batch, vocab, d, fields, backend, device)


def report(ranks: list, shape, batch: int, vocab: int, d: int, fields: int, backend: str,
           device) -> dict:
    """The tool's report from every rank's ``rank_counts``."""
    if any(r != ranks[0] for r in ranks[1:]):
        raise RuntimeError(f"comm_bytes: the ranks' counts differ: {ranks}")
    got = ranks[0]
    rep = {"mesh": {"data": shape[0], "model": shape[1]}, "batch": batch, "vocab": vocab,
           "d": d, "fields": fields, "dtype": DTYPE, "backend": backend,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "note": "bytes are per rank per train step, counted at the port's collective calls",
           "engines": {}, "shard_grad_sync": got["shard_grad_sync"]}
    for engine, ops in got["engines"].items():
        rep["engines"][engine] = {"total_bytes": sum(e["bytes"] for e in ops.values()),
                                  "ops": ops}
    base = rep["engines"]["psum"]["total_bytes"]
    for e in rep["engines"].values():
        e["vs_psum"] = e["total_bytes"] / base if base else None
    return rep


def main(argv=None):
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.comm_bytes")
    p.add_argument("--data", type=int, default=4)
    p.add_argument("--model", type=int, default=2)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--vocab", type=int, default=100_000)
    p.add_argument("--d", type=int, default=16)
    p.add_argument("--fields", type=int, default=8)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rep = run((args.data, args.model), args.batch, args.vocab, args.d, args.fields,
              device=default_device(args.device))

    w = sys.stderr.write
    w(f"mesh={rep['mesh']} batch={rep['batch']} x {rep['fields']} fields, "
      f"vocab={rep['vocab']}, D={rep['d']} {rep['dtype']}, {rep['backend']} on {rep['device']}\n")
    w(f"{'engine':<14}{'collective bytes/step':>22}{'vs psum':>9}  ops\n")
    for name, e in rep["engines"].items():
        ops = ", ".join(f"{k} x{v['count']}" for k, v in e["ops"].items())
        w(f"{name:<14}{e['total_bytes']:>22,}{e['vs_psum']:>9.4f}  {ops}\n")
    w(f"shard gradient over the data axis: {rep['shard_grad_sync']}\n")
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()

"""Data-parallel scaling, measured (the port of the measuring half of
``recsys_tpu/tools/scaling.py``): DLRM ``Trainer.fit`` throughput at 1, 2,
4, ... ranks of a data-parallel mesh, and each count's efficiency against
one rank, ``examples_per_s / (n · examples_per_s at 1)``.

Each count runs as its own world (``parallel/spawn.py``) with the
per-rank batch held fixed (weak scaling): synthetic Criteo-shaped data of
``per_device_batch · n`` rows, one warm-up epoch, then ``steps`` epochs of
one step each, timed on rank 0's host clock to a synchronise.  On the card
NCCL gives each rank a card of its own, up to the cards present, and that
is a measurement; with ``--device cpu`` 1 and 2 gloo ranks stage every
collective through the host, so they show the mechanics only, and the
report's ``kind`` says which.

Run: python -m recsys_tpu_torch.tools.scaling [--per-device-batch 2048]
        [--steps 5] [--vocab 10000] [--embed-dim 16] [--device cpu]
        [--out FILE]
One JSON object on stdout.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from recsys_tpu_torch.kernels import default_device, dispatch
from recsys_tpu_torch.parallel.mesh import make_mesh
from recsys_tpu_torch.parallel.spawn import spawn
from recsys_tpu_torch.tools.roofline import card


def rank_fit(n: int, per_device_batch: int, steps: int, vocab: int, embed_dim: int,
             device: str = "cpu") -> dict:
    """On one rank of a world of ``n``: {'seconds' of the timed epochs,
    'launches' of the kernels on this rank over them}."""
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    mesh = make_mesh(data=n, model=1, device=device)
    batch = per_device_batch * n
    schema, data = synthetic_ctr(num_examples=batch, num_dense=13, num_sparse=26,
                                 vocab_size=vocab, embed_dim=embed_dim, seed=0)
    torch.manual_seed(0)
    tr = Trainer(DLRM(schema, bottom_units=(128, 64), top_units=(256, 128)),
                 learning_rate=1e-3, mesh=mesh, device=device)
    tr.fit(data, batch_size=batch, epochs=1, verbose=False)  # warm-up: builds, allocates
    if device == "cuda":
        torch.cuda.synchronize()
    before = dict(dispatch.LAUNCHES)
    t0 = time.perf_counter()
    tr.fit(data, batch_size=batch, epochs=steps, verbose=False)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "launches": {k: v - before[k] for k, v in dispatch.LAUNCHES.items()
                                             if v != before[k]}}


def run(per_device_batch: int = 2048, steps: int = 5, vocab: int = 10_000,
        embed_dim: int = 16, *, device) -> dict:
    on_card = device.type == "cuda"
    backend = "nccl" if on_card else "gloo"
    max_ranks = torch.cuda.device_count() if on_card else 2
    fits, n = {}, 1
    while n <= max_ranks:
        fits[n] = spawn(rank_fit, n, n, per_device_batch, steps, vocab, embed_dim, device.type,
                        device=device.type, backend=backend)[0]
        n *= 2
    return report(fits, per_device_batch, steps, vocab, embed_dim, backend, device)


def report(fits: dict, per_device_batch: int, steps: int, vocab: int, embed_dim: int,
           backend: str, device) -> dict:
    """The tool's report from {ranks: rank 0's ``rank_fit``}."""
    measured = [{"devices": n, "examples_per_s": per_device_batch * n * steps / got["seconds"],
                 "launches": got["launches"]} for n, got in sorted(fits.items())]
    base = measured[0]["examples_per_s"]
    for r in measured:
        r["scaling_efficiency"] = r["examples_per_s"] / (base * r["devices"])
    on_card = device.type == "cuda"
    return {"backend": backend,
            "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "nvidia_smi": card()["smi"] if on_card else None,
            "kind": "measured" if backend == "nccl" else "mechanics only",
            "note": ("one rank a card over NCCL" if backend == "nccl" else
                     "gloo ranks stage every collective through the host: the mechanics "
                     "of the program, not the bandwidth of a link"),
            "per_device_batch": per_device_batch, "steps": steps, "vocab": vocab,
            "embed_dim": embed_dim, "measured": measured}


def main(argv=None):
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.scaling")
    p.add_argument("--per-device-batch", type=int, default=2048)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--vocab", type=int, default=10_000)
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rep = run(args.per_device_batch, args.steps, args.vocab, args.embed_dim,
              device=default_device(args.device))
    out = json.dumps(rep, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return rep


if __name__ == "__main__":
    main()

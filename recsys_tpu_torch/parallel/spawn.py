"""Run a function on every rank of a world of spawned processes: the CPU
tests' worlds of gloo ranks, and several ranks on one card.

``spawn(fn, world, *args)`` starts ``world`` processes (the ``spawn``
start method: a fresh interpreter each, importing only ``fn``'s module),
joins them into one process group through a file store in a temporary
directory, calls ``fn(*args)`` on each and returns the ranks' results in
rank order.  ``fn`` must be a module-level function; its arguments and
result are pickled, through a file in that directory: the start method
writes each process's arguments into a pipe that the process reads only
after importing the main module (and torch), so arguments larger than the
pipe holds, passed there, would start the ranks one after another.  A
rank that raises makes ``spawn`` raise.
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile

import torch


def _rank_main(rank: int, world: int, tmp: str, device: str, backend: str | None) -> None:
    import torch.distributed as dist

    from recsys_tpu_torch.parallel.mesh import init_distributed

    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    torch.set_num_threads(1)
    init_distributed(device, backend=backend, init_method=f"file://{tmp}/store", rank=rank,
                     world_size=world)
    try:
        out = fn(*args)
        # what the rank imported: no JAX, and nothing of the JAX package
        foreign = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "recsys_tpu"})
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump({"result": out, "foreign_modules": foreign}, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device: str = "cpu", backend: str | None = None,
          foreign: list | None = None) -> list:
    """[fn(*args) on rank r for r in range(world)]; ``device`` is the ranks'
    (``cuda`` puts every rank on the current card), ``backend`` their
    process group's (default: NCCL for cuda, gloo else).  Modules of JAX or
    of the JAX package that a rank imported are appended to ``foreign``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.start_processes(_rank_main, args=(world, tmp, device, backend), nprocs=world,
                           start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                got = pickle.load(f)
            out.append(got["result"])
            if foreign is not None:
                foreign.extend(got["foreign_modules"])
    return out

#!/usr/bin/env python3
"""Time the fused embedding updates (#4 and #5) in their one-stream form
against an earlier ``embedding_update.cu`` in alternating turns on one
card: the multi-stream and shard-window forms must leave the one-stream
walk's cost where it was.

    mkdir -p .scratch/old
    git show <commit>:recsys_tpu_torch/kernels/csrc/embedding_update.cu \\
        > .scratch/old/embedding_update.cu
    python3 update_turns.py --old .scratch/old [--pairs 10] [--out FILE]

The earlier source's C interface took three ints a table of the Adam pass
(V, block, nc) and no stream arguments in the rowwise launch: it is called
here through ctypes with those; the current one through ``dispatch``.
Both are built with ``build.NVCC_FLAGS`` and ``-Xptxas -v`` (the register
and spill report is kept).  Readings, ``cuda_ms`` at ``chip_smoke.py``'s
timing shapes: the Adam pass over the 26 bench tables (100k x 16 f32,
16384 uniform ids each, a bf16 cotangent) in one launch, prepped at the
JAX chunk length 256 and at the port's 1, and rowwise AdaGrad on one such
table; pair i runs the earlier source first when i is even.  The report
(one JSON object, also written to ``--out``) names the card as
``nvidia-smi`` does.  Needs a CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

from gather_adagrad_turns import compile_lib, timed, turns

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="directory with the earlier embedding_update.cu")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--out", type=Path, default=Path("artifacts/torch/update_turns.json"))
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("update_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.kernels import embedding_update as emb_ref
    from recsys_tpu_torch.tools.roofline import card

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    work = ROOT / ".scratch" / "update_turns_build"
    report = {"card": card()["smi"], "torch": torch.__version__, "cuda": torch.version.cuda,
              "ptxas": {}, "turns": {}}
    libs = {}
    for side, src_dir in (("old", args.old), ("new", build.CSRC)):
        (work / side).mkdir(parents=True, exist_ok=True)
        path, report["ptxas"][side] = compile_lib(src_dir / "embedding_update.cu", work / side)
        libs[side] = ctypes.CDLL(str(path))
    old = libs["old"]
    old.embedding_adam_launch.restype = ctypes.c_int
    old.embedding_rowwise_adagrad_launch.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    f = ctypes.c_float
    c1, c2 = emb_ref.adam_corrections(3, 0.9, 0.999)

    for ch in (cs.UPDATE_CH, 1):
        tabs = [cs.embedding_inputs(rng, dev, cs.VOCAB, False, cs.UPDATE_BLOCK, ch=ch)
                for _ in range(cs.NUM_SPARSE)]
        for a in tabs:
            a["cot"] = a["cot"].bfloat16()
        ptrs = (ctypes.c_uint64 * (6 * len(tabs)))(
            *(a[k].data_ptr() for a in tabs for k in ("p", "m", "v", "cot", "ids2d", "cptr")))
        ints = (ctypes.c_int * (3 * len(tabs)))(
            *(x for a in tabs for x in (cs.VOCAB, cs.UPDATE_BLOCK, a["ids2d"].shape[0])))

        def old_pass():
            rc = old.embedding_adam_launch(
                ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(ints, ctypes.c_void_p),
                len(tabs), cs.EMBED_DIM, ch, 0, 1, f(cs.LR), f(0.9), f(0.999), f(0.1),
                f(0.001), f(c1), f(c2), f(1e-8), f(0.0), stream)
            build.check(rc, "earlier embedding_adam_launch")

        def new_pass():
            dispatch.fused_embedding_adam_pass(
                *([a[k] for a in tabs] for k in ("p", "m", "v", "cot", "ids2d", "cptr")), 3,
                blocks=[cs.UPDATE_BLOCK] * len(tabs), lr=cs.LR)

        a = tabs[0]

        def old_adagrad():
            rc = old.embedding_rowwise_adagrad_launch(
                *(ctypes.c_void_p(a[k].data_ptr()) for k in ("p", "acc", "cot", "ids2d", "cptr")),
                cs.VOCAB, cs.EMBED_DIM, cs.UPDATE_BLOCK, ch, a["ids2d"].shape[0], 0, 1,
                f(cs.LR), f(1e-8), f(0.0), stream)
            build.check(rc, "earlier embedding_rowwise_adagrad_launch")

        def new_adagrad():
            dispatch.fused_embedding_rowwise_adagrad(a["p"], a["acc"], a["cot"], a["ids2d"],
                                                     a["cptr"], block=cs.UPDATE_BLOCK, lr=cs.LR)

        report["turns"][f"adam 26 tables ch {ch}"] = turns(
            timed(old_pass, iters=10, warmup=2), timed(new_pass, iters=10, warmup=2),
            args.pairs)
        report["turns"][f"rowwise_adagrad one table ch {ch}"] = turns(
            timed(old_adagrad), timed(new_adagrad), args.pairs)
        del tabs
    print(json.dumps(report), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

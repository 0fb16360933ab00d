#!/usr/bin/env python3
"""Time the fused top-k (#10) and the pooled gather (#7) against an earlier
design's sources in alternating turns on one card, and the YoutubeDNN
serving block with either design's kernels.

    mkdir -p .scratch/old
    for f in topk_scores.cu pooled_gather.cu; do
      git show <commit>:recsys_tpu_torch/kernels/csrc/$f > .scratch/old/$f
    done
    python3 topk_pool_turns.py --old .scratch/old [--pairs 10] [--out FILE]
        [--parts topk,pool,serve] [--edit NAME ...] [--variant LABEL=DIR ...]

Both sides are built with ``build.NVCC_FLAGS`` and ``-Xptxas -v`` (the
register and spill report is kept in the output).  Both kernels keep their
C interfaces, so both sides run through ``dispatch`` with
``build.libraries`` swapped.  Pair i runs the earlier design first when i
is even and the current one first when it is odd.  Readings, at
``chip_smoke.py``'s shapes: ``cuda_ms`` over many calls of #10 at the
serving block (8192 unit queries over the protocol seqret catalog, D = 32)
and the sweep shape (1024 x 1,000,000 x 64, normal vectors), k = 10; #7 on
the first 8192 test histories of ``protocol seqret`` (L = 50, D = 32) with
an f32 table and with the same table in bf16; the YoutubeDNN serving block
(``user_embed`` over 8192 histories, then the top-10 over the catalog, ids
back on the host), a turn's reading the median host-clock ms of its
blocks, and each side's device time from one profiled block.  Beside them:
the bounds (#10's split-TF32 bound, 3 TF32 products an f32 product at 495
TFLOP/s, and its CUDA-core bound at 67 TFLOP/s), the launch floors (an
empty kernel at the kernel's grid), the library calls (``torch.topk(q @
itemsᵀ, k)``, ``F.embedding_bag``) and each side's distance from the other
and from the plain version.  ``--edit NAME`` builds a copy of a current
source with one of ``EDITS`` applied, ``--variant LABEL=DIR`` DIR's
``topk_scores.cu`` or ``pooled_gather.cu``, each timed in turns with the
current source at the serving shapes.  The report (one JSON object, also
written to ``--out``) names the card as ``nvidia-smi`` does.  Needs a CUDA
card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np

from gather_adagrad_turns import compile_lib, load, timed, turns

ROOT = Path(__file__).resolve().parent
KERNELS = ("topk_scores", "pooled_gather")
# Design variants made from the current sources by one textual edit each:
# name -> (source, the text replaced, its replacement)
EDITS = {
    # 2 or 8 rows a lane in flight, not 4
    "pool_unroll2": ("pooled_gather.cu", "constexpr int kUnroll = 4; ",
                     "constexpr int kUnroll = 2; "),
    "pool_unroll8": ("pooled_gather.cu", "constexpr int kUnroll = 4; ",
                     "constexpr int kUnroll = 8; "),
    # 8 warps a block (the earlier design's), not 32
    "pool_warps8": ("pooled_gather.cu", "constexpr int kWarps = 32;",
                    "constexpr int kWarps = 8;"),
    # two examples a warp up to 128-byte rows (D = 32 f32)
    "pool_half128": ("pooled_gather.cu", "constexpr int kHalfWarpRow = 64;",
                     "constexpr int kHalfWarpRow = 128;"),
    # merges taken together at a tile's start where a row holds more than
    # 8 candidates (not 16), or a 48-candidate buffer (not 64)
    "topk_low8": ("topk_scores.cu", "constexpr int kLowFill = 16;",
                  "constexpr int kLowFill = 8;"),
    "topk_cap48": ("topk_scores.cu", "constexpr int kCap = 64; ", "constexpr int kCap = 48; "),
    # timing probes, wrong results: the top-k scoring and filtering with no
    # score offered to a buffer, or merging buffers without inserting
    "topk_no_offer": ("topk_scores.cu", "auto offer = [&](int row, float s, int j) {",
                      "auto offer = [&](int row, float s, int j) { if (s < 1e30f) return;"),
    "topk_no_insert": ("topk_scores.cu", "        insert(v, id, s, j);\n",
                       "        if (s > 1e30f) insert(v, id, s, j);\n"),
}


def variant_turns(variants, kname, new_libs, reading, pairs) -> dict:
    """Each variant of kernel ``kname`` in turns with the current source;
    ``reading(libs)`` makes a reading's callable."""
    out = {}
    for label, (vk, lib) in variants.items():
        if vk != kname:
            continue
        v = turns(reading(dict(new_libs, **{kname: lib})), reading(new_libs), pairs)
        out[f"variant {label}"] = {"variant_median": v["old_median"],
                                   "current_median": v["new_median"],
                                   "current_won": v["new_won"], "variant_ms": v["old_ms"],
                                   "current_ms": v["new_ms"]}
    return out


def topk_part(args, old_libs, new_libs, variants, cs, rng, dev, stream, num_items) -> dict:
    """#10 through ``dispatch.topk_scores_fused`` with either side's library
    in turns at the serving block and the sweep shape."""
    import torch

    import retrieval_check as rc
    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.kernels import topk as topk_ref
    from recsys_tpu_torch.tools.roofline import cuda_ms

    res = {}
    k = cs.YOUTUBE_K
    for name, (nq, n, d), unit in (("serving", (cs.YOUTUBE_BLOCK, num_items, cs.YOUTUBE_DIM),
                                    True), ("sweep", cs.YOUTUBE_SWEEP, False)):
        q = torch.from_numpy(rng.standard_normal((nq, d), dtype=np.float32)).to(dev)
        items = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        if unit:
            q, items = q / q.norm(dim=1, keepdim=True), items / items.norm(dim=1, keepdim=True)
        iters = dict(iters=20, warmup=3) if unit else dict(iters=4, warmup=1)

        def reading(libs):
            def run():
                build.libraries = lambda: libs
                return dispatch.topk_scores_fused(q, items, k)
            return timed(run, **iters)

        build.libraries = lambda: old_libs
        old_v, old_i = dispatch.topk_scores_fused(q, items, k)
        build.libraries = lambda: new_libs
        new_v, new_i = dispatch.topk_scores_fused(q, items, k)
        want_v, _ = topk_ref.topk_scores(q, items, k)
        limit = rc.score_limit(q, items)
        t = turns(reading(old_libs), reading(new_libs), args.pairs)
        ops = 2.0 * nq * n * d
        nbytes = (nq * d + n * d) * 4 + nq * k * 8
        t["bound_ms"], t["bound_by"] = cs.bound(nbytes, 3 * ops, cs.TF32_FLOPS)
        t["f32_core_bound_ms"] = cs.bound(nbytes, ops, cs.F32_FLOPS)[0]
        build.libraries = lambda: new_libs
        plan = dispatch.topk_plan(nq, n, d, k)
        lib = new_libs["topk_scores"]
        pp = ctypes.cast(plan, ctypes.c_void_p)
        t["plan"] = {"threads": plan[0], "tile_n": plan[1], "splits": plan[2],
                     "per_split": plan[3], "smem_bytes": plan[4]}
        t["launch_floor_ms"] = cuda_ms(lambda: lib.topk_scores_floor(nq, pp, stream), 200)
        t["library_ms"] = cuda_ms(lambda: torch.topk(q @ items.T, k), 5, 2)
        t["old_new_max_abs"] = float((old_v - new_v).abs().max())
        t["old_new_indices_equal_share"] = float((old_i == new_i).double().mean())
        t["new_agrees_with_plain"] = rc.topk_agrees(new_v, new_i, want_v, q, items, limit)
        t["old_agrees_with_plain"] = rc.topk_agrees(old_v, old_i, want_v, q, items, limit)
        t["shape"], t["k"] = [nq, n, d], k
        if unit:
            t.update(variant_turns(variants, "topk_scores", new_libs, reading, args.pairs))
        res[name] = t
        print(json.dumps({"kernel": f"topk_scores {name}", **t}), flush=True)
        del q, items
        torch.cuda.empty_cache()
    build.libraries = lambda: new_libs
    return res


def pool_part(args, old_libs, new_libs, variants, cs, rng, dev, stream, test_hist,
              num_items) -> dict:
    """#7 through ``dispatch.pooled_gather`` with either side's library in
    turns on the serving block's test histories, f32 and bf16 tables."""
    import torch
    import torch.nn.functional as F

    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.tools.roofline import cuda_ms

    rows_np = test_hist[:cs.YOUTUBE_BLOCK]
    b, length = rows_np.shape
    d = cs.YOUTUBE_DIM
    table32 = torch.from_numpy(rng.standard_normal((num_items, d), dtype=np.float32)).to(dev)
    rows = torch.from_numpy(rows_np).to(dev)
    mask = rows != 0
    weights = mask.float()
    touched = len(np.unique(rows_np[rows_np != 0]))
    real = int((rows_np != 0).sum())
    lib = new_libs["pooled_gather"]
    res = {"shape": [b, length, d], "rows_touched": touched, "real_positions": real,
           "launch_floor_ms": cuda_ms(lambda: lib.pooled_gather_floor(b, d, stream), 200)}
    for table in (table32, table32.bfloat16()):
        def reading(libs, table=table):
            def run():
                build.libraries = lambda: libs
                return dispatch.pooled_gather(table, rows, mask)
            return timed(run, iters=200)

        outs = []
        for libs in (old_libs, new_libs):
            build.libraries = lambda libs=libs: libs
            outs.append(dispatch.pooled_gather(table, rows, mask))
        t = turns(reading(old_libs), reading(new_libs), args.pairs)
        size = table.element_size()
        t["bound_ms"], t["bound_by"] = cs.bound(touched * d * size + b * length * 5 + b * d * 4,
                                                float(real) * d, cs.F32_FLOPS)
        t["library_ms"] = cuda_ms(lambda: F.embedding_bag(rows, table, mode="sum",
                                                          per_sample_weights=weights.to(
                                                              table.dtype)), 200)
        t["old_new_max_abs"] = float((outs[0] - outs[1]).abs().max())
        t.update(variant_turns(variants, "pooled_gather", new_libs, reading, args.pairs))
        name = str(table.dtype).removeprefix("torch.")
        res[name] = t
        print(json.dumps({"kernel": f"pooled_gather {name}", **t}), flush=True)
    build.libraries = lambda: new_libs
    return res


def serve_part(args, old_libs, new_libs, cs, rng, dev, test_hist, num_items) -> dict:
    """The YoutubeDNN serving block with either side's kernels in turns: a
    turn's reading is the median host-clock ms of 7 blocks; each side's
    device time from one profiled block."""
    import torch

    from recsys_tpu_torch.kernels import build

    model = cs.youtube_model(cs.youtube_jax_params(rng, num_items), num_items, dev)
    model.eval()
    with torch.inference_mode():
        items = model.all_item_embeddings()
    one = test_hist[:cs.YOUTUBE_BLOCK]

    def block():
        return cs.youtube_serve_block(model, one, items, dev)

    def reading(libs):
        def run():
            build.libraries = lambda: libs
            ms = []
            for _ in range(7):
                t0 = time.perf_counter()
                block()
                ms.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(ms))
        return run

    ids = []
    for libs in (old_libs, new_libs):  # warm-up
        reading(libs)()
        ids.append(block())
    res = turns(reading(old_libs), reading(new_libs), args.pairs)
    res["what"] = "median host-clock ms of a turn's 7 serving blocks (8192 users, top-10)"
    res["old_new_indices_equal_share"] = float((ids[0] == ids[1]).mean())
    for side, libs in (("old", old_libs), ("new", new_libs)):
        build.libraries = lambda libs=libs: libs
        prof = cs.profile_call(block, cs.youtube_category)
        res[f"{side}_profile"] = {key: prof[key] for key in ("wall_ms", "device_busy_ms",
                                                            "idle_share", "split_ms")}
    build.libraries = lambda: new_libs
    print(json.dumps({"youtube serve block": res}), flush=True)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="directory with the earlier topk_scores.cu and pooled_gather.cu")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--out", type=Path, default=Path("artifacts/torch/topk_pool_turns.json"))
    parser.add_argument("--parts", default="topk,pool,serve")
    parser.add_argument("--edit", action="append", default=[], choices=sorted(EDITS),
                        help="a current source with one of EDITS applied, timed against it")
    parser.add_argument("--variant", action="append", default=[],
                        help="LABEL=DIR: DIR's topk_scores.cu or pooled_gather.cu timed "
                             "against the current one")
    args = parser.parse_args(argv)
    parts = set(args.parts.split(","))

    import torch

    if not torch.cuda.is_available():
        print("topk_pool_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from recsys_tpu_torch.kernels import build
    from recsys_tpu_torch.tools.roofline import card

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    work = ROOT / ".scratch" / "topk_pool_build"
    report = {"card": card()["smi"], "torch": torch.__version__, "cuda": torch.version.cuda,
              "ptxas": {}}
    libs = {}
    for side, src_dir in (("old", args.old), ("new", build.CSRC)):
        (work / side).mkdir(parents=True, exist_ok=True)
        for name in KERNELS:
            path, ptxas = compile_lib(src_dir / f"{name}.cu", work / side)
            report["ptxas"][f"{side} {name}"] = ptxas
            libs[side, name] = load(path, name)
    new_libs = dict(build.libraries())
    new_libs.update({n: libs["new", n] for n in KERNELS})
    old_libs = dict(new_libs, **{n: libs["old", n] for n in KERNELS})
    build.libraries = lambda: new_libs
    stream = torch.cuda.current_stream(dev).cuda_stream

    variants = {}  # label -> (kernel name, library)
    sources = [(label, Path(src)) for label, src in (v.split("=", 1) for v in args.variant)]
    for name in args.edit:
        src, old, new = EDITS[name]
        text = (build.CSRC / src).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"edit {name}: {old!r} is not in {src} exactly once")
        (work / name).mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            (work / name / header.name).write_text(header.read_text())
        (work / name / src).write_text(text.replace(old, new))
        sources.append((name, work / name))
    for label, src in sources:
        kname = next(n for n in KERNELS if (src / f"{n}.cu").exists())
        (work / f"lib_{label}").mkdir(parents=True, exist_ok=True)
        path, ptxas = compile_lib(src / f"{kname}.cu", work / f"lib_{label}")
        report["ptxas"][f"variant {label}"] = ptxas
        variants[label] = kname, load(path, kname)

    num_items, _, test = cs.phase_youtube_data()
    if "topk" in parts:
        report["topk_scores"] = topk_part(args, old_libs, new_libs, variants, cs, rng, dev,
                                          stream, num_items)
    if "pool" in parts:
        report["pooled_gather"] = pool_part(args, old_libs, new_libs, variants, cs, rng, dev,
                                            stream, test["hist"], num_items)
    if "serve" in parts:
        report["youtube_serve_block"] = serve_part(args, old_libs, new_libs, cs, rng, dev,
                                                   test["hist"], num_items)
    build.libraries = lambda: new_libs

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1) + "\n")
    print(report["card"], flush=True)
    flat = {f"{kern} {k}": v for kern in ("topk_scores", "pooled_gather")
            for k, v in report.get(kern, {}).items() if isinstance(v, dict)}
    flat["youtube_serve_block"] = report.get("youtube_serve_block", {})
    print(json.dumps({k: {s: v.get(s) for s in ("old_median", "new_median", "new_won")}
                      for k, v in flat.items() if "new_won" in v}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

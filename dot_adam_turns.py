#!/usr/bin/env python3
"""Time the dot interaction (#1) and fused Adam (#4) against an earlier
design's sources in alternating turns on one card, and the DLRM fused-Adam
train step (``fused_mlps`` off) with either design's kernels.

    mkdir -p .scratch/old
    for f in dot_interaction.cu embedding_update.cu; do
      git show <commit>:recsys_tpu_torch/kernels/csrc/$f > .scratch/old/$f
    done
    python3 dot_adam_turns.py --old .scratch/old [--pairs 10] [--out FILE]
        [--parts dot,adam,pass,cold,step] [--edit NAME ...] [--variant LABEL=DIR ...]

Both sides are built with ``build.NVCC_FLAGS`` and ``-Xptxas -v`` (the
register and spill report is kept in the output).  The dot interaction
keeps its C interface, so both sides run through ``dispatch`` with
``build.libraries`` swapped.  The earlier fused Adam took one table a
launch with its own arguments; it is called here through ctypes as the
earlier wrapper called it (``old_adam``), and the DLRM step's earlier side
updates its 26 tables with it one launch each.  Pair i runs the earlier
design first when i is even and the current one first when it is odd.
Readings: ``cuda_ms`` over many calls at ``chip_smoke.py``'s timing shapes
(#1 on a 4096-row bf16 microbatch, 27 fields of 16; #4 over the 26 bench
tables, 100k x 16 f32, 16384 ids each, one table a call in turn as the
earlier step called it ("adam"), a step's 26 tables as one launch
against 26 earlier launches ("pass"), and the same with every m in the
denormal range ("cold", not run by default)); the step, the median host-clock ms
of 7 synchronised steps a turn.  Beside them: the bounds, #1's launch floor
(an empty kernel at its grid) and ``torch.bmm(x, x.mT)``'s time (the whole
F x F Gram matrix, not the same function).  ``--edit NAME`` builds a copy
of a current source with one of ``EDITS`` applied, ``--variant LABEL=DIR``
DIR's ``dot_interaction.cu`` or ``embedding_update.cu``, each timed in
turns with the current source (their C interfaces are the current ones).
The report (one JSON object, also written to ``--out``) names the card as
``nvidia-smi`` does.  Needs a CUDA card and nvcc; imports no JAX.
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
KERNELS = ("dot_interaction", "embedding_update")
# Design variants made from the current sources by one textual edit each:
# name -> (source, the text replaced, its replacement)
EDITS = {
    # one reciprocal a value in place of the IEEE division
    "adam_rcp": ("embedding_update.cu",
                 "float upd = h.lr * (m * h.c1) / (sqrtf(v * h.c2) + h.eps);",
                 "float upd = h.lr * (m * h.c1) * __frcp_rn(sqrtf(v * h.c2) + h.eps);"),
    # a block of Adam updates 1024 or 2048 values (1 or 2 float4s a thread)
    "adam_pre1": ("embedding_update.cu", "constexpr int kAdamPre = 4;",
                  "constexpr int kAdamPre = 1;"),
    "adam_pre2": ("embedding_update.cu", "constexpr int kAdamPre = 4;",
                  "constexpr int kAdamPre = 2;"),
    # 128 threads a block of Adam: 2048 values, 4 float4s a thread
    "adam_t128": ("embedding_update.cu", "constexpr int kAdamThreads = 256;",
                  "constexpr int kAdamThreads = 128;"),
    # 16 examples a block of the dot interaction (half a warp over examples)
    "dot_tile16": ("dot_interaction.cu", "constexpr int kTile = 8; ",
                   "constexpr int kTile = 16;"),
    # timing probes, wrong results: the dot interaction without the CUDA
    # cores' products, or without its stores
    "dot_no_products": ("dot_interaction.cu", "  if (e < rows) {", "  if (e < rows && F < 0) {"),
    "dot_no_stores": ("dot_interaction.cu",
                      "for (int q = threadIdx.x; q < n_out / 4; q += kThreads)",
                      "for (int q = threadIdx.x; q < 0; q += kThreads)"),
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier one-table Adam entry point: p, m, v, cot, ids, cptr, V, D,
# block, ch, nc, p_bf16, cot_bf16, lr, b1, b2, 1-b1, 1-b2, c1, c2, eps, wd, stream
OLD_ADAM_ARGS = [_P] * 6 + [_I] * 7 + [_F] * 9 + [_P]


def old_adam(lib):
    """``dispatch.fused_embedding_adam_pass``'s signature over the earlier
    library: its one-table kernel launched table by table, as the earlier
    wrapper launched it."""
    import torch

    from recsys_tpu_torch.kernels import build
    from recsys_tpu_torch.kernels import embedding_update as emb_ref

    fn = lib.embedding_adam_launch
    fn.restype, fn.argtypes = _I, OLD_ADAM_ARGS

    def run(ps, ms, vs, cots, ids2ds, cptrs, step, *, blocks, lr, b1=0.9, b2=0.999,
            eps=1e-8, wd=0.0, mm_bf16=True):
        c1, c2 = emb_ref.adam_corrections(step, b1, b2)
        for p, m, v, cot, ids2d, cptr, block in zip(ps, ms, vs, cots, ids2ds, cptrs, blocks):
            if mm_bf16:
                cot = cot.bfloat16()
            nc, ch = ids2d.shape
            rc = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), cot.data_ptr(), ids2d.data_ptr(),
                    cptr.data_ptr(), p.shape[0], p.shape[1], block, ch, nc,
                    int(p.dtype == torch.bfloat16), int(cot.dtype == torch.bfloat16), lr, b1, b2,
                    1.0 - b1, 1.0 - b2, c1, c2, eps, wd,
                    torch.cuda.current_stream(p.device).cuda_stream)
            build.check(rc, "old fused_embedding_adam")
    return run


def step_turns(sides, pairs: int, steps: int) -> dict:
    """The DLRM ``fused_adam fused_mlps=False`` step of ``chip_smoke.py`` at
    the bench widths, each turn with one side's kernels (``sides``: the
    earlier and the current (libraries, Adam pass)); a turn's reading is
    the median host-clock ms of ``steps`` synchronised steps."""
    import torch

    import chip_smoke as cs
    from recsys_tpu_torch.convert import params_from_jax
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    schema, data = synthetic_ctr(num_examples=cs.BATCH, num_dense=cs.NUM_DENSE,
                                 num_sparse=cs.NUM_SPARSE, vocab_size=cs.VOCAB,
                                 embed_dim=cs.EMBED_DIM, seed=1)
    model = DLRM(schema, bottom_units=cs.BOTTOM, top_units=cs.TOP,
                 compute_dtype=torch.bfloat16, fused_mlps=False,
                 dense_microbatch=cs.MICROBATCH, sparse_embed_grads=True,
                 device=torch.device("cuda"))
    model.load_state_dict(params_from_jax(cs.jax_layout_params(rng), schema, model))
    trainer = Trainer(model, learning_rate=cs.LR, embedding_optimizer="fused_adam")
    prepped = dict(data, **trainer._prep(data["sparse"]))

    def turn(side):
        libs, adam_pass = side
        build.libraries = lambda: libs
        dispatch.fused_embedding_adam_pass = adam_pass
        ms = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(prepped)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    for side in sides:  # warm-up
        turn(side)
    res = turns(lambda: turn(sides[0]), lambda: turn(sides[1]), pairs)
    turn(sides[1])  # leave the current side in place
    return {**res, "steps_a_turn": steps, "what": "median ms of a turn's synchronised steps"}


def dot_part(args, old_libs, new_libs, variants, cs, rng, dev, stream) -> dict:
    """#1 through ``dispatch.dot_interaction`` with either side's library
    in turns at the microbatch shape (bf16 and f32), the bound, the launch
    floor and ``torch.bmm``."""
    import torch

    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.tools.roofline import cuda_ms

    b, f, d = cs.BATCH // cs.MICROBATCH, cs.NUM_SPARSE + 1, cs.EMBED_DIM
    p = f * (f - 1) // 2
    x32 = torch.from_numpy(rng.standard_normal((b, f, d), dtype=np.float32)).to(dev)
    res = {"shape": [b, f, d]}

    def call(libs, x):
        def run():
            build.libraries = lambda: libs
            return dispatch.dot_interaction(x)
        return run

    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        outs = [call(libs, x)() for libs in (old_libs, new_libs)]
        t = turns(timed(call(old_libs, x), iters=200), timed(call(new_libs, x), iters=200),
                  args.pairs)
        t["bound_ms"], t["bound_by"] = cs.bound(x.numel() * x.element_size() + b * p * 4,
                                                2 * b * p * d, cs.BF16_FLOPS
                                                if dtype == torch.bfloat16 else cs.F32_FLOPS)
        t["max_abs_old_new"] = float((outs[0] - outs[1]).abs().max())
        name = str(dtype).removeprefix("torch.")
        for label, (kname, lib) in variants.items():
            if kname == "dot_interaction":
                var_libs = dict(new_libs, dot_interaction=lib)
                v = turns(timed(call(var_libs, x), iters=200),
                          timed(call(new_libs, x), iters=200), args.pairs)
                t[f"variant {label}"] = {"variant_median": v["old_median"],
                                         "current_median": v["new_median"],
                                         "current_won": v["new_won"],
                                         "variant_ms": v["old_ms"], "current_ms": v["new_ms"],
                                         "max_abs_variant_current": float(
                                             (call(var_libs, x)() - outs[1]).abs().max())}
        res[name] = t
        print(json.dumps({"kernel": f"dot_interaction {name}", **t}), flush=True)
    build.libraries = lambda: new_libs
    x = x32.bfloat16()
    lib = new_libs["dot_interaction"]
    res["launch_floor_ms"] = cuda_ms(lambda: lib.dot_interaction_floor(b, f, d, 0, stream), 200)
    res["grid"] = -(-b // lib.dot_interaction_tile(f, d, 0))
    res["bmm_ms"] = cuda_ms(lambda: torch.bmm(x, x.mT), 200)
    print(json.dumps({"dot_interaction": {k: res[k] for k in ("launch_floor_ms", "grid",
                                                             "bmm_ms")}}), flush=True)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="directory with the earlier dot_interaction.cu and "
                             "embedding_update.cu")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--step-pairs", type=int, default=20)
    parser.add_argument("--out", type=Path, default=Path("artifacts/torch/dot_adam_turns.json"))
    parser.add_argument("--parts", default="dot,adam,pass,step")
    parser.add_argument("--edit", action="append", default=[], choices=sorted(EDITS),
                        help="a current source with one of EDITS applied, timed against it")
    parser.add_argument("--variant", action="append", default=[],
                        help="LABEL=DIR: DIR's dot_interaction.cu or embedding_update.cu "
                             "timed against the current one")
    args = parser.parse_args(argv)
    parts = set(args.parts.split(","))

    import torch

    if not torch.cuda.is_available():
        print("dot_adam_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.tools.roofline import card, cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    work = ROOT / ".scratch" / "dot_adam_build"
    report = {"card": card()["smi"], "torch": torch.__version__, "cuda": torch.version.cuda,
              "ptxas": {}}
    libs = {}
    for side, src_dir in (("old", args.old), ("new", build.CSRC)):
        (work / side).mkdir(parents=True, exist_ok=True)
        for name in KERNELS:
            path, ptxas = compile_lib(src_dir / f"{name}.cu", work / side)
            report["ptxas"][f"{side} {name}"] = ptxas
            libs[side, name] = ctypes.CDLL(str(path)) if side == "old" else load(path, name)
    old_dot = libs["old", "dot_interaction"]
    for fn, (restype, argtypes) in build.SIGNATURES["dot_interaction"].items():
        if fn != "dot_interaction_floor":  # the earlier source has no floor
            getattr(old_dot, fn).restype, getattr(old_dot, fn).argtypes = restype, argtypes
    new_libs = dict(build.libraries())
    new_libs.update({n: libs["new", n] for n in KERNELS})
    old_libs = dict(new_libs, dot_interaction=old_dot)
    new_pass, old_pass = dispatch.fused_embedding_adam_pass, old_adam(
        libs["old", "embedding_update"])
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
        (work / name / src).write_text(text.replace(old, new))
        sources.append((name, work / name))
    for label, src in sources:
        kname = next(n for n in KERNELS if (src / f"{n}.cu").exists())
        (work / f"lib_{label}").mkdir(parents=True, exist_ok=True)
        path, ptxas = compile_lib(src / f"{kname}.cu", work / f"lib_{label}")
        report["ptxas"][f"variant {label}"] = ptxas
        variants[label] = kname, load(path, kname)

    if "dot" in parts:
        report["dot_interaction"] = dot_part(args, old_libs, new_libs, variants, cs, rng, dev,
                                             stream)

    # -- #4 over the 26 bench tables
    tabs = [cs.embedding_inputs(rng, dev, cs.VOCAB, False, cs.UPDATE_BLOCK)
            for _ in range(cs.NUM_SPARSE)]
    for a in tabs:
        a["cot"] = a["cot"].bfloat16()
    vd = cs.VOCAB * cs.EMBED_DIM
    stream_in = cs.BATCH * cs.EMBED_DIM * 2 + cs.BATCH * 4 + tabs[0]["cptr"].numel() * 4
    nbytes, nops = 6 * 4 * vd + stream_in, 16 * vd
    k = iter(range(1 << 40))

    def one(adam_pass, libs):
        def run():
            build.libraries = lambda: libs
            a = tabs[next(k) % cs.NUM_SPARSE]
            adam_pass([a["p"]], [a["m"]], [a["v"]], [a["cot"]], [a["ids2d"]], [a["cptr"]], 3,
                      blocks=[cs.UPDATE_BLOCK], lr=cs.LR)
        return run

    def every(adam_pass, libs):
        def run():
            build.libraries = lambda: libs
            adam_pass(*([a[key] for a in tabs] for key in ("p", "m", "v", "cot", "ids2d",
                                                           "cptr")), 3,
                      blocks=[cs.UPDATE_BLOCK] * cs.NUM_SPARSE, lr=cs.LR)
        return run

    rounds = dict(iters=2 * cs.NUM_SPARSE, warmup=cs.NUM_SPARSE)
    if "adam" in parts:
        t = turns(timed(one(old_pass, new_libs), **rounds), timed(one(new_pass, new_libs),
                                                                  **rounds), args.pairs)
        t["bound_ms"], t["bound_by"] = cs.bound(nbytes, nops, cs.F32_FLOPS)
        t["tb_s"] = {s: nbytes / t[f"{s}_median"] / 1e9 for s in ("old", "new")}
        for label, (kname, lib) in variants.items():
            if kname == "embedding_update":
                var_libs = dict(new_libs, embedding_update=lib)
                v = turns(timed(one(new_pass, var_libs), **rounds),
                          timed(one(new_pass, new_libs), **rounds), args.pairs)
                t[f"variant {label}"] = {"variant_median": v["old_median"],
                                         "current_median": v["new_median"],
                                         "current_won": v["new_won"],
                                         "variant_ms": v["old_ms"], "current_ms": v["new_ms"]}
        report["embedding_adam"] = t
        print(json.dumps({"kernel": "embedding_adam", **t}), flush=True)
    def pass_reading(adam_pass, libs, m0=None):
        """A reading of a step's 26 tables in one call of ``adam_pass``; with
        ``m0`` each table's m is set to it first, outside the timed calls."""
        run = every(adam_pass, libs)

        def read():
            for a, m in zip(tabs, m0 or ()):
                a["m"].copy_(m)
            return cuda_ms(run, iters=4, warmup=2)
        return read

    def pass_part(m0=None) -> dict:
        """The 26 earlier launches against one current launch, then each
        variant against the current source."""
        t = turns(pass_reading(old_pass, new_libs, m0), pass_reading(new_pass, new_libs, m0),
                  args.pairs)
        t["bound_ms"], t["bound_by"] = cs.bound(cs.NUM_SPARSE * nbytes, cs.NUM_SPARSE * nops,
                                                cs.F32_FLOPS)
        for label, (kname, lib) in variants.items():
            if kname == "embedding_update":
                var_libs = dict(new_libs, embedding_update=lib)
                v = turns(pass_reading(new_pass, var_libs, m0),
                          pass_reading(new_pass, new_libs, m0), args.pairs)
                t[f"variant {label}"] = {"variant_median": v["old_median"],
                                         "current_median": v["new_median"],
                                         "current_won": v["new_won"],
                                         "variant_ms": v["old_ms"], "current_ms": v["new_ms"]}
        return t

    if "pass" in parts:
        t = pass_part()
        # the current kernel one table a launch, 26 launches
        each_new = lambda: [one(new_pass, new_libs)() for _ in range(cs.NUM_SPARSE)]  # noqa: E731
        t["one_table_launches_ms"] = [cuda_ms(each_new, iters=4, warmup=1)
                                      for _ in range(args.pairs)]
        report["embedding_adam_pass"] = t
        print(json.dumps({"kernel": "embedding_adam 26-table pass", **t}), flush=True)
    if "cold" in parts:
        # every m in the denormal range (|m| about 1e-39), as a row updated
        # once and then left alone for some 800 steps holds it (m decays by
        # b1 a step with g = 0); set again before each reading
        t = pass_part([a["m"] * 1e-36 for a in tabs])
        report["embedding_adam_pass_cold_m"] = t
        print(json.dumps({"kernel": "embedding_adam 26-table pass, denormal m", **t}),
              flush=True)
    build.libraries = lambda: new_libs
    del tabs
    torch.cuda.empty_cache()

    if "step" in parts:
        report["dlrm_step_fused_adam"] = step_turns(
            [(old_libs, old_pass), (new_libs, new_pass)], args.step_pairs, 7)
        print(json.dumps({"step": report["dlrm_step_fused_adam"]}), flush=True)
    build.libraries = lambda: new_libs
    dispatch.fused_embedding_adam_pass = new_pass

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1) + "\n")
    print(report["card"], flush=True)
    parts_ = {**{f"dot_interaction {k}": v for k, v in report.get("dot_interaction", {}).items()
                 if isinstance(v, dict)}, **report}
    print(json.dumps({k: {s: v.get(s) for s in ("old_median", "new_median", "new_won")}
                      for k, v in parts_.items() if isinstance(v, dict) and "new_won" in v}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

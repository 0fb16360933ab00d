#!/usr/bin/env python3
"""Time the hot gather (#13) and rowwise AdaGrad (#5) against an earlier
design's sources in alternating turns on one card, and the DLRM
rowwise-AdaGrad train step with either design's update kernels (fused
Adam, #4, which shares #5's accumulate phase, has its own turns in
``dot_adam_turns.py``).

    mkdir -p .scratch/old
    for f in hot_gather.cu embedding_update.cu; do
      git show <commit>:recsys_tpu_torch/kernels/csrc/$f > .scratch/old/$f
    done
    python3 gather_adagrad_turns.py --old .scratch/old [--pairs 10] [--out FILE]
        [--parts hot,adagrad,step] [--variant LABEL=DIR ...]

The earlier sources are built with ``build.NVCC_FLAGS`` beside the current
ones (both with ``-Xptxas -v``, whose register and spill report is kept in
the output) and swapped in through ``build.libraries`` (their entry points
keep their signatures), so both sides run through ``dispatch``.  Pair i
runs the earlier design first when i is even and the current one first
when it is odd; each reading is ``cuda_ms`` over many calls at the shapes
of ``chip_smoke.py``'s timing phases: #13 at the probe's hot ids (and at
300,001 and 3,000,000 uniform ids), #5 over the 26 bench tables in turn,
as a step calls them.  The report (one JSON object, also written to
``--out``) gives each side's readings, medians and the pairs the current
design won, the bound, the hot gather's launch floor and
``index_select``'s time, and the card's ``nvidia-smi`` line.
``--variant LABEL=DIR`` times DIR's ``hot_gather.cu`` or
``embedding_update.cu`` (an edited copy, say) in turns with the current
one (in a hot-gather variant's entry "old" is the variant); an AdaGrad
variant is also timed on one table again and again (``warm_ms``, the table
in L2).  Needs a CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def compile_lib(src: Path, out_dir: Path) -> tuple[Path, str]:
    """nvcc ``src`` with the build's flags and ``-Xptxas -v``; returns the
    library and ptxas's report."""
    from recsys_tpu_torch.kernels import build

    out = out_dir / f"{src.stem}.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                           str(src)], capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}{proc.stderr}")
    report = [ln for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return out, "\n".join(report)


def load(path: Path, name: str) -> ctypes.CDLL:
    """The library at ``path`` with the entry points of ``build.SIGNATURES[
    name]`` that it has (an earlier source may lack the newer ones) typed."""
    from recsys_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in build.SIGNATURES[name].items():
        entry = getattr(lib, fn, None)
        if entry is not None:
            entry.restype, entry.argtypes = restype, argtypes
    return lib


def turns(read_old, read_new, pairs: int) -> dict:
    """``pairs`` alternating readings (ms) of each side (old first in even
    pairs); medians and the pairs the new side won."""
    old, new = [], []
    for i in range(pairs):
        order = ((old, read_old), (new, read_new)) if i % 2 == 0 else ((new, read_new),
                                                                          (old, read_old))
        for out, read in order:
            out.append(read())
    return {"old_ms": old, "new_ms": new, "old_median": float(np.median(old)),
            "new_median": float(np.median(new)),
            "new_won": sum(n < o for o, n in zip(old, new)), "pairs": pairs}


def timed(fn, **timing):
    """A reading of ``fn``'s device ms by ``cuda_ms``."""
    from recsys_tpu_torch.tools.roofline import cuda_ms

    return lambda: cuda_ms(fn, **timing)


def step_turns(old_libs, new_libs, pairs: int, steps: int) -> dict:
    """The DLRM ``fused_rowwise_adagrad fused_mlps=False`` step of
    ``chip_smoke.py`` at the bench widths, with either design's update
    kernels: each turn the median host-clock ms of ``steps`` synchronised
    steps."""
    import torch

    import chip_smoke as cs
    from recsys_tpu_torch.convert import params_from_jax
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.kernels import build
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
    trainer = Trainer(model, learning_rate=cs.LR, embedding_optimizer="fused_rowwise_adagrad")
    prepped = dict(data, **trainer._prep(data["sparse"]))

    def turn(libs):
        build.libraries = lambda: libs
        ms = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(prepped)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms))

    for libs in (old_libs, new_libs):  # warm-up
        turn(libs)
    return {**turns(lambda: turn(old_libs), lambda: turn(new_libs), pairs),
            "steps_a_turn": steps, "what": "median ms of a turn's synchronised train_steps"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="directory with the earlier hot_gather.cu and embedding_update.cu")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--step-pairs", type=int, default=20)
    parser.add_argument("--out", type=Path,
                        default=Path("artifacts/torch/gather_adagrad_turns.json"))
    parser.add_argument("--parts", default="hot,adagrad,step")
    parser.add_argument("--variant", action="append", default=[],
                        help="LABEL=DIR: DIR's hot_gather.cu or embedding_update.cu timed "
                             "against the current one")
    args = parser.parse_args(argv)
    parts = set(args.parts.split(","))

    import torch

    if not torch.cuda.is_available():
        print("gather_adagrad_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.tools.roofline import card, cuda_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    work = ROOT / ".scratch" / "turns_build"
    (work / "old").mkdir(parents=True, exist_ok=True)
    (work / "new").mkdir(parents=True, exist_ok=True)
    report = {"card": card()["smi"], "torch": torch.__version__, "cuda": torch.version.cuda,
              "ptxas": {}}
    libs = {}
    for side, src_dir in (("old", args.old), ("new", build.CSRC)):
        for name in ("hot_gather", "embedding_update"):
            path, ptxas = compile_lib(src_dir / f"{name}.cu", work / side)
            report["ptxas"][f"{side} {name}"] = ptxas
            libs[side, name] = load(path, name)
    new_libs = dict(build.libraries())
    new_libs.update({n: libs["new", n] for n in ("hot_gather", "embedding_update")})
    old_libs = dict(new_libs, embedding_update=libs["old", "embedding_update"])
    build.libraries = lambda: new_libs
    stream = torch.cuda.current_stream(dev).cuda_stream

    variants = {}  # label -> (kernel name, library)
    for label, src in (v.split("=", 1) for v in args.variant):
        name = next(n for n in ("hot_gather", "embedding_update")
                    if (Path(src) / f"{n}.cu").exists())
        (work / label).mkdir(exist_ok=True)
        path, ptxas = compile_lib(Path(src) / f"{name}.cu", work / label)
        report["ptxas"][f"variant {label}"] = ptxas
        variants[label] = name, load(path, name)
    if "hot" in parts:
        old_hot = dict(new_libs, hot_gather=libs["old", "hot_gather"])
        report["hot_gather"] = hot_turns(args, old_hot, new_libs, cs, rng, dev, stream,
                                         counts=(300_001, 3_000_000))
        for label, (name, lib) in variants.items():
            if name == "hot_gather":
                report[f"variant {label}"] = hot_turns(
                    args, dict(new_libs, hot_gather=lib), new_libs, cs, rng, dev, stream,
                    counts=(300_001, 3_000_000))
    # -- #5 on the bench table, 26 tables in turn
    tabs = [cs.embedding_inputs(rng, dev, cs.VOCAB, False, cs.UPDATE_BLOCK)
            for _ in range(cs.NUM_SPARSE)]
    for a in tabs:
        a["cot"] = a["cot"].bfloat16()
    vd = cs.VOCAB * cs.EMBED_DIM
    stream_in = cs.BATCH * cs.EMBED_DIM * 2 + cs.BATCH * 4 + tabs[0]["cptr"].numel() * 4
    blk = dict(block=cs.UPDATE_BLOCK, lr=cs.LR)
    kernels = {
        "embedding_rowwise_adagrad": (lambda a: dispatch.fused_embedding_rowwise_adagrad(
            a["p"], a["acc"], a["cot"], a["ids2d"], a["cptr"], **blk),
            2 * 4 * vd + 2 * 4 * cs.VOCAB, 8 * vd)}
    k = iter(range(1 << 40))

    def calls(libs_, call, rotate=True):
        def run():
            build.libraries = lambda: libs_
            call(tabs[next(k) % cs.NUM_SPARSE if rotate else 0])
        return run

    rounds = dict(iters=2 * cs.NUM_SPARSE, warmup=cs.NUM_SPARSE)
    for name, part in (("embedding_rowwise_adagrad", "adagrad"),):
        if part not in parts:
            continue
        call, nbytes, nops = kernels[name]
        t = turns(timed(calls(old_libs, call), **rounds), timed(calls(new_libs, call), **rounds),
                  args.pairs)
        t["bound_ms"], t["bound_by"] = cs.bound(nbytes + stream_in, nops, cs.F32_FLOPS)
        t["tb_s"] = {s: (nbytes + stream_in) / t[f"{s}_median"] / 1e9 for s in ("old", "new")}
        report[name] = t
        print(json.dumps({"kernel": name, **t}), flush=True)
    call = kernels["embedding_rowwise_adagrad"][0]
    for label, (name, lib) in variants.items():
        if name != "embedding_update":
            continue
        var_libs = dict(new_libs, embedding_update=lib)
        t = turns(timed(calls(var_libs, call), **rounds), timed(calls(new_libs, call), **rounds),
                  args.pairs)
        t = {"variant_median": t["old_median"], "current_median": t["new_median"],
             "current_won": t["new_won"], "variant_ms": t["old_ms"], "current_ms": t["new_ms"],
             "variant_warm_ms": cuda_ms(calls(var_libs, call, False)),
             "current_warm_ms": cuda_ms(calls(new_libs, call, False))}
        report[f"variant {label}"] = t
        print(json.dumps({"variant": label, **t}), flush=True)
    build.libraries = lambda: new_libs

    # -- the DLRM step
    if "step" in parts:
        report["dlrm_step_rowwise_adagrad"] = step_turns(old_libs, new_libs, args.step_pairs, 7)
        build.libraries = lambda: new_libs
        print(json.dumps({"step": report["dlrm_step_rowwise_adagrad"]}), flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1) + "\n")
    print(report["card"], flush=True)
    print(json.dumps({k: {s: v.get(s) for s in ("old_median", "new_median", "new_won")}
                      for k, v in report.items() if isinstance(v, dict) and "new_won" in v}))
    return 0


def hot_turns(args, old_libs, new_libs, cs, rng, dev, stream, counts=()) -> dict:
    """#13 through ``dispatch.hot_gather`` with ``old_libs``' kernel and
    ``new_libs``' in turns, at the probe's shape (one Zipf(1.1) table's hot
    ids, H = 1024) and at each of ``counts`` uniform ids; at the probe's
    shape also the bound, the launch floor and index_select."""
    import torch

    from recsys_tpu_torch.kernels import build, dispatch
    from recsys_tpu_torch.tools import gather_split_probe as gsp
    from recsys_tpu_torch.tools.roofline import cuda_ms

    ids = gsp._zipf_ids(rng, cs.PROBE_ZIPF, cs.BATCH, cs.VOCAB)
    hot_rows, hot_idx2d, _, _, n_hot, _ = gsp.host_split(ids, cs.PROBE_HOT)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((cs.VOCAB, cs.EMBED_DIM), generator=gen, device=dev) * 0.1 - 0.05
    hot = table.index_select(0, torch.from_numpy(hot_rows).long().to(dev))
    hot_ids = torch.from_numpy(hot_idx2d).to(dev)
    n, d, h = hot_ids.numel(), cs.EMBED_DIM, hot.shape[0]

    def gather(libs_, ids_):
        def run():
            build.libraries = lambda: libs_
            return dispatch.hot_gather(hot, ids_, 1)
        return run

    outs = [gather(libs_, hot_ids)() for libs_ in (old_libs, new_libs)]
    t = turns(timed(gather(old_libs, hot_ids), iters=200, warmup=10),
              timed(gather(new_libs, hot_ids), iters=200, warmup=10), args.pairs)
    lib = new_libs["hot_gather"]
    grid = lib.hot_gather_grid(n, d, 1)
    real = hot_ids.reshape(-1)[:n_hot].long()
    t.update({"bit_equal_old_new": bool(torch.equal(*outs)),
              "bound_ms": cs.bound(4 * (hot.numel() + n + n * d), 0.0, cs.F32_FLOPS)[0],
              "launch_floor_ms": cuda_ms(lambda: lib.hot_gather_floor(grid, stream),
                                         200, 10), "grid": grid,
              "library_ms": cuda_ms(lambda: hot.index_select(0, real), 200, 10),
              "library": "index_select of the real ids",
              "shape": {"hot": list(hot.shape), "ids": n, "n_hot": n_hot}})
    for count in counts:  # larger gathers of uniform ids, a sentinel among them
        ids_ = torch.randint(0, h + 1, (count,), generator=gen, device=dev, dtype=torch.int32)
        t[f"{count} ids"] = turns(timed(gather(old_libs, ids_), iters=50, warmup=5),
                                  timed(gather(new_libs, ids_), iters=50, warmup=5), args.pairs)
    build.libraries = lambda: new_libs
    print(json.dumps({"kernel": "hot_gather", **t}), flush=True)
    return t


if __name__ == "__main__":
    sys.exit(main())

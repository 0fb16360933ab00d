#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (recsys_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU (sm_90a: H100) and nvcc; run from the root of a
checkout.  Phases, one JSON line each:

1. card      -- nvidia-smi's name and power limit (also printed raw).
2. build     -- nvcc builds every kernel from recsys_tpu_torch/kernels/csrc.
3. check     -- each kernel against its plain PyTorch version at the serving
                shapes and a ragged batch, f32 and bf16, TF32 off.
4. serve     -- DLRM at the bench widths (26 x 100k-row tables, D = 16,
                bottom 13-512-256-16-16, top 367-1024-1024-512-256-1, bf16
                compute, 4 dense microbatches), weights made from the seed in
                the JAX package's layout and converted with params_from_jax,
                served by Trainer.predict over 16384-row requests plus a
                ragged tail, with fused_mlps off and on.  Launch counts are
                zeroed before each run and read after it; the logits are
                held against the same model run through the plain versions.
5. timing    -- request latency, examples/s and peak device memory (in the
                serve lines), device time by kernel over one request and the
                device's idle share (profile), and per-kernel ms beside its
                bound and the plain version's ms.
6. kernels   -- one line naming every kernel with its launches and times.

The last line is {"ok": true, "device": {...}}.  Any failed check raises, and
the script exits non-zero; with no card it exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and bf16 tensor
# cores.  A card below 700 W runs under them.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
SLEEP_CYCLES_PER_S = 2.0e9  # at least the SM clock (H100 boost ~1.98 GHz)

BATCH = 16384          # one request, the bench batch
MICROBATCH = 4         # dense_microbatch: 4096-row slices reach the kernels
VOCAB = 100_000
NUM_SPARSE = 26
NUM_DENSE = 13
EMBED_DIM = 16
BOTTOM = (512, 256, EMBED_DIM)
TOP = (1024, 1024, 512, 256)
REQUESTS = 3
TAIL = 5000            # ragged last request

# Tolerances, kernel against plain version on the same card:
# - dot interaction: both sum D exact products in f32, in another order.
DOT_TOL = dict(rtol=1e-4, atol=1e-4)
# - MLP, exact f32: up to 1024-term f32 sums in another order per layer.
MLP_F32_TOL = dict(rtol=1e-4, atol=1e-4)
# - MLP, bf16: a sum in another order can round a hidden value to the
#   neighbouring bf16 (2^-8 relative), which reaches the output as a few
#   bf16 ulps of outputs of order 1.
MLP_BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# - DLRM logits: the bf16 top tower after a kernel's f32-order change, as
#   for the bf16 MLP.
LOGIT_TOL = dict(rtol=3e-2, atol=3e-2)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device ms per call from CUDA events around `iters` calls.

    A small kernel runs faster than Python can launch it, so events around
    back-to-back calls would time the host.  A sleep kernel first holds
    the device for longer than the host takes to enqueue the calls, and
    the events then time the calls' device work alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def errors(got, want) -> dict:
    diff = (got.double() - want.double()).abs()
    rel = diff / want.double().abs().clamp_min(1e-6)
    return {"max_abs_err": float(diff.max()), "max_rel_err": float(rel.max())}


def check_close(name: str, got, want, tol: dict) -> dict:
    import torch

    err = errors(got, want)
    bad = ~torch.isclose(got.double(), want.double(), **tol) | ~torch.isfinite(got)
    ok = got.shape == want.shape and not bool(bad.any())
    emit({"phase": "check", "case": name, **err, **tol, "ok": ok})
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {err}")
    return err


def mlp_weights(rng, dims):
    ws = [(rng.standard_normal((a, b), dtype=np.float32) / np.float32(np.sqrt(a)))
          for a, b in zip(dims, dims[1:])]
    bs = [rng.standard_normal(b, dtype=np.float32) * np.float32(0.01) for b in dims[1:]]
    return ws, bs


def bound(bytes_moved: float, operations: float, peak_ops: float) -> tuple[float, str]:
    """Least ms the card could take, and which of the two sets it."""
    by, op = bytes_moved / HBM_BYTES_PER_S, operations / peak_ops
    return max(by, op) * 1e3, "bytes" if by >= op else "operations"


def mlp_work(b, dims) -> tuple[float, float]:
    """(bytes, operations) of one fused MLP call: x and the output once,
    every f32 weight and bias once."""
    n_w = sum(a * c + c for a, c in zip(dims, dims[1:]))
    return ((b * dims[0] + b * dims[-1] + n_w) * 4,
            2 * b * sum(a * c for a, c in zip(dims, dims[1:])))


def phase_card() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = {"phase": "card", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(card)
    return card


def phase_build() -> None:
    from recsys_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.libraries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs), "flags": " ".join(build.NVCC_FLAGS)})


def phase_check(rng, dev) -> dict:
    """Every kernel against its plain version; returns the worst abs error
    of each kernel at the serving dtype (bf16)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels.interactions import dot_interaction
    from recsys_tpu_torch.kernels.mlp import mlp_forward

    worst = {"dot_interaction": 0.0, "mlp_fwd": 0.0}
    f = NUM_SPARSE + 1
    for b in (BATCH // MICROBATCH, 1000):
        x32 = torch.from_numpy(
            rng.standard_normal((b, f, EMBED_DIM), dtype=np.float32) * np.float32(0.5)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for si in (False, True):
                err = check_close(f"dot_interaction b={b} {dtype} self={si}",
                                  dispatch.dot_interaction(x, si),
                                  dot_interaction(x, si), DOT_TOL)
                if dtype == torch.bfloat16 and not si:
                    worst["dot_interaction"] = max(worst["dot_interaction"], err["max_abs_err"])
    top_in = EMBED_DIM + f * (f - 1) // 2
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [top_in, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [torch.from_numpy(w).to(dev) for w in ws]
        tb = [torch.from_numpy(v).to(dev) for v in bs]
        for b in (BATCH // MICROBATCH, 1000):
            x = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
            for mm_bf16 in (False, True):
                err = check_close(
                    f"mlp_fwd {name} b={b} mm_bf16={mm_bf16}",
                    dispatch.fused_mlp_forward(x, tw, tb, mm_bf16),
                    mlp_forward(x, tw, tb, mm_bf16),
                    MLP_BF16_TOL if mm_bf16 else MLP_F32_TOL)
                if mm_bf16:
                    worst["mlp_fwd"] = max(worst["mlp_fwd"], err["max_abs_err"])
    torch.cuda.synchronize()
    return worst


def jax_layout_params(rng) -> dict:
    """Bench-width DLRM weights in the JAX package's layout: row-packed
    tables, and both towers as MLP (Dense_i kernel (in, out), bias) and as
    FusedMLP (kernel_i, bias_i (1, out)) holding the same numbers."""
    from recsys_tpu_torch.convert import _pad8, pack_factor

    p = pack_factor(EMBED_DIM, VOCAB)
    rows = _pad8(-(-VOCAB // p))
    params = {"StackedEmbedding_0": {
        f"table_{g}": rng.uniform(-0.05, 0.05, (rows, p * EMBED_DIM)).astype(np.float32)
        for g in range(NUM_SPARSE)
    }}
    f = NUM_SPARSE + 1
    towers = ([NUM_DENSE, *BOTTOM, EMBED_DIM],
              [EMBED_DIM + f * (f - 1) // 2, *TOP, 1])
    for i, dims in enumerate(towers):
        ws, bs = mlp_weights(rng, dims)
        params[f"MLP_{i}"] = {f"Dense_{j}": {"kernel": w, "bias": b}
                              for j, (w, b) in enumerate(zip(ws, bs))}
        params[f"FusedMLP_{i}"] = {k: v for j, (w, b) in enumerate(zip(ws, bs))
                                   for k, v in ((f"kernel_{j}", w), (f"bias_{j}", b[None]))}
    return params


def plain_logits(model, batch):
    """The DLRM forward with every kernel replaced by its plain version,
    called explicitly (the same math the model's own forward dispatches)."""
    import torch

    from recsys_tpu_torch.kernels.interactions import dot_interaction
    from recsys_tpu_torch.kernels.mlp import mlp_forward
    from recsys_tpu_torch.ops.mlp import FusedMLP

    def tower(m, x):
        if isinstance(m, FusedMLP):
            ws = [getattr(m, f"kernel_{i}") for i in range(m.num_layers)]
            bs = [getattr(m, f"bias_{i}") for i in range(m.num_layers)]
            return mlp_forward(x.float(), ws, bs, m.mm_bf16)
        return m(x)

    fe = model.embedding(batch["sparse"]).to(model.compute_dtype)
    dense = batch["dense"]
    b = fe.shape[0]
    nm = MICROBATCH if b % MICROBATCH == 0 else 1
    bs = b // nm
    out = []
    for i in range(nm):
        bottom = tower(model.bottom, dense[i * bs:(i + 1) * bs])
        feats = torch.cat([bottom[:, None, :].to(fe.dtype), fe[i * bs:(i + 1) * bs]], 1)
        inter = dot_interaction(feats)
        top_in = torch.cat([bottom.to(inter.dtype), inter], -1)
        out.append(tower(model.top, top_in)[..., 0])
    return torch.cat(out).float()


def profile_request(trainer, one: dict) -> dict:
    """Device time by kernel over one request, from torch.profiler, and the
    device's idle share of the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.predict(one, batch_size=BATCH)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if rows else None,
            "idle_share": 1.0 - busy / wall_ms if rows else None,
            "device_kernels": len(rows),
            "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:10]]}


def phase_serve(params, dev) -> dict:
    """Trainer.predict at bench widths, fused_mlps off and on; returns per
    configuration the launches, errors, latency and throughput."""
    import torch

    from recsys_tpu_torch.convert import params_from_jax
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    n = REQUESTS * BATCH + TAIL
    schema, data = synthetic_ctr(num_examples=n, num_dense=NUM_DENSE,
                                 num_sparse=NUM_SPARSE, vocab_size=VOCAB,
                                 embed_dim=EMBED_DIM, seed=0)
    requests = -(-n // BATCH)  # the tail is padded to a full request
    results = {}
    for fused in (False, True):
        name = f"fused_mlps={fused}"
        model = DLRM(schema, bottom_units=BOTTOM, top_units=TOP,
                     compute_dtype=torch.bfloat16, fused_mlps=fused,
                     dense_microbatch=MICROBATCH, device=dev)
        model.load_state_dict(params_from_jax(params, schema, model))
        trainer = Trainer(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        logits = trainer.predict(data, batch_size=BATCH)
        torch.cuda.synchronize()
        launches = dict(dispatch.LAUNCHES)
        expected = {"dot_interaction": requests * MICROBATCH,
                    "mlp_fwd": 2 * requests * MICROBATCH if fused else 0}
        if launches != expected:
            raise AssertionError(f"{name}: launches {launches}, expected {expected}")
        if logits.shape != (n,) or not np.isfinite(logits).all():
            raise AssertionError(f"{name}: logits shape {logits.shape} or not finite")

        errs = []
        with torch.inference_mode():
            for lo, hi in ((0, BATCH), (REQUESTS * BATCH, n)):
                batch = {k: torch.from_numpy(data[k][lo:hi]).to(dev)
                         for k in ("sparse", "dense")}
                want = plain_logits(model, batch)
                got = torch.from_numpy(logits[lo:hi]).to(dev)
                errs.append(check_close(f"dlrm {name} rows {lo}..{hi}", got, want, LOGIT_TOL))

        # request latency: one request end to end (host batch, copy in,
        # forward, copy out), after the warm-up above
        one = {k: v[:BATCH] for k, v in data.items()}
        lat = []
        for _ in range(7):
            t0 = time.perf_counter()
            trainer.predict(one, batch_size=BATCH)
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        trainer.predict(data, batch_size=BATCH)
        wall = time.perf_counter() - t0
        auc = trainer.evaluate_auc(data, batch_size=BATCH)
        emit({"phase": "profile", "config": name, **profile_request(trainer, one)})
        res = {"phase": "serve", "config": name, "rows": n, "requests": requests,
               "launches": launches, "expected_launches": expected,
               "max_abs_err": max(e["max_abs_err"] for e in errs),
               "request_ms_median": float(np.median(lat)),
               "request_ms_min": float(np.min(lat)),
               "examples_per_s": n / wall,
               "auc_random_weights": auc,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit(res)
        results[name] = res
        del model, trainer
        torch.cuda.empty_cache()
    return results


def phase_timing(rng, dev) -> dict:
    """Kernel and plain ms at the serving shapes (one 4096-row microbatch,
    bf16), with each kernel's bound."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels.interactions import dot_interaction
    from recsys_tpu_torch.kernels.mlp import mlp_forward

    b, f = BATCH // MICROBATCH, NUM_SPARSE + 1
    p = f * (f - 1) // 2
    x = torch.from_numpy(rng.standard_normal((b, f, EMBED_DIM), dtype=np.float32)).to(
        dev, torch.bfloat16)
    # bf16 in, f32 out; the products are bf16, so the tensor-core peak
    bound_ms, kind = bound(b * f * EMBED_DIM * 2 + b * p * 4, 2 * b * p * EMBED_DIM,
                           BF16_FLOPS)
    dot = {"ms": cuda_ms(lambda: dispatch.dot_interaction(x), iters=200),
           "plain_ms": cuda_ms(lambda: dot_interaction(x), iters=200),
           "bound_ms": bound_ms, "bound_by": kind, "library_ms": None,
           "shape": [b, f, EMBED_DIM], "dtype": "bf16"}
    emit({"phase": "timing", "kernel": "dot_interaction", **dot})

    # one bottom and one top tower per microbatch, as the path launches them
    mlp = {"ms": 0.0, "plain_ms": 0.0, "towers": {}}
    total_bytes = total_ops = 0.0
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [EMBED_DIM + p, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [torch.from_numpy(w).to(dev) for w in ws]
        tb = [torch.from_numpy(v).to(dev) for v in bs]
        xm = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
        t = {"ms": cuda_ms(lambda: dispatch.fused_mlp_forward(xm, tw, tb, True)),
             "plain_ms": cuda_ms(lambda: mlp_forward(xm, tw, tb, True)),
             "f32_ms": cuda_ms(lambda: dispatch.fused_mlp_forward(xm, tw, tb, False),
                               iters=10, warmup=2)}
        by, op = mlp_work(b, dims)
        t["bound_ms"], t["bound_by"] = bound(by, op, BF16_FLOPS)
        emit({"phase": "timing", "kernel": f"mlp_fwd {name}", "dims": dims, **t})
        mlp["towers"][name] = t
        mlp["ms"] += t["ms"]
        mlp["plain_ms"] += t["plain_ms"]
        total_bytes, total_ops = total_bytes + by, total_ops + op
    mlp["bound_ms"], mlp["bound_by"] = bound(total_bytes, total_ops, BF16_FLOPS)
    mlp["library_ms"] = None
    return {"dot_interaction": dot, "mlp_fwd": mlp}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "recsys_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (recsys_tpu_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    card = phase_card()
    phase_build()
    worst = phase_check(rng, dev)
    serve = phase_serve(jax_layout_params(rng), dev)
    timing = phase_timing(rng, dev)

    sources = {
        "dot_interaction": ("recsys_tpu_torch/kernels/csrc/dot_interaction.cu",
                            "recsys_tpu/kernels/pallas/interactions_tpu.py:84"),
        "mlp_fwd": ("recsys_tpu_torch/kernels/csrc/mlp_fwd.cu",
                    "recsys_tpu/kernels/pallas/mlp_tpu.py:112"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r["launches"][name] for r in serve.values()),
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(card["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                 "count": card["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Per-phase speed-of-light accounting of the DLRM bench step (the port of
``recsys_tpu/tools/roofline.py``), and what the probes measure against.

* ``VOCAB``, ``NUM_SPARSE``, ``NUM_DENSE``, ``EMBED_DIM``, ``BATCH``,
  ``BOTTOM``, ``TOP``, ``MICROBATCH`` -- the ``bench.py`` DLRM shapes (26
  tables of 100,000 rows, D = 16, 16384 rows a batch, towers 13-512-256-16
  and 367-1024-1024-512-256-1, the dense tail in 4 slices), the port's
  copy of the JAX package's constants.
* ``SPECS`` -- published peaks by card name (NVIDIA's H100 SXM data sheet,
  dense rates, at the 700 W limit).
* ``cuda_ms(fn)`` -- mean device ms of a call, from CUDA events;
  ``timer(device)`` -- it on the card, the host clock on the CPU.
* ``chain_floor_ms(n, clock_hz)`` -- the time of n dependent f32 adds at
  ``F32_ADD_CYCLES`` each.
* ``card()`` -- nvidia-smi's name, power limit and maximum SM clock.

The accounting (``run``) times each device phase of the step alone, at
the bench shapes on the port's logical (V, D) tables, against a bound from
``SPECS``:

    phase      what runs                                   bound
    ---------  ------------------------------------------  ---------------------
    gather     26 x ``index_select``, as StackedEmbedding  HBM: rows read (64 B
                                                           each), output written,
                                                           int64 ids read
    dense      the bench DLRM's bf16 ``dense_tail``, its   tensor cores: 3 x the
               forward and backward through #1 (and #2     forward matmul FLOPs
               and #3 with ``--fused-mlps``)
    scatter    ``index_add_`` of the cotangent into a      HBM: cotangent and ids
               zero (V, D) gradient a table                read, gradients written
    update     ``torch.optim.Adam`` over the tables        HBM: 7 x table bytes
    fused_bwd  ``apply_updates_fused``: the cotangent's    HBM: p, m, v read and
               permutation and #4 over the 26 tables       written, cotangent and
               from the native prep's arrays               prep arrays read

and the whole ``Trainer.train_step`` of the bench DLRM (fused Adam, or
``--optax-path``: torch Adam over the tables) on the host clock, ending in
a synchronise: ``residual_ms`` is the step less its phases, the host's
share among it.

Run: python -m recsys_tpu_torch.tools.roofline [--batch 16384] [--iters 30]
        [--optax-path] [--fused-mlps] [--device cpu] [--out FILE]
Prints a table on stderr and one JSON object on stdout.  On the CPU the
times are host-clock times of the plain versions, and the report says so.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

VOCAB = 100_000
NUM_SPARSE = 26
NUM_DENSE = 13
EMBED_DIM = 16
BATCH = 16384
BOTTOM = (512, 256)
TOP = (1024, 1024, 512, 256)
MICROBATCH = 4  # bench.py's dense_microbatch
LR = 1e-3

SPECS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bw": 3.35e12, "bf16_flops": 989e12, "f32_flops": 67e12},
}
SLEEP_CYCLES_PER_S = 2.0e9  # at least the SM clock (H100 boost ~1.98 GHz)
# latency of a dependent f32 add on the SM, in cycles: chip_smoke.py's walk timing
# reads it with clock64 (perrow_add_chain_cycles) beside the floor (PERF.md)
F32_ADD_CYCLES = 4


def spec(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``, or None."""
    return next((s for k, s in SPECS.items() if kind.startswith(k)), None)


def chain_floor_ms(n: int, clock_hz: float) -> float:
    """ms of a chain of ``n`` dependent f32 adds at ``clock_hz``, at the
    ``F32_ADD_CYCLES`` each: the floor of a serial walk of n rows."""
    return n * F32_ADD_CYCLES / clock_hz * 1e3


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device ms per call from CUDA events around ``iters`` calls.

    A small kernel runs faster than Python can launch it, so events around
    back-to-back calls would time the host.  A sleep kernel first holds
    the device for twice as long as the host took to enqueue the calls,
    and the events then time the calls' device work alone.  Where the
    enqueue outlasts the sleep (the launch queue filled, or the host
    stalled), the device waited on the host inside the events: the count
    is halved and the timing taken again."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    while True:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sleep_s = 2 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_s = time.perf_counter() - t0
        end.synchronize()
        if queued_s < sleep_s or iters == 1:
            return start.elapsed_time(end) / iters
        iters //= 2


def timer(device):
    """ms per call of ``fn``: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        return cuda_ms

    def host_ms(fn, iters: int = 50, warmup: int = 5) -> float:
        if warmup:
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    return host_ms


def card() -> dict:
    """nvidia-smi's report of card 0: ``name``, ``power_limit`` (the raw
    text, e.g. "700.00 W"), ``max_sm_clock_hz``, and ``smi``, the line
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints."""
    def query(fields: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]

    smi = query("name,power.limit")
    name, power = (s.strip() for s in smi.rsplit(",", 1))
    mhz = query("clocks.max.sm").split()[0]
    return {"name": name, "power_limit": power, "max_sm_clock_hz": float(mhz) * 1e6,
            "smi": smi}


def fwd_flops(batch: int) -> int:
    """FLOPs of the dense tail's forward at ``batch`` rows: both towers'
    matmuls and the (F+1)^2 Gram products, the JAX package's count."""
    def mlp(in_dim, units, out_dim):
        dims = [in_dim, *units, out_dim]
        return 2 * batch * sum(a * b for a, b in zip(dims, dims[1:]))

    f = NUM_SPARSE + 1
    return (mlp(NUM_DENSE, BOTTOM, EMBED_DIM) + 2 * batch * f * f * EMBED_DIM
            + mlp(EMBED_DIM + f * (f - 1) // 2, TOP, 1))


def analytic(batch: int, vocab: int = VOCAB, tables: int = NUM_SPARSE,
             dim: int = EMBED_DIM) -> dict:
    """{phase: {'bytes', 'flops'}} the phase must move or compute, each
    input read once and each output written once (the module docstring's
    table); dense FLOPs are 3 x the forward's (forward, dgrad, wgrad)."""
    row = dim * 4
    lookups = batch * tables
    table_bytes = tables * vocab * row
    return {
        "gather": {"bytes": lookups * (2 * row + 8), "flops": 0},
        "dense": {"bytes": 0, "flops": 3 * fwd_flops(batch)},
        "scatter": {"bytes": lookups * (row + 8) + table_bytes, "flops": 0},
        "update": {"bytes": 7 * table_bytes, "flops": 0},
        # the prep's int32 slot maps (src, ids) a lookup; its pointers aside
        "fused_bwd": {"bytes": 6 * table_bytes + lookups * (row + 8), "flops": 0},
    }


def _plan(tables: int, vocab: int, dim: int):
    """The fused update's plan of ``tables`` one-column tables."""
    from recsys_tpu_torch.train.sparse_embed import EmbedPlan

    return EmbedPlan(table_names=tuple(f"table_{g}" for g in range(tables)),
                     group_cols=tuple((g,) for g in range(tables)),
                     group_offsets=tuple((0,) for _ in range(tables)),
                     group_vocab=(vocab,) * tables, embed_dim=dim)


def bench_dlrm(vocab: int = VOCAB, fused: bool = True, fused_mlps: bool = False, *,
               device=None, microbatch: int = MICROBATCH):
    """The bench DLRM (seeded 0): bf16 compute, ``microbatch`` dense
    slices, the tables' gradient tap for the fused update with
    ``fused``, the towers through #2 and #3 with ``fused_mlps``."""
    import torch

    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.models.ctr.dlrm import DLRM

    schema, _ = synthetic_ctr(num_examples=8, num_dense=NUM_DENSE, num_sparse=NUM_SPARSE,
                              vocab_size=vocab, embed_dim=EMBED_DIM)
    torch.manual_seed(0)
    return DLRM(schema, bottom_units=(*BOTTOM, EMBED_DIM), top_units=TOP,
                compute_dtype=torch.bfloat16, fused_mlps=fused_mlps,
                dense_microbatch=microbatch, sparse_embed_grads=fused, device=device)


def build_phases(batch: int, rng: np.random.Generator | None = None, *, device,
                 vocab: int = VOCAB, microbatch: int = MICROBATCH, fused_mlps: bool = False):
    """({phase: zero-argument fn}, ``analytic``) at ``batch`` rows on
    ``device``: each fn runs its phase once (the update phases in place;
    ``fused_bwd`` returns its {name: table}).  ``dense`` is the bench
    DLRM's own tail (``DLRM.dense_tail``) and its gradient."""
    import torch

    from recsys_tpu_torch.train.streaming_embed import apply_updates_fused, make_host_prep
    from recsys_tpu_torch.tools.dense_probe import tail_step

    rng = np.random.default_rng(0) if rng is None else rng
    gen = torch.Generator(device=device).manual_seed(0)
    n, d = NUM_SPARSE, EMBED_DIM

    def tabs():
        return [torch.rand((vocab, d), generator=gen, device=device) * 0.1 - 0.05
                for _ in range(n)]

    ids_np = rng.integers(0, vocab, (batch, n), dtype=np.int64)
    ids = [torch.from_numpy(np.ascontiguousarray(ids_np[:, g])).to(device) for g in range(n)]
    cot = torch.randn((batch, n, d), generator=gen, device=device) * 1e-2
    cots = [cot[:, g].contiguous() for g in range(n)]

    gather_tables = tabs()

    def gather_fn():
        return [t.index_select(0, i) for t, i in zip(gather_tables, ids)]

    dense_fn = tail_step(bench_dlrm(vocab, fused_mlps=fused_mlps, device=device,
                                    microbatch=microbatch),
                         torch.from_numpy(rng.random((batch, NUM_DENSE), np.float32)),
                         torch.from_numpy(rng.standard_normal((batch, n, d)).astype(np.float32)),
                         torch.from_numpy(rng.integers(0, 2, batch).astype(np.float32)))

    def scatter_fn():
        return [torch.zeros_like(t).index_add_(0, i, c)
                for t, i, c in zip(gather_tables, ids, cots)]

    params = [torch.nn.Parameter(t) for t in tabs()]
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device=device) * 1e-3
    update_fn = torch.optim.Adam(params, lr=LR).step

    plan = _plan(n, vocab, d)
    fused_tables = dict(zip(plan.table_names, tabs()))
    state = {k: {"m": torch.zeros_like(t), "v": torch.zeros_like(t)}
             for k, t in fused_tables.items()}
    prep = make_host_prep(plan)(ids_np.astype(np.int32))
    aux = {k: torch.from_numpy(v).to(device) for k, v in prep.items()}
    step = [0]

    def fused_bwd_fn():
        step[0] += 1
        apply_updates_fused(fused_tables, state, plan, aux, cot, lr=LR, step=step[0])
        return fused_tables

    phases = {"gather": gather_fn, "dense": dense_fn, "scatter": scatter_fn,
              "update": update_fn, "fused_bwd": fused_bwd_fn}
    return phases, analytic(batch, vocab)


def full_step_ms(batch: int, rng: np.random.Generator, iters: int, fused: bool = True,
                 fused_mlps: bool = False, *, device, vocab: int = VOCAB,
                 microbatch: int = MICROBATCH, warmup: int = 2) -> float:
    """Mean ms of the bench DLRM's ``Trainer.train_step`` on one prepped
    host batch, host clock, each step ending in a synchronise: the tables
    under fused Adam (#4), or with ``fused=False`` under torch Adam with
    the dense parameters; ``fused_mlps`` takes the towers through #2 and
    #3."""
    import torch

    from recsys_tpu_torch.train.loop import Trainer
    from recsys_tpu_torch.train.streaming_embed import make_host_prep

    model = bench_dlrm(vocab, fused, fused_mlps, microbatch=microbatch)
    trainer = Trainer(model, learning_rate=LR, device=device,
                      embedding_optimizer="fused_adam" if fused else None)
    b = {"dense": rng.random((batch, NUM_DENSE), np.float32),
         "sparse": rng.integers(0, vocab, (batch, NUM_SPARSE), dtype=np.int64).astype(np.int32),
         "label": rng.integers(0, 2, batch).astype(np.float32)}
    if fused:  # prepped once, as fit's prefetch thread preps behind the steps
        b.update(make_host_prep(trainer.plan, pin=device.type == "cuda")(b["sparse"]))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        trainer.train_step(b)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        trainer.train_step(b)
        sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def run(batch: int = BATCH, iters: int = 30, fused: bool = True, fused_mlps: bool = False,
        *, device, vocab: int = VOCAB, microbatch: int = MICROBATCH) -> dict:
    """Every phase timed alone against its bound, and the full step.  With
    ``fused`` (the bench default) the step's phases are gather, dense and
    fused_bwd; else gather, dense, scatter and update.  All five are timed
    either way, for the comparison."""
    rng = np.random.default_rng(0)
    on_card = device.type == "cuda"
    import torch

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    sp = spec(kind) if on_card else None
    phases, work = build_phases(batch, rng, device=device, vocab=vocab, microbatch=microbatch,
                                fused_mlps=fused_mlps)
    report = {"device": kind, "nvidia_smi": card()["smi"] if on_card else None,
              "timer": "cuda events" if on_card else "host clock",
              "batch": batch, "vocab": vocab, "microbatch": microbatch, "fused": fused,
              "fused_mlps": fused_mlps, "phases": {}}
    step_phases = (("gather", "dense", "fused_bwd") if fused
                   else ("gather", "dense", "scatter", "update"))
    clock = timer(device)
    for name, fn in phases.items():
        a = work[name]
        entry = {"ms": clock(fn, iters, 3), "gb": a["bytes"] / 1e9,
                 "gflops": a["flops"] / 1e9}
        if sp is not None:
            bw_ms = a["bytes"] / sp["hbm_bw"] * 1e3
            fl_ms = a["flops"] / sp["bf16_flops"] * 1e3
            sol = max(bw_ms, fl_ms)
            entry.update(sol_ms=sol, pct_sol=100 * sol / entry["ms"],
                         bound="hbm" if bw_ms >= fl_ms else "tensor")
        report["phases"][name] = entry
    del phases
    total = full_step_ms(batch, rng, iters, fused=fused, fused_mlps=fused_mlps,
                         device=device, vocab=vocab, microbatch=microbatch)
    phase_sum = sum(report["phases"][p]["ms"] for p in step_phases)
    report.update(step_phases=list(step_phases), full_step_ms=total, phase_sum_ms=phase_sum,
                  residual_ms=total - phase_sum, examples_per_s=batch / (total / 1e3))
    if sp is not None:
        sol_total = sum(report["phases"][p]["sol_ms"] for p in step_phases)
        report.update(sol_step_ms=sol_total, pct_sol_step=100 * sol_total / total,
                      sol_examples_per_s=batch / (sol_total / 1e3))
    return report


def main(argv=None, **sizes):
    """The CLI; ``sizes`` (Python callers only) shrinks the run:
    ``vocab``, ``microbatch``."""
    from recsys_tpu_torch.kernels import default_device

    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.roofline")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--optax-path", action="store_true",
                   help="time the step with torch Adam over the tables instead of fused Adam")
    p.add_argument("--fused-mlps", action="store_true")
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rep = run(args.batch, args.iters, fused=not args.optax_path, fused_mlps=args.fused_mlps,
              device=default_device(args.device), **sizes)

    w = sys.stderr.write
    w(f"device={rep['device']} ({rep['nvidia_smi']}) batch={rep['batch']} "
      f"timer: {rep['timer']}\n")
    w(f"{'phase':<10}{'ms':>10}{'SoL ms':>10}{'% SoL':>8}  bound   traffic\n")
    for name, e in rep["phases"].items():
        traffic = f"{e['gb']:.4f} GB" if e["gb"] else f"{e['gflops']:.1f} GF"
        if "sol_ms" in e:
            w(f"{name:<10}{e['ms']:>10.4f}{e['sol_ms']:>10.4f}{e['pct_sol']:>8.1f}  "
              f"{e['bound']:<6}  {traffic}\n")
        else:
            w(f"{name:<10}{e['ms']:>10.4f}{'':>18}  {'':<6}  {traffic}\n")
    w(f"full step {rep['full_step_ms']:.3f} ms; phase sum {rep['phase_sum_ms']:.3f} ms; "
      f"residual {rep['residual_ms']:.3f} ms\n")
    if "pct_sol_step" in rep:
        w(f"step speed-of-light {rep['sol_step_ms']:.3f} ms -> {rep['pct_sol_step']:.1f}% "
          f"of SoL ({rep['examples_per_s']:.0f} vs {rep['sol_examples_per_s']:.0f} ex/s)\n")
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()

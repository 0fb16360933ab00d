"""What the probes measure against: the bench shapes, the card's published
peaks, CUDA-event timing and the card's own report.

* ``VOCAB``, ``NUM_SPARSE``, ``EMBED_DIM``, ``BATCH`` -- the ``bench.py``
  DLRM shapes (26 tables of 100,000 rows, D = 16, 16384 rows a batch), the
  port's copy of the JAX package's ``tools/roofline.py`` constants.
* ``SPECS`` -- published peaks by card name (NVIDIA's H100 SXM data sheet,
  dense rates, at the 700 W limit).
* ``cuda_ms(fn)`` -- mean device ms of a call, from CUDA events.
* ``chain_floor_ms(n, clock_hz)`` -- the time of n dependent f32 adds at
  ``F32_ADD_CYCLES`` each.
* ``card()`` -- nvidia-smi's name, power limit and maximum SM clock.
"""
from __future__ import annotations

import subprocess
import time

VOCAB = 100_000
NUM_SPARSE = 26
EMBED_DIM = 16
BATCH = 16384

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

"""The per-layer metrics' work counts against hand counts.

tb10m (D = 64, bottom 13-512-256-64, top 415-512-512-256-1, 351 pairs):
  MLP multiply-adds 154,112 + 605,952, interaction 351·64 = 22,464, so
  3·2·782,528 = 4.695 MFLOP an example; #4 sweeps 54,184,588 rows × 64 ×
  24 bytes = 83.23 GB, plus 55 MB of cotangent and 2 MB of ids and pointers.
kaggle (D = 16, bottom 13-512-256-64-16, top 367-512-256-1):
  155,136 + 319,232 + 351·16 = 479,984 multiply-adds, 2.880 MFLOP an
  example; #4 sweeps 33,762,577 × 16 × 24 = 12.96 GB, plus 4 MB.
"""
import importlib.util
from pathlib import Path

import pytest

from benchkit import registry

HERE = Path(__file__).resolve().parents[1]


def _metric(name):
    return registry.metric_readers()[name]


@pytest.mark.parametrize("config,batch,mflop,adam_gb", [
    ("dlrm-criteo-tb10m", 16384, 4.70, 83.2),
    ("dlrm-criteo-kaggle", 4096, 2.88, 12.97),
])
def test_work_counts_match_hand_counts(config, batch, mflop, adam_gb):
    cfg = registry.load_json("configs", config)
    assert _metric("step_mfu").flops_per_example(cfg) / 1e6 == pytest.approx(mflop, abs=0.005)
    adam = _metric("fused_adam_roofline").bytes_per_step(cfg, batch)
    assert adam / 1e9 == pytest.approx(adam_gb, rel=2e-3)
    rows, d = sum(cfg["table_rows"]), cfg["arch_sparse_feature_size"]
    assert adam > rows * d * 24  # the tables' sweep plus what the step feeds it


def test_exact_counts():
    tb = registry.load_json("configs", "dlrm-criteo-tb10m")
    assert _metric("step_mfu").flops_per_example(tb) == 6 * (154_112 + 605_952 + 22_464)
    assert _metric("dot_interaction_roofline").bytes_per_step(tb, 16384) == \
        16384 * 27 * 64 * 2 + 16384 * 351 * 4
    kg = registry.load_json("configs", "dlrm-criteo-kaggle")
    assert _metric("step_mfu").flops_per_example(kg) == 6 * 479_984
    assert _metric("dot_interaction_roofline").bytes_per_step(kg, 4096) == \
        4096 * 27 * 16 * 2 + 4096 * 351 * 4


def _ctx(trace, step_s=0.01, peaks=True):
    from benchkit.peaks import spec
    cfg = registry.load_json("configs", "dlrm-criteo-kaggle")
    return registry.kind("train").Context(cfg, 4096, [4.0, 6.0], step_s, trace,
                                          spec("NVIDIA H100 80GB HBM3") if peaks else None)


def _trace(events, steps=2, window_ns=20_000_000):
    from benchkit.devtrace import Trace
    return Trace(events, [], (0, window_ns), steps)


def test_readers_read_shares_and_stay_silent_without_a_trace():
    adam_s = 2 * 12.97e9 / 3.35e12 / 0.8  # two steps at 80% of the roofline
    events = [("void adam_kernel<float, __nv_bfloat16, false>(AdamPass, int, int, AdamHyper)",
               0, int(adam_s * 1e9)),
              ("void dot_interaction_kernel<__nv_bfloat16>(...)", 0, 1000),
              ("void adam_kernel<float, __nv_bfloat16, false>(AdamPass, int, int, AdamHyper)",
               -10_000_000, -1_000_000)]  # the lead step's, before the window
    ctx = _ctx(_trace(events))
    readers = registry.metric_readers()
    assert readers["fused_adam_roofline"].read(ctx) == pytest.approx(80.0, rel=1e-3)
    # busy 7.745 ms a step of the 10 ms untraced step
    busy = (int(adam_s * 1e9)) * 1e-9 / 2
    assert readers["device.idle_pct"].read(ctx) == pytest.approx(100 * (1 - busy / 0.01))
    assert readers["host.train_step_call_ms"].read(ctx) == pytest.approx(5.0)
    assert readers["step_mfu"].read(ctx) == pytest.approx(
        100 * 6 * 479_984 * 4096 / 0.01 / 989e12)
    assert 0 < readers["dot_interaction_roofline"].read(ctx)
    silent = _ctx(None, peaks=False)
    for name in ("fused_adam_roofline", "dot_interaction_roofline", "step_mfu",
                 "device.idle_pct"):
        assert readers[name].read(silent) is None
    no_kernel = _ctx(_trace([("other", 0, 10)]))
    assert readers["fused_adam_roofline"].read(no_kernel) is None
    assert readers["dot_interaction_roofline"].read(no_kernel) is None

"""The card's streaming and gather ceilings, measured (the port of
``recsys_tpu/tools/stream_probe.py``), at the bench shapes: 26 tables of
100,000 x 16 f32 (the port's logical tables, 6.4 MB each, 166 MB in all,
more than the H100's 50 MB L2), batches of 16384 ids.

* ``adam_stream_torch`` -- ``torch.optim.Adam`` as the ``Trainer`` makes it
  over the 26 tables: reads p, m, v, g and writes p, m, v, 7x the table
  bytes a pass (1.165 GB), the pass the CTR train step spends half its
  device time in.
* ``adam_stream_cuda`` -- the same traffic through the hand-written
  elementwise Adam (``dispatch.adam_stream_pass_``, no bias correction,
  one launch for the 26 tables): how close a single pass comes to the
  card's 3.35 TB/s.
* ``random_gather_26tables`` -- 26 gathers of 16384 uniform rows, one timed
  window: the floor of every forward lookup.
* ``gather_bytes_vs_rows`` -- the same gathers from rows of 512, 256 (bf16,
  and f32 at width 64), 64 and 32 bytes: whether the floor is set by bytes
  or by rows.
* ``perrow_walk`` -- an (8192, 128) f32 block of rows walked one row a
  step, each column in serial order, the columns spread over the SMs
  (``dispatch.perrow_colsum``): ns per row and cycles per row at the card's
  maximum SM clock (nvidia-smi).

Run: python -m recsys_tpu_torch.tools.stream_probe [--iters 30] [--seed 0]
                                                   [--device cpu] [--out FILE]
Prints one JSON object on stdout and a summary on stderr.  Times come from
CUDA events on the card; with ``--device cpu`` they are host-clock times of
the plain versions, for trying the tool out, and the report says so.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from recsys_tpu_torch.kernels import default_device, dispatch
from recsys_tpu_torch.kernels import probes as probe_ref
from recsys_tpu_torch.tools.roofline import (BATCH, EMBED_DIM, NUM_SPARSE, VOCAB, card,
                                             chain_floor_ms, spec, timer)

WIDE = 128          # the JAX probe's physical row: 8 ids of 16 packed
PERROW_ROWS = 8192  # the JAX probe's VMEM block of rows


def _tables(gen, device, n, rows, width, dtype=torch.float32):
    """``n`` tables (rows, width) from U(-0.05, 0.05)."""
    return [(torch.rand((rows, width), generator=gen, device=device) * 0.1 - 0.05).to(dtype)
            for _ in range(n)]


def _ids(gen, device, n, rows, batch):
    return [torch.randint(0, rows, (batch,), generator=gen, device=device) for _ in range(n)]


def probe_adam_stream(iters, *, device, generator, tables=NUM_SPARSE, vocab=VOCAB,
                      dim=EMBED_DIM) -> dict:
    """``torch.optim.Adam(lr=1e-3)``, as the Trainer makes it, over the
    tables with fixed gradients: 7x table bytes a pass."""
    ps = [t.requires_grad_() for t in _tables(generator, device, tables, vocab, dim)]
    for p in ps:
        p.grad = torch.randn(p.shape, generator=generator, device=device) * 1e-3
    opt = torch.optim.Adam(ps, lr=probe_ref.ADAM["lr"])
    ms = timer(device)(opt.step, iters, 3)
    traffic = 7 * tables * vocab * dim * 4
    return {"ms": ms, "traffic_gb": traffic / 1e9, "effective_gb_s": traffic / ms / 1e6}


def probe_cuda_adam_stream(iters, *, device, generator, tables=NUM_SPARSE, vocab=VOCAB,
                           dim=EMBED_DIM) -> dict:
    """The hand-written elementwise Adam (no bias correction) over the same
    tables in one pass, m and v from zero: the same 7x traffic."""
    ps = _tables(generator, device, tables, vocab, dim)
    gs = [torch.randn(p.shape, generator=generator, device=device) * 1e-3 for p in ps]
    ms_, vs = [torch.zeros_like(p) for p in ps], [torch.zeros_like(p) for p in ps]

    ms = timer(device)(lambda: dispatch.adam_stream_pass_(ps, ms_, vs, gs), iters, 3)
    traffic = 7 * tables * vocab * dim * 4
    return {"ms": ms, "traffic_gb": traffic / 1e9, "effective_gb_s": traffic / ms / 1e6}


def _gather_run(tabs, ids, iters, device) -> dict:
    def fn():
        for t, i in zip(tabs, ids):
            t.index_select(0, i)

    ms = timer(device)(fn, iters, 3)
    row_bytes = tabs[0].shape[1] * tabs[0].element_size()
    rows = sum(i.numel() for i in ids)
    return {"ms": ms, "row_bytes": row_bytes, "rows": rows,
            "effective_gb_s": rows * row_bytes / ms / 1e6, "ns_per_row": ms * 1e6 / rows}


def probe_random_gather(iters, *, device, generator, tables=NUM_SPARSE, vocab=VOCAB,
                        dim=EMBED_DIM, batch=BATCH) -> dict:
    """26 gathers of ``batch`` uniform rows of the logical f32 tables, as
    ``StackedEmbedding`` gathers (``index_select``), in one timed window."""
    tabs = _tables(generator, device, tables, vocab, dim)
    return _gather_run(tabs, _ids(generator, device, tables, vocab, batch), iters, device)


def probe_gather_bytes_vs_rows(iters, *, device, generator, tables=NUM_SPARSE, vocab=VOCAB,
                               dim=EMBED_DIM, batch=BATCH) -> dict:
    """The same 26 x ``batch`` uniform row gathers at five row widths: the
    JAX probe's f32 x 128 (512 B), bf16 x 128 and f32 x 64 (256 B) on
    (vocab/8, 128) tables, and the port's logical f32 x 16 (64 B) and bf16
    x 16 (32 B).  If halving the bytes halves the time the floor is
    bandwidth; if the time barely moves it is per-row cost."""
    phys = -(-vocab * dim // WIDE)
    phys += (-phys) % 8
    wide = _tables(generator, device, tables, phys, WIDE)
    wide_ids = _ids(generator, device, tables, phys, batch)
    narrow = _tables(generator, device, tables, vocab, dim)
    narrow_ids = _ids(generator, device, tables, vocab, batch)
    out = {
        "f32_w128": _gather_run(wide, wide_ids, iters, device),
        "bf16_w128": _gather_run([t.to(torch.bfloat16) for t in wide], wide_ids, iters, device),
        "f32_w64": _gather_run([t[:, :WIDE // 2].contiguous() for t in wide], wide_ids, iters,
                               device),
        "f32_w16": _gather_run(narrow, narrow_ids, iters, device),
        "bf16_w16": _gather_run([t.to(torch.bfloat16) for t in narrow], narrow_ids, iters,
                                device),
    }
    out["bf16_speedup_vs_f32"] = out["f32_w128"]["ms"] / out["bf16_w128"]["ms"]
    out["bf16_speedup_vs_f32_w16"] = out["f32_w16"]["ms"] / out["bf16_w16"]["ms"]
    return out


def probe_perrow_walk(iters, *, device, generator, rows=PERROW_ROWS, width=WIDE,
                      clock_hz=None, hbm_bw=None) -> dict:
    """(rows, width) f32 walked one row a step, each column in serial order
    (``dispatch.perrow_colsum``); ns per row, cycles per row at
    ``clock_hz`` (the card's maximum SM clock), the add-chain floor at it
    and the bytes bound at ``hbm_bw`` (bytes/s), when given."""
    x = torch.randn((rows, width), generator=generator, device=device)
    ms = timer(device)(lambda: dispatch.perrow_colsum(x), iters, 3)
    ns = ms * 1e6 / rows
    return {"rows": rows, "width": width, "ms": ms, "ns_per_row": ns,
            "bound_ms": (rows + 1) * width * 4 / hbm_bw * 1e3 if hbm_bw else None,
            "clock_hz": clock_hz,
            "cycles_per_row_at_clock": ns * clock_hz / 1e9 if clock_hz else None,
            "chain_floor_ms": chain_floor_ms(rows, clock_hz) if clock_hz else None}


def main(argv=None, **sizes):
    """The CLI; ``sizes`` (Python callers only) shrinks the probes:
    ``tables``, ``vocab``, ``dim``, ``batch``, ``rows``, ``width``."""
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.stream_probe")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = default_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    table_kw = {k: sizes[k] for k in ("tables", "vocab", "dim") if k in sizes}
    gather_kw = {**table_kw, **({"batch": sizes["batch"]} if "batch" in sizes else {})}
    walk_kw = {k: sizes[k] for k in ("rows", "width") if k in sizes}
    on_card = device.type == "cuda"
    info = card() if on_card else None
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peaks = spec(kind)
    rep = {"device": kind, "nvidia_smi": info["smi"] if info else None,
           "timer": "cuda events" if on_card else "host clock",
           "spec_hbm_gb_s": peaks["hbm_bw"] / 1e9 if peaks else None}
    kw = dict(device=device, generator=gen)
    rep["adam_stream_torch"] = probe_adam_stream(args.iters, **kw, **table_kw)
    rep["adam_stream_cuda"] = probe_cuda_adam_stream(args.iters, **kw, **table_kw)
    rep["random_gather_26tables"] = probe_random_gather(args.iters, **kw, **gather_kw)
    rep["gather_bytes_vs_rows"] = probe_gather_bytes_vs_rows(args.iters, **kw, **gather_kw)
    rep["perrow_walk"] = probe_perrow_walk(
        args.iters, **kw, **walk_kw, clock_hz=info["max_sm_clock_hz"] if info else None,
        hbm_bw=peaks["hbm_bw"] if peaks else None)

    w = sys.stderr.write
    w(f"device={kind} ({rep['nvidia_smi']}), spec HBM {rep['spec_hbm_gb_s']} GB/s, "
      f"timer: {rep['timer']}\n")
    for key in ("adam_stream_torch", "adam_stream_cuda"):
        r = rep[key]
        w(f"{key:18s}: {r['effective_gb_s']:.1f} GB/s ({r['ms']:.4f} ms for "
          f"{r['traffic_gb']:.3f} GB)\n")
    r = rep["random_gather_26tables"]
    w(f"random gather x26 : {r['effective_gb_s']:.1f} GB/s, {r['ns_per_row']:.3f} ns/row\n")
    gb = rep["gather_bytes_vs_rows"]
    w("gather bytes/rows : " + ", ".join(
        f"{k} {gb[k]['ms']:.4f} ms" for k in ("f32_w128", "bf16_w128", "f32_w64", "f32_w16",
                                               "bf16_w16")) + "\n")
    r = rep["perrow_walk"]
    cyc = r["cycles_per_row_at_clock"]
    w(f"per-row walk      : {r['ns_per_row']:.3f} ns/row"
      + (f" ({cyc:.1f} cycles at {r['clock_hz'] / 1e6:.0f} MHz)\n" if cyc else "\n"))
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep



if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (recsys_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA GPU (sm_90a: H100) and nvcc; run from the root of a
checkout.  Phases, one JSON line each:

1. card      -- nvidia-smi's name and power limit (also printed raw).
2. build     -- nvcc builds every kernel from recsys_tpu_torch/kernels/csrc.
3. check     -- each kernel against its plain PyTorch version on the card,
                TF32 off: the forward kernels at the serving shapes and a
                ragged batch, f32 and bf16; the MLP backward for both towers
                at 4096 and 1000 rows, bit for bit on integer values and
                within limits on random weights; the embedding updates on one
                100k x 16 table with a 16384-id batch, uniform and skewed,
                with a ragged last block, f32 and bf16 tables, bf16 and f32
                sums and weight decay off and on.
4. serve     -- DLRM at the bench widths (26 x 100k-row tables, D = 16,
                bottom 13-512-256-16-16, top 367-1024-1024-512-256-1, bf16
                compute, 4 dense microbatches), weights made from the seed in
                the JAX package's layout and converted with params_from_jax,
                served by Trainer.predict over 16384-row requests plus a
                ragged tail, with fused_mlps off and on.  Launch counts are
                zeroed before each run and read after it; the logits are
                held against the same model run through the plain versions.
5. train     -- the same DLRM trained by Trainer.fit for one epoch of
                TRAIN_STEPS 16384-row steps: fused Adam with fused_mlps off
                and on, and fused rowwise AdaGrad.  Launch counts as in
                serve; the loss must be finite; one more train_step is held
                against the same step through the plain versions from a copy
                of the state; step time, examples/s, peak memory and a
                profile of one step.
6. timing    -- per-kernel ms beside its bound and the plain version's ms;
                the embedding updates over 26 tables in turn, as a step
                calls them.
7. kernels   -- one line naming every kernel with its launches and times.

The last line is {"ok": true, "device": {...}}.  Any failed check raises, and
the script exits non-zero; with no card it exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import copy
import functools
import itertools
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
F32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
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
TRAIN_STEPS = 10       # one fit epoch
LR = 1e-3
UPDATE_BLOCK = 512     # table rows per embedding-update block (host prep too)
UPDATE_CH = 256

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
# - MLP backward (mlp_bwd_check.py states the limits and why): bit for bit
#   on integer values, where every sum is exact; on random weights, dx as
#   the MLP above, on the rows away from a relu kink, and each dW and db
#   within 1e-4 of the magnitudes of its terms (f32) or by its relative
#   norm error (bf16).
# - Embedding updates: the same values summed in another order (shared-
#   memory atomics), the tolerances of tests/test_streaming_embed.py: table
#   and Adam moments at step 3 from a random state; the AdaGrad
#   accumulator; a bf16 table is one bf16 rounding of the f32 result.
ADAM_TOL = dict(rtol=2e-4, atol=1e-7)
ACC_TOL = dict(rtol=1e-4, atol=1e-9)
ADAGRAD_P_TOL = dict(rtol=1e-3, atol=2e-7)
BF16_TABLE_TOL = dict(rtol=8e-3, atol=1e-6)
# - One train step, kernels against plain versions from the same state:
#   the loss is a mean of per-example losses of logits held to LOGIT_TOL.
#   After ten steps of history one Adam step moves a cell by at most about
#   lr, and a gradient that differs by bf16 roundings moves it by a small
#   share of that: cells of the dense params and tables may differ by more
#   than lr/10 in at most 1% of a tensor.  Optimizer state: m (and the
#   AdaGrad accumulator) take 10% (or all) of one gradient whose bf16
#   roundings may differ; v squares it: at most 0.1% of cells outside
#   rtol 3e-2 (m) or 6e-2 (v, acc).
STEP_P_THRESH, STEP_P_SHARE = LR / 10, 1e-2
STEP_STATE_TOL = {"m": dict(rtol=3e-2, atol=1e-9), "v": dict(rtol=6e-2, atol=1e-12),
                  "acc": dict(rtol=6e-2, atol=1e-12)}
STEP_STATE_SHARE = 1e-3
#   The dense params' Adam first moment, whose step adds 10% of the
#   gradient: per tensor, the norm of the difference over the norm.
STEP_MOMENT_RTOL = 1e-2


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


def mlp_bwd_work(b, dims) -> tuple[float, float]:
    """(bytes, operations) of one fused MLP backward: x, g and dx once,
    every f32 weight and bias read and its gradient written once; the
    hidden layers recomputed (all but the last layer) plus dx and dW."""
    w = [a * c for a, c in zip(dims, dims[1:])]
    n_w = sum(wi + c for wi, c in zip(w, dims[1:]))
    return ((2 * b * dims[0] + b * dims[-1] + 2 * n_w) * 4,
            2 * b * sum(w[:-1]) + 4 * b * sum(w))


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
    worst["mlp_bwd"] = check_mlp_bwd(rng, dev)
    worst.update(check_embedding_update(rng, dev))
    torch.cuda.synchronize()
    return worst


def check_mlp_bwd(rng, dev) -> float:
    """fused_mlp_backward against mlp_backward for both towers at 4096 and
    1000 rows, f32 and bf16, in the two checks of mlp_bwd_check.py: on
    integer values bit for bit, where a dW scaled by 0.9 or missing one
    32-row step of its batch sum must not pass; and on random weights, dW
    and db to a share of their terms (f32) or by their norm (bf16), with
    the distance of the kernel and of the plain version from the same chain
    summed in float64.  Returns the worst dx abs error in bf16 on random
    weights."""
    import torch

    import mlp_bwd_check as chk
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels.mlp import mlp_backward

    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    worst = 0.0
    f = NUM_SPARSE + 1
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [EMBED_DIM + f * (f - 1) // 2, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [to(w) for w in ws]
        tb = [to(v[None]) for v in bs]
        for b in (BATCH // MICROBATCH, 1000):
            xe, ge, we, be = chk.exact_case(rng, b, dims)
            xe, ge, we, be = to(xe), to(ge), [to(w) for w in we], [to(v) for v in be]
            top = chk.largest_term_sum(xe, ge, we, be)
            for mm_bf16 in (False, True):
                case = f"mlp_bwd {name} b={b} mm_bf16={mm_bf16}"
                got = dispatch.fused_mlp_backward(xe, ge, we, be, mm_bf16)
                want = mlp_backward(xe, ge, we, be, mm_bf16)
                same = all(torch.equal(u, v) for u, v in
                           zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]))
                step = mlp_backward(xe[:32], ge[:32], we, be, mm_bf16)[1]
                caught = all(not torch.equal(0.9 * u, v) and not torch.equal(u - s32, v)
                             for u, v, s32 in zip(got[1], want[1], step))
                ok = same and caught and top < chk.EXACT_LIMIT
                emit({"phase": "check", "case": case + " integer values", "bit_equal": same,
                      "wrong_dw_caught": caught, "largest_term_sum": top,
                      "exact_below": chk.EXACT_LIMIT, "ok": ok})
                if not ok:
                    raise AssertionError(f"{case}: not bit-equal to the plain version on "
                                         "integer values, or a wrong dW passes")

            x = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
            g = torch.from_numpy(rng.standard_normal((b, dims[-1]), dtype=np.float32)).to(dev)
            # rows at a relu kink may differ by O(1) between two correct sums
            keep = chk.kink_free_rows(x, tw, tb)
            x, g = x[keep].contiguous(), g[keep].contiguous()
            sw, sb = chk.term_scales(x, g, tw, tb)
            for mm_bf16 in (False, True):
                tol = MLP_BF16_TOL if mm_bf16 else MLP_F32_TOL
                got = dispatch.fused_mlp_backward(x, g, tw, tb, mm_bf16)
                want = mlp_backward(x, g, tw, tb, mm_bf16)
                exact = chk.f64_chain(x, g, tw, tb, mm_bf16)
                case = f"mlp_bwd {name} b={b} mm_bf16={mm_bf16}"
                err = check_close(case + " dx", got[0], want[0], tol)
                if mm_bf16:
                    worst = max(worst, err["max_abs_err"])
                norm = lambda res, ref: max(chk.norm_err(u, v) for u, v in  # noqa: E731
                                            zip(res[1] + res[2], ref[1] + ref[2]))
                step = mlp_backward(x[:32], g[:32], tw, tb, mm_bf16)[1]
                line = {"phase": "check", "case": case + " dW db",
                        "worst_norm_err": norm(got, want),
                        "kernel_vs_f64_chain_norm_err": norm(got, exact),
                        "plain_vs_f64_chain_norm_err": norm(want, exact),
                        "kernel_vs_f64_chain_q999_over_terms": max(
                            chk.q999_over_terms(u, v, sc) for u, v, sc in
                            zip(got[1] + got[2], exact[1] + exact[2], sw + sb)),
                        "plain_vs_f64_chain_q999_over_terms": max(
                            chk.q999_over_terms(u, v, sc) for u, v, sc in
                            zip(want[1] + want[2], exact[1] + exact[2], sw + sb)),
                        "dw_32_rows_left_out_least_norm_err": min(
                            chk.norm_err(u - s32, v) for u, v, s32 in zip(got[1], want[1], step)),
                        "rows_at_a_kink_left_out": b - int(keep.sum())}
                if mm_bf16:
                    line["norm_limit"] = chk.BF16_NORM_RTOL
                    ok = line["worst_norm_err"] <= chk.BF16_NORM_RTOL
                else:
                    line.update(chk.F32_TERM_TOL, of="term sum", share_outside=max(
                        chk.f32_outside(u, v, sc) for u, v, sc in
                        zip(got[1] + got[2], want[1] + want[2], sw + sb)))
                    ok = line["share_outside"] == 0.0
                ok &= all(bool(torch.isfinite(u).all()) for u in got[1] + got[2])
                emit({**line, "ok": ok})
                if not ok:
                    raise AssertionError(f"{case}: dW/db disagree with the plain version")
    return worst


def embedding_inputs(rng, dev, vocab, skewed, block):
    """One table's update inputs for a 16384-id batch: the cotangent rows
    sorted by host prep, their ids and chunk pointers, and a random table
    and optimizer state (as if after a few steps)."""
    import torch

    from recsys_tpu_torch.train.streaming_embed import host_prep_group

    if skewed:  # Zipf-like: a few hot ids take most occurrences
        ids = np.minimum(rng.zipf(1.2, BATCH) - 1, vocab - 1).astype(np.int32)
    else:
        ids = rng.integers(0, vocab, BATCH).astype(np.int32)
    ids2d, idx, cptr = host_prep_group(ids, vp=vocab, block=block, ch=UPDATE_CH)
    cot = (rng.standard_normal((BATCH, EMBED_DIM)) * 1e-2).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {
        "cot": to(cot[idx]), "ids2d": to(ids2d), "cptr": to(cptr),
        "p": to(rng.uniform(-0.05, 0.05, (vocab, EMBED_DIM)).astype(np.float32)),
        "m": to((rng.standard_normal((vocab, EMBED_DIM)) * 1e-3).astype(np.float32)),
        "v": to(rng.uniform(1e-8, 1e-4, (vocab, EMBED_DIM)).astype(np.float32)),
        "acc": to(rng.uniform(0, 1e-4, vocab).astype(np.float32)),
    }


def check_embedding_update(rng, dev) -> dict:
    """The fused embedding updates against their plain versions on one
    bench-size table; returns the worst table error of each at the main
    path's settings (f32 table, bf16 sums, no decay)."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import embedding_update as emb_ref

    worst = {"embedding_adam": 0.0, "embedding_rowwise_adagrad": 0.0}
    # (skewed ids, table dtype, mm_bf16, weight decay, block): the last has
    # a ragged last block (100000 = 260 * 384 + 160)
    cases = [(False, torch.float32, True, 0.0, UPDATE_BLOCK),
             (True, torch.float32, True, 0.0, UPDATE_BLOCK),
             (False, torch.bfloat16, True, 0.01, UPDATE_BLOCK),
             (True, torch.bfloat16, False, 0.0, UPDATE_BLOCK),
             (False, torch.float32, False, 0.01, UPDATE_BLOCK),
             (True, torch.float32, True, 0.01, 384)]
    for skewed, p_dtype, mm_bf16, wd, block in cases:
        a = embedding_inputs(rng, dev, VOCAB, skewed, block)
        p = a["p"].to(p_dtype)
        name = (f"{'skewed' if skewed else 'uniform'} p={str(p_dtype)[6:]} "
                f"mm_bf16={mm_bf16} wd={wd} block={block}")
        main = p_dtype == torch.float32 and mm_bf16 and wd == 0.0
        p_tol = BF16_TABLE_TOL if p_dtype == torch.bfloat16 else None
        got = [p.clone(), a["m"].clone(), a["v"].clone()]
        want = [p.clone(), a["m"].clone(), a["v"].clone()]
        dispatch.fused_embedding_adam(*got, a["cot"], a["ids2d"], a["cptr"], 3, block=block,
                                      lr=LR, wd=wd, mm_bf16=mm_bf16)
        emb_ref.fused_adam(*want, a["cot"], a["ids2d"], a["cptr"], 3, block=block, lr=LR,
                           wd=wd, mm_bf16=mm_bf16)
        for key, u, v in zip("pmv", got, want):
            err = check_close(f"embedding_adam {name} {key}", u.float(), v.float(),
                              (p_tol or ADAM_TOL) if key == "p" else ADAM_TOL)
            if main and key == "p":
                worst["embedding_adam"] = max(worst["embedding_adam"], err["max_abs_err"])
        got, want = [p.clone(), a["acc"].clone()], [p.clone(), a["acc"].clone()]
        dispatch.fused_embedding_rowwise_adagrad(*got, a["cot"], a["ids2d"], a["cptr"],
                                                 block=block, lr=LR, wd=wd, mm_bf16=mm_bf16)
        emb_ref.fused_rowwise_adagrad(*want, a["cot"], a["ids2d"], a["cptr"], block=block,
                                      lr=LR, wd=wd, mm_bf16=mm_bf16)
        err = check_close(f"embedding_rowwise_adagrad {name} p", got[0].float(),
                          want[0].float(), p_tol or ADAGRAD_P_TOL)
        check_close(f"embedding_rowwise_adagrad {name} acc", got[1], want[1], ACC_TOL)
        if main:
            worst["embedding_rowwise_adagrad"] = max(worst["embedding_rowwise_adagrad"],
                                                     err["max_abs_err"])
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


@functools.cache
def plain_mlp():
    """The fused MLP as an autograd function of its plain versions."""
    import torch

    from recsys_tpu_torch.kernels.mlp import mlp_backward, mlp_forward

    class PlainMLP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mm_bf16, *params):
            ctx.save_for_backward(x, *params)
            ctx.mm_bf16 = mm_bf16
            n = len(params) // 2
            return mlp_forward(x, params[:n], params[n:], mm_bf16)

        @staticmethod
        def backward(ctx, g):
            x, *params = ctx.saved_tensors
            n = len(params) // 2
            dx, dws, dbs = mlp_backward(x, g.contiguous(), params[:n], params[n:], ctx.mm_bf16)
            return (dx, None, *dws, *dbs)

    return PlainMLP


def plain_logits(model, batch):
    """The DLRM forward with every kernel replaced by its plain version,
    called explicitly (the same math the model's own forward dispatches);
    differentiable, the fused MLP's backward being its plain version too."""
    import torch

    from recsys_tpu_torch.kernels.interactions import dot_interaction
    from recsys_tpu_torch.ops.mlp import FusedMLP

    def tower(m, x):
        if isinstance(m, FusedMLP):
            ws = [getattr(m, f"kernel_{i}") for i in range(m.num_layers)]
            bs = [getattr(m, f"bias_{i}") for i in range(m.num_layers)]
            return plain_mlp().apply(x.float().contiguous(), m.mm_bf16, *ws, *bs)
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


def plain_train_step(tr, batch):
    """``Trainer.train_step`` with every kernel replaced by its plain
    version, called explicitly: the plain forward and backward, the same
    dense optimizer, and the plain embedding update of every table."""
    import torch

    from recsys_tpu_torch.kernels import embedding_update as emb_ref
    from recsys_tpu_torch.train.losses import bce_with_logits

    db = tr._to_device(dict(batch, **tr._prep(batch["sparse"])))
    tr.model.train()
    tr.step += 1
    tr.optimizer.zero_grad(set_to_none=True)
    loss = bce_with_logits(plain_logits(tr.model, db), db["label"])
    loss.backward()
    tr.optimizer.step()
    cot_all = tr.embedding.tap.grad.reshape(-1, EMBED_DIM)
    tables = tr.tables()
    with torch.no_grad():
        for g, name in enumerate(tr.plan.table_names):
            cot = cot_all.index_select(0, db[f"embaux{g}_src"]).bfloat16()
            ids2d, cptr, st = db[f"embaux{g}_ids"], db[f"embaux{g}_ptr"], tr.emb_state[name]
            if tr.embedding_optimizer == "fused_adam":
                emb_ref.fused_adam(tables[name], st["m"], st["v"], cot, ids2d, cptr, tr.step,
                                   block=UPDATE_BLOCK, lr=LR)
            else:
                emb_ref.fused_rowwise_adagrad(tables[name], st["acc"], cot, ids2d, cptr,
                                              block=UPDATE_BLOCK, lr=LR)
    return loss.detach()


def profile_call(fn) -> dict:
    """Device time by kernel over one call of ``fn`` (which must end in a
    synchronize), from torch.profiler, and the device's idle share of the
    call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
            "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:12]]}


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
        expected = dict.fromkeys(launches, 0)
        expected.update({"dot_interaction": requests * MICROBATCH,
                         "mlp_fwd": 2 * requests * MICROBATCH if fused else 0})
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
        emit({"phase": "profile", "config": name,
              **profile_call(lambda: trainer.predict(one, batch_size=BATCH))})
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


def share_off(got, want, thresh: float) -> float:
    """Share of the cells of ``got`` more than ``thresh`` from ``want``."""
    return float(((got.double() - want.double()).abs() > thresh).double().mean())


def share_not_close(got, want, tol: dict) -> float:
    import torch

    return float((~torch.isclose(got.double(), want.double(), **tol)).double().mean())


def compare_step(name, trainer, ref, loss_k, loss_p) -> dict:
    """One train step through the kernels (``trainer``) against the same
    step through the plain versions (``ref``), from copies of one state."""
    import torch

    out = {"loss": float(loss_k), "plain_loss": float(loss_p)}
    ok = bool(torch.isclose(loss_k.double(), loss_p.double(), **LOGIT_TOL))
    got_sd, want_sd = trainer.model.state_dict(), ref.model.state_dict()
    groups = [f"table_{g}" for g in (0, NUM_SPARSE // 2, NUM_SPARSE - 1)]
    compared = [k for k in want_sd if not k.startswith("embedding.table_")]
    compared += [f"embedding.{g}" for g in groups]
    shares = {k: share_off(got_sd[k], want_sd[k], STEP_P_THRESH) for k in compared}
    out["worst_param_share"] = max(shares.values())
    ok &= out["worst_param_share"] <= STEP_P_SHARE
    state_shares = {f"{g}.{k}": share_not_close(v, ref.emb_state[g][k], STEP_STATE_TOL[k])
                    for g in groups for k, v in trainer.emb_state[g].items()}
    out["worst_state_share"] = max(state_shares.values())
    ok &= out["worst_state_share"] <= STEP_STATE_SHARE
    # the dense Adam's first moment follows the gradient (its update
    # normalises the gradient away); a gradient 20% short must show
    moments, short = {}, {}
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    for (k, pk), pp in zip(trainer.model.named_parameters(), ref.model.parameters()):
        if pk.grad is None:
            continue
        mk = trainer.optimizer.state[pk]["exp_avg"]
        mp = ref.optimizer.state[pp]["exp_avg"]
        norm = float(mp.norm())
        moments[k] = float((mk - mp).norm()) / norm
        short[k] = float((mk - (1 - b1) * 0.2 * pk.grad - mp).norm()) / norm
    out["worst_moment_rel_err"] = max(moments.values())
    out["grad_x0.8_least_moment_rel_err"] = min(short.values())
    ok &= out["worst_moment_rel_err"] <= STEP_MOMENT_RTOL < out["grad_x0.8_least_moment_rel_err"]
    out["ok"] = ok
    emit({"phase": "check", "case": f"train step {name} kernels vs plain", **out,
          "param_share_limit": STEP_P_SHARE, "state_share_limit": STEP_STATE_SHARE,
          "moment_rel_err_limit": STEP_MOMENT_RTOL})
    if not ok:
        raise AssertionError(f"train step {name}: kernels disagree with the plain versions: "
                             f"{out}, params {shares}, state {state_shares}, "
                             f"moments {moments}, moments of a short gradient {short}")
    return out


def phase_train(params, dev) -> dict:
    """Trainer.fit at bench widths: fused Adam with fused_mlps off and on,
    fused rowwise AdaGrad; returns per configuration the launches, the
    comparison with the plain versions, step time and throughput."""
    import torch

    from recsys_tpu_torch.convert import params_from_jax
    from recsys_tpu_torch.data.synthetic import synthetic_ctr
    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.models.ctr.dlrm import DLRM
    from recsys_tpu_torch.train.loop import Trainer

    n = TRAIN_STEPS * BATCH
    schema, data = synthetic_ctr(num_examples=n + BATCH, num_dense=NUM_DENSE,
                                 num_sparse=NUM_SPARSE, vocab_size=VOCAB,
                                 embed_dim=EMBED_DIM, seed=1)
    train = {k: v[:n] for k, v in data.items()}
    extra = {k: v[n:] for k, v in data.items()}  # the compared and timed step
    results = {}
    for opt, fused in (("fused_adam", False), ("fused_adam", True),
                       ("fused_rowwise_adagrad", False)):
        name = f"{opt} fused_mlps={fused}"
        model = DLRM(schema, bottom_units=BOTTOM, top_units=TOP,
                     compute_dtype=torch.bfloat16, fused_mlps=fused,
                     dense_microbatch=MICROBATCH, sparse_embed_grads=True, device=dev)
        model.load_state_dict(params_from_jax(params, schema, model))
        trainer = Trainer(model, learning_rate=LR, embedding_optimizer=opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path: counts zeroed just before, read just after
        dispatch.reset_launches()
        t0 = time.perf_counter()
        hist = trainer.fit(train, batch_size=BATCH, epochs=1, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(dispatch.LAUNCHES)
        kernel = "embedding_adam" if opt == "fused_adam" else "embedding_rowwise_adagrad"
        expected = dict.fromkeys(launches, 0)
        expected.update({"dot_interaction": MICROBATCH * TRAIN_STEPS,
                         kernel: NUM_SPARSE * TRAIN_STEPS,
                         "mlp_fwd": 2 * MICROBATCH * TRAIN_STEPS if fused else 0,
                         "mlp_bwd": 2 * MICROBATCH * TRAIN_STEPS if fused else 0})
        if launches != expected:
            raise AssertionError(f"train {name}: launches {launches}, expected {expected}")
        if not np.isfinite(hist["loss"]).all():
            raise AssertionError(f"train {name}: loss {hist['loss']} not finite")
        peak = torch.cuda.max_memory_allocated()
        # throughput: a second epoch, past the first steps' warm-up
        t0 = time.perf_counter()
        trainer.fit(train, batch_size=BATCH, epochs=1, verbose=False)
        torch.cuda.synchronize()
        fit2_s = time.perf_counter() - t0

        ref = copy.deepcopy(trainer)
        cmp = compare_step(name, trainer, ref, trainer.train_step(extra),
                           plain_train_step(ref, extra))
        del ref

        # step time: host batch with its prep (done on the prefetch thread
        # in fit), copy in, forward, backward, both optimizers
        prepped = dict(extra, **trainer._prep(extra["sparse"]))
        steps_ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(prepped)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "profile", "config": f"train {name}",
              **profile_call(lambda: (trainer.train_step(prepped), torch.cuda.synchronize()))})
        res = {"phase": "train", "config": name, "steps": TRAIN_STEPS, "rows": n,
               "epoch_loss": hist["loss"][0], "launches": launches,
               "expected_launches": expected, "step_check": cmp,
               "step_ms_median": float(np.median(steps_ms)),
               "step_ms_min": float(np.min(steps_ms)),
               "step_examples_per_s": BATCH / (float(np.median(steps_ms)) / 1e3),
               "fit_seconds": fit_s, "fit_examples_per_s": n / fit_s,
               "second_epoch_seconds": fit2_s, "second_epoch_examples_per_s": n / fit2_s,
               "max_memory_allocated_bytes": peak}
        emit(res)
        results[name] = res
        del model, trainer
        torch.cuda.empty_cache()
    return results


def phase_timing(rng, dev) -> dict:
    """Kernel and plain ms at the main path's shapes (one 4096-row
    microbatch in bf16; one 100k x 16 table and a 16384-id batch), with
    each kernel's bound."""
    import torch

    from recsys_tpu_torch.kernels import dispatch
    from recsys_tpu_torch.kernels import embedding_update as emb_ref
    from recsys_tpu_torch.kernels.interactions import dot_interaction
    from recsys_tpu_torch.kernels.mlp import mlp_backward, mlp_forward

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

    # the backward, bf16, one bottom and one top tower per microbatch
    bwd = {"ms": 0.0, "plain_ms": 0.0, "towers": {}}
    total_bytes = total_ops = 0.0
    for name, dims in (("bottom", [NUM_DENSE, *BOTTOM, EMBED_DIM]),
                       ("top", [EMBED_DIM + p, *TOP, 1])):
        ws, bs = mlp_weights(rng, dims)
        tw = [torch.from_numpy(w).to(dev) for w in ws]
        tb = [torch.from_numpy(v[None]).to(dev) for v in bs]
        xm = torch.from_numpy(rng.random((b, dims[0]), dtype=np.float32)).to(dev)
        gm = torch.from_numpy(rng.standard_normal((b, dims[-1]), dtype=np.float32)).to(dev)
        t = {"ms": cuda_ms(lambda: dispatch.fused_mlp_backward(xm, gm, tw, tb, True)),
             "plain_ms": cuda_ms(lambda: mlp_backward(xm, gm, tw, tb, True)),
             "f32_ms": cuda_ms(lambda: dispatch.fused_mlp_backward(xm, gm, tw, tb, False),
                               iters=10, warmup=2)}
        by, op = mlp_bwd_work(b, dims)
        t["bound_ms"], t["bound_by"] = bound(by, op, BF16_FLOPS)
        emit({"phase": "timing", "kernel": f"mlp_bwd {name}", "dims": dims, **t})
        bwd["towers"][name] = t
        bwd["ms"] += t["ms"]
        bwd["plain_ms"] += t["plain_ms"]
        total_bytes, total_ops = total_bytes + by, total_ops + op
    bwd["bound_ms"], bwd["bound_by"] = bound(total_bytes, total_ops, BF16_FLOPS)
    bwd["library_ms"] = None

    # the embedding updates, bf16 sums, f32 tables.  As in a step, each
    # call updates the next of NUM_SPARSE tables, so the tables come from
    # device memory (one table's p, m and v fill 19 MB of the 50 MB L2);
    # "warm_ms" updates one table again and again.
    tabs = [embedding_inputs(rng, dev, VOCAB, False, UPDATE_BLOCK) for _ in range(NUM_SPARSE)]
    for a in tabs:
        a["cot"] = a["cot"].bfloat16()
    turn = itertools.count()
    blk = dict(block=UPDATE_BLOCK, lr=LR)

    def adam(update, rotate=True):
        a = tabs[next(turn) % NUM_SPARSE if rotate else 0]
        update(a["p"], a["m"], a["v"], a["cot"], a["ids2d"], a["cptr"], 3, **blk)

    def adagrad(update, rotate=True):
        a = tabs[next(turn) % NUM_SPARSE if rotate else 0]
        update(a["p"], a["acc"], a["cot"], a["ids2d"], a["cptr"], **blk)

    vd = VOCAB * EMBED_DIM
    # what the kernel must read of the batch: the cotangent rows and ids of
    # the BATCH real occurrences (a padding slot's cotangent is never
    # loaded) and the chunk pointers
    stream_in = BATCH * EMBED_DIM * 2 + BATCH * 4 + tabs[0]["cptr"].numel() * 4
    rounds = dict(iters=2 * NUM_SPARSE, warmup=NUM_SPARSE)
    res = {}
    for name, fn, kernel, plain, nbytes, nops in (
            # p, m, v read and written, f32; about 16 flops per element
            ("embedding_adam", adam, dispatch.fused_embedding_adam, emb_ref.fused_adam,
             6 * 4 * vd, 16 * vd),
            # p read and written, f32, and one f32 accumulator per row
            ("embedding_rowwise_adagrad", adagrad, dispatch.fused_embedding_rowwise_adagrad,
             emb_ref.fused_rowwise_adagrad, 2 * 4 * vd + 2 * 4 * VOCAB, 8 * vd)):
        t = {"ms": cuda_ms(lambda: fn(kernel), **rounds),
             "warm_ms": cuda_ms(lambda: fn(kernel, rotate=False)),
             "plain_ms": cuda_ms(lambda: fn(plain), iters=NUM_SPARSE, warmup=5),
             "library_ms": None}
        t["bound_ms"], t["bound_by"] = bound(nbytes + stream_in, nops, F32_FLOPS)
        emit({"phase": "timing", "kernel": name, "table": [VOCAB, EMBED_DIM],
              "ids": BATCH, "tables_rotated": NUM_SPARSE, **t})
        res[name] = t
    return {"dot_interaction": dot, "mlp_fwd": mlp, "mlp_bwd": bwd, **res}


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
    params = jax_layout_params(rng)
    serve = phase_serve(params, dev)
    train = phase_train(params, dev)
    timing = phase_timing(rng, dev)

    csrc = "recsys_tpu_torch/kernels/csrc/"
    sources = {
        "dot_interaction": (csrc + "dot_interaction.cu",
                            "recsys_tpu/kernels/pallas/interactions_tpu.py:84"),
        "mlp_fwd": (csrc + "mlp_fwd.cu", "recsys_tpu/kernels/pallas/mlp_tpu.py:112"),
        "mlp_bwd": (csrc + "mlp_bwd.cu", "recsys_tpu/kernels/pallas/mlp_tpu.py:134"),
        "embedding_adam": (csrc + "embedding_update.cu",
                           "recsys_tpu/kernels/pallas/embedding_update_tpu.py:109"),
        "embedding_rowwise_adagrad": (csrc + "embedding_update.cu",
                                      "recsys_tpu/kernels/pallas/embedding_update_tpu.py:267"),
    }
    kernels = []
    runs = [*serve.values(), *train.values()]
    for name, (source, replaces) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(r["launches"][name] for r in runs),
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

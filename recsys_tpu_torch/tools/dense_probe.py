"""Dense-phase ceiling probe (the port of ``recsys_tpu/tools/dense_probe.py``):
how close can the DLRM bench's dense tail (bottom MLP 13-512-256-16, the
27-feature dot interaction, top MLP 367-1024-1024-512-256-1, B = 16384,
bf16) come to the tensor cores' rate, shape by shape?

1. The card's achievable bf16 matmul rate, on one large square product
   (``torch.matmul``, cuBLAS): the practical peak beside the spec sheet's.
2. Each of the phase's 24 matmuls alone (``phase_matmuls``: the forward,
   input-gradient and weight-gradient products of its 8 layers), timed
   with ``torch.matmul``, with its TFLOP/s and its share of the achievable
   rate.
3. The composition floor: those 24 times plus the interaction's forward
   (#1) and backward alone, the time the phase would take if each product
   ran at its isolated rate with nothing between them.
4. The whole ``DenseTail`` step (forward, and the gradient of the mean BCE
   with respect to its parameters and the field embeddings) under the
   levers: bf16 against f32, #1 against the torch Gram-matrix route (the
   JAX package's einsum), and the batch in 2 or 4 slices.

Run: python -m recsys_tpu_torch.tools.dense_probe [--iters 30] [--device cpu]
                                                  [--out FILE]
Prints one JSON object on stdout and a table on stderr.  On the CPU the
times are host-clock times and the report says so.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.ops.interactions import DotInteraction
from recsys_tpu_torch.ops.mlp import MLP
from recsys_tpu_torch.tools.roofline import (BATCH, BOTTOM, EMBED_DIM, NUM_DENSE, NUM_SPARSE,
                                             TOP, card, spec, timer)

N_FEATS = NUM_SPARSE + 1  # 26 embeddings + the bottom MLP's output
N_INTER = N_FEATS * (N_FEATS - 1) // 2  # 351
TOP_IN = EMBED_DIM + N_INTER  # 367
PEAK_N = 8192  # the square product of the achievable rate


def phase_matmuls(batch: int = BATCH) -> list:
    """(label, m, k, n) of every matmul in the dense phase: forward, dgrad
    (dy @ Wᵀ: m x n @ n x k) and wgrad (xᵀ @ dy: k x m @ m x n)."""
    dims = [NUM_DENSE, *BOTTOM, EMBED_DIM]
    layers = [("bot", dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    tdims = [TOP_IN, *TOP, 1]
    layers += [("top", tdims[i], tdims[i + 1]) for i in range(len(tdims) - 1)]
    out = []
    for tag, k, n in layers:
        out.append((f"{tag}:{k}->{n} fwd", batch, k, n))
        out.append((f"{tag}:{k}->{n} dgrad", batch, n, k))
        out.append((f"{tag}:{k}->{n} wgrad", k, batch, n))
    return out


class GramInteraction(nn.Module):
    """The packed lower triangle of each example's (F, D) Gram matrix in
    the input's dtype, through ``torch.bmm`` (the JAX package's einsum
    route): the probe's lever against #1."""

    def __init__(self, n_feats: int, device=None):
        super().__init__()
        rows, cols = int_ref.tril_pairs(n_feats, False)
        self.register_buffer("pairs", torch.as_tensor(rows * n_feats + cols, device=device),
                             persistent=False)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        gram = torch.bmm(feats, feats.transpose(1, 2))
        return gram.reshape(feats.shape[0], -1).index_select(1, self.pairs)


class DenseTail(nn.Module):
    """The bench DLRM's step less its embedding lookup (the JAX probe's
    flax ``DenseTail``), run by ``DLRM``'s own tail code: bottom MLP over
    the dense features, the interaction of [its output, the field
    embeddings], top MLP to one f32 logit, over ``split`` slices of the
    batch.  ``compute_dtype`` is the towers' and the interaction's;
    ``kernel_interaction`` routes the interaction through #1
    (``ops.interactions.DotInteraction``, f32 out), else through
    ``GramInteraction``.  Parameters load from the flax tree with
    ``convert.dense_tail_params_from_jax``."""

    has_dense = True
    _tail = DLRM._tail
    dense_tail = DLRM.dense_tail

    def __init__(self, compute_dtype: torch.dtype = torch.bfloat16,
                 kernel_interaction: bool = True, split: int = 1, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dense_microbatch = split
        self.bottom = MLP(NUM_DENSE, BOTTOM, out_dim=EMBED_DIM, dtype=compute_dtype,
                          device=device)
        self.top = MLP(TOP_IN, TOP, out_dim=1, dtype=compute_dtype, device=device)
        self.interaction = (DotInteraction() if kernel_interaction
                            else GramInteraction(N_FEATS, device))

    def forward(self, dense: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        return self.dense_tail(dense, e.to(self.compute_dtype))


def tail_step(tail, dense, e, labels):
    """A zero-argument fn: ``tail.dense_tail`` (a ``DenseTail``'s or the
    bench ``DLRM``'s) over ``e`` in the tail's compute dtype, the mean BCE,
    and its gradients with respect to the towers' parameters and ``e``
    (returned in that order)."""
    dev = next(tail.parameters()).device
    dense, labels = dense.to(dev), labels.to(dev)
    e = e.to(dev).requires_grad_()
    params = [*tail.bottom.parameters(), *tail.top.parameters()]
    dtype = tail.compute_dtype or torch.float32

    def step():
        loss = F.binary_cross_entropy_with_logits(tail.dense_tail(dense, e.to(dtype)), labels)
        return torch.autograd.grad(loss, [*params, e])

    return step


def time_matmul(m: int, k: int, n: int, dtype, iters: int, device, generator) -> dict:
    """(m, k) @ (k, n) alone: ms and TFLOP/s."""
    x = torch.randn((m, k), generator=generator, device=device).to(dtype)
    w = (torch.randn((k, n), generator=generator, device=device) * 0.05).to(dtype)
    ms = timer(device)(lambda: torch.matmul(x, w), iters, 3)
    return {"m": m, "k": k, "n": n, "ms": ms, "tflops": 2.0 * m * k * n / ms / 1e9}


def _tail_inputs(batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((batch, NUM_DENSE), np.float32)),
            torch.from_numpy(rng.standard_normal((batch, NUM_SPARSE, EMBED_DIM))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, batch).astype(np.float32)))


def time_phase(compute_dtype=torch.bfloat16, kernel_interaction: bool = True, split: int = 1,
               iters: int = 20, *, device, batch: int = BATCH) -> float:
    """ms of one ``DenseTail`` step (``tail_step``) under the levers."""
    torch.manual_seed(1)
    tail = DenseTail(compute_dtype, kernel_interaction, split, device=device)
    return timer(device)(tail_step(tail, *_tail_inputs(batch)), iters, 3)


LEVERS = (("bf16_kernel_inter (bench)", {}),
          ("bf16_gram_inter", {"kernel_interaction": False}),
          ("f32", {"compute_dtype": torch.float32}),
          ("bf16_split2", {"split": 2}),
          ("bf16_split4", {"split": 4}))


def run(iters: int = 30, *, device, batch: int = BATCH, peak_n: int = PEAK_N) -> dict:
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    sp = spec(name) if on_card else None
    gen = torch.Generator(device=device).manual_seed(0)
    w = sys.stderr.write
    rep = {"device": name, "nvidia_smi": card()["smi"] if on_card else None,
           "timer": "cuda events" if on_card else "host clock", "batch": batch,
           "widths": {"bottom": [NUM_DENSE, *BOTTOM, EMBED_DIM], "top": [TOP_IN, *TOP, 1]}}

    big = time_matmul(peak_n, peak_n, peak_n, torch.bfloat16, max(1, iters // 2), device, gen)
    peak = big["tflops"]
    rep["achievable_peak"] = big
    if sp is not None:
        rep["spec_tflops"] = sp["bf16_flops"] / 1e12
        rep["achievable_vs_spec"] = peak * 1e12 / sp["bf16_flops"]
    w(f"achievable bf16 rate ({peak_n}^3): {peak:.1f} TFLOP/s ({big['ms']:.4f} ms)\n")

    rows, floor_ms = [], 0.0
    for label, m, k, n in phase_matmuls(batch):
        r = time_matmul(m, k, n, torch.bfloat16, 4 * iters, device, gen)
        r["label"] = label
        r["pct_of_achievable"] = 100 * r["tflops"] / peak
        w(f"{label:22s} {r['ms']:8.4f} ms {r['tflops']:8.2f} TF/s "
          f"({r['pct_of_achievable']:5.1f}% of achievable)\n")
        rows.append(r)
        floor_ms += r["ms"]
    rep["matmuls"] = rows

    feats = torch.randn((batch, N_FEATS, EMBED_DIM), generator=gen,
                        device=device).bfloat16().requires_grad_()
    inter = DotInteraction()
    g = torch.randn((batch, N_INTER), generator=gen, device=device)
    with torch.no_grad():
        rep["interaction_fwd_ms"] = timer(device)(lambda: inter(feats), iters, 3)
    rep["interaction_fwd_bwd_ms"] = timer(device)(
        lambda: torch.autograd.grad(inter(feats), feats, g), iters, 3)
    floor_ms += rep["interaction_fwd_bwd_ms"]
    w(f"interaction #1 forward {rep['interaction_fwd_ms']:.4f} ms, with its backward "
      f"{rep['interaction_fwd_bwd_ms']:.4f} ms\n")
    rep["composition_floor_ms"] = floor_ms

    phases = {}
    for label, kw in LEVERS:
        phases[label] = time_phase(**kw, iters=max(1, iters // 2), device=device, batch=batch)
        w(f"phase {label:28s} {phases[label]:8.3f} ms\n")
    rep["phase_ms"] = phases
    measured = phases[LEVERS[0][0]]
    rep["floor_vs_measured"] = measured / floor_ms
    w(f"composition floor {floor_ms:.3f} ms vs measured {measured:.3f} ms -> "
      f"x{rep['floor_vs_measured']:.3f}\n")
    return rep


def main(argv=None, **sizes):
    """The CLI; ``sizes`` (Python callers only) shrinks the probe:
    ``batch``, ``peak_n``."""
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.dense_probe")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rep = run(args.iters, device=default_device(args.device), **sizes)
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()

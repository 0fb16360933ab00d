"""Each interaction and top-k kernel against the torch route the same op
takes outside the kernel's domain, over shapes (the port of
``recsys_tpu/tools/kernel_sweep.py``).

* ``interactions`` -- as a train step (the forward and the gradient with
  respect to the (B, F, D) field embeddings), at B in {4096, 16384}, F in
  {26, 64, 128}, D in {16, 64, 128} (shapes past 512 MiB of f32 input are
  left out, as the JAX sweep leaves them):
  the dot interaction through #1 (``dispatch.DotInteraction``, where
  ``dot_in_domain``) against the f32 Gram-matrix route
  (``kernels/interactions.py::dot_interaction`` under autograd), and the FM
  bi-interaction through #6 (``dispatch.fm_pairwise_vector``) against its
  plain version under autograd (the JAX package's XLA route).
* ``topk`` -- forward only, 1024 queries, k = 10, catalogs of 100,000 and
  1,000,000 items, D in {64, 128}: #10 (``dispatch.topk_scores_fused``)
  against ``retrieval.score_matrix_topk`` (the whole score matrix, a
  stable sort) and ``retrieval.tile_scan_topk`` (8192-item tiles), with
  ``torch.topk(q @ itemsᵀ, k)`` beside them as the library's call.

The routing is not changed by what this finds: it depends on the shape
alone.

Run: python -m recsys_tpu_torch.tools.kernel_sweep interactions|topk|all
        [--iters 20] [--quick] [--device cpu] [--out FILE]
One JSON object on stdout, a row a shape on stderr; on the CPU the
kernels' wrappers take their plain versions, host-clock timed.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from recsys_tpu_torch.kernels import default_device, dispatch
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.kernels import topk as topk_ref
from recsys_tpu_torch.tools.roofline import card, timer
from recsys_tpu_torch.train import retrieval

BATCHES, FIELDS, DIMS = (4096, 16384), (26, 64, 128), (16, 64, 128)
QUERIES, K, CATALOGS, TOPK_DIMS = 1024, 10, (100_000, 1_000_000), (64, 128)
QUICK = {"batches": (256,), "fields": (8,), "dims": (16,), "queries": 128,
         "catalogs": (2048,), "topk_dims": (64,)}
MAX_INPUT_BYTES = 512 * 1024 * 1024


def _train_ms(op, x: torch.Tensor, iters: int) -> float:
    """ms of a step: ``op(x)`` and the gradient of its sum with respect to x."""
    x = x.detach().requires_grad_()
    return timer(x.device)(lambda: torch.autograd.grad(op(x).sum(), x), iters, 2)


def sweep_interactions(iters: int, *, device, batches=BATCHES, fields=FIELDS,
                       dims=DIMS) -> list:
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for b in batches:
        for f in fields:
            for d in dims:
                if b * f * d * 4 > MAX_INPUT_BYTES:
                    continue
                x = torch.randn((b, f, d), generator=gen, device=device)
                row = {"b": b, "f": f, "d": d,
                       "fm_torch_ms": _train_ms(int_ref.fm_pairwise_vector, x, iters),
                       "fm_kernel_ms": _train_ms(dispatch.fm_pairwise_vector, x, iters),
                       "dot_torch_ms": _train_ms(int_ref.dot_interaction, x, iters),
                       "dot_in_domain": int_ref.dot_in_domain(f, d, False)}
                row["dot_kernel_ms"] = (_train_ms(dispatch.DotInteraction.apply, x, iters)
                                        if row["dot_in_domain"] else None)
                row["fm_speedup"] = row["fm_torch_ms"] / row["fm_kernel_ms"]
                row["dot_speedup"] = (row["dot_torch_ms"] / row["dot_kernel_ms"]
                                      if row["dot_kernel_ms"] else None)
                rows.append(row)
                sys.stderr.write(f"{row}\n")
    return rows


def sweep_topk(iters: int, *, device, queries: int = QUERIES, k: int = K,
               catalogs=CATALOGS, topk_dims=TOPK_DIMS) -> list:
    gen = torch.Generator(device=device).manual_seed(0)
    clock = timer(device)
    rows = []
    for n in catalogs:
        for d in topk_dims:
            q = torch.randn((queries, d), generator=gen, device=device)
            items = torch.randn((n, d), generator=gen, device=device)
            row = {"q": queries, "n": n, "d": d, "k": k,
                   "in_domain": topk_ref.in_domain(k, n, d),
                   "torch_full_ms": clock(lambda: retrieval.score_matrix_topk(q, items, k),
                                          iters, 1),
                   "torch_stream_ms": clock(lambda: retrieval.tile_scan_topk(q, items, k),
                                            iters, 1),
                   "library_ms": clock(lambda: torch.topk(q @ items.T, k), iters, 1)}
            row["kernel_ms"] = (clock(lambda: dispatch.topk_scores_fused(q, items, k), iters, 1)
                                if row["in_domain"] else None)
            row["speedup_vs_best_torch"] = (
                min(row["torch_full_ms"], row["torch_stream_ms"]) / row["kernel_ms"]
                if row["kernel_ms"] else None)
            rows.append(row)
            sys.stderr.write(f"{row}\n")
            del q, items
    return rows


def main(argv=None, **sizes):
    """The CLI; ``sizes`` (Python callers only) sets the grid: ``batches``,
    ``fields``, ``dims`` (interactions), ``queries``, ``catalogs``,
    ``topk_dims`` (top-k)."""
    p = argparse.ArgumentParser(prog="recsys_tpu_torch.tools.kernel_sweep")
    p.add_argument("mode", choices=["interactions", "topk", "all"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--quick", action="store_true", help="tiny shapes, a smoke run only")
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = default_device(args.device)
    grid = {**(QUICK if args.quick else {}), **sizes}
    on_card = device.type == "cuda"
    rep = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
           "nvidia_smi": card()["smi"] if on_card else None,
           "timer": "cuda events" if on_card else "host clock"}
    if args.mode in ("interactions", "all"):
        rep["interactions"] = sweep_interactions(
            args.iters, device=device,
            **{k: grid[k] for k in ("batches", "fields", "dims") if k in grid})
    if args.mode in ("topk", "all"):
        rep["topk"] = sweep_topk(
            args.iters, device=device,
            **{k: grid[k] for k in ("queries", "catalogs", "topk_dims") if k in grid})
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
    print(payload)
    return rep


if __name__ == "__main__":
    main()

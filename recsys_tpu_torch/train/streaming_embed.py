"""Fused embedding backward + optimizer updates (the port of
recsys_tpu.train.streaming_embed for one device and one stream).

Exact dense-optimizer semantics: every table row is updated, duplicate ids
sum, as a dense scatter-add followed by dense Adam (or rowwise AdaGrad)
would, in one pass over each table.  Per step and table group:

1. HOST (numpy, in the Trainer's prefetch thread): stable-sort the batch's
   ids of the group, bucket them by table block into ``ch``-row chunks at a
   static chunk count, and emit ``(ids2d, src, cptr)``
   (:func:`host_prep_group`, :func:`make_host_prep`).
2. DEVICE: permute the per-occurrence cotangent of the ``perturb_out`` tap
   into sorted order with one ``index_select``, then one fused kernel
   launch updates the table and its optimizer state in place
   (``kernels/dispatch.py::fused_embedding_adam`` /
   ``fused_embedding_rowwise_adagrad``).
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.train.sparse_embed import EmbedPlan

DEFAULT_BLOCK = 512  # table rows per kernel block: 196 blocks per 100k-row table
DEFAULT_CH = 256


def host_prep_group(rows: np.ndarray, *, pack: int = 1, vp: int,
                    block: int = DEFAULT_BLOCK, ch: int = DEFAULT_CH):
    """Sort and bucket one group's vocab ids for the fused kernels.

    rows: (n,) non-negative int32 vocab ids (field offsets applied, ids
    validated by the caller, as ``Trainer`` does); ``vp`` table rows
    of ``pack`` vocab rows each (the port's tables have pack 1).  Returns
    ``(ids2d (nc_max, ch) int32, idx (nc_max·ch,) int32, cptr (nb+1,)
    int32)`` with the static ``nc_max = n // ch + nb``: block k's ids fill
    chunks ``[cptr[k], cptr[k+1])`` in stable sorted order, ``idx`` holds
    each slot's position in ``rows``, and the rest is the sentinel
    ``nb·block·pack`` (idx 0).  The static padding chunks belong to the
    last block (``cptr[nb] = nc_max``).  Bit-equal to the JAX package's
    ``host_prep_group`` with one shard; the per-block copy loop is one
    vectorised scatter here.
    """
    n = rows.shape[0]
    nb = -(-vp // block)
    sentinel = np.int32(nb * block * pack)
    prow = rows // pack
    order = np.argsort(prow, kind="stable")
    bounds = np.minimum(np.arange(nb + 1) * block, vp)
    ptr = np.searchsorted(prow[order], bounds)
    chunks = -(-np.diff(ptr) // ch)
    cptr = np.concatenate([[0], np.cumsum(chunks)]).astype(np.int32)
    nc_max = n // ch + nb
    ids2d = np.full((max(nc_max, 1), ch), sentinel, np.int32)
    idx = np.zeros((max(nc_max, 1) * ch,), np.int32)
    # sorted position i of block k goes to slot cptr[k]·ch + (i - ptr[k]);
    # ids outside [0, vp) belong to no block and stay out
    pos = np.arange(ptr[0], ptr[nb])
    blk = np.repeat(np.arange(nb), np.diff(ptr))
    dest = cptr[blk].astype(np.int64) * ch + (pos - ptr[blk])
    ids2d.reshape(-1)[dest] = rows[order[pos]]
    idx[dest] = order[pos]
    cptr[nb] = nc_max
    return ids2d, idx, cptr


def make_host_prep(plan: EmbedPlan, block: int = DEFAULT_BLOCK, ch: int = DEFAULT_CH):
    """Returns ``prep(sparse (B, F) int) -> {aux key: np.ndarray}``.

    Per group g: ``embaux{g}_ids`` and ``embaux{g}_ptr`` are
    :func:`host_prep_group`'s ``ids2d`` and ``cptr``; ``embaux{g}_src``
    maps each slot to its row of the tap's ``(B·F, D)`` cotangent, so the
    device permutes with one ``index_select``.  Run it on the host, behind
    the prefetch thread, as ``Trainer.fit`` does."""
    geoms = [(max(v, 1), np.asarray(cols, np.int32), np.asarray(offs, np.int32))
             for v, cols, offs in zip(plan.group_vocab, plan.group_cols,
                                      plan.group_offsets)]

    def prep(sparse: np.ndarray) -> dict:
        b, f = sparse.shape
        aux = {}
        for g, (vp, cols, offs) in enumerate(geoms):
            rows = (sparse[:, cols].astype(np.int32) + offs).T.reshape(-1)
            ids2d, idx, cptr = host_prep_group(rows, vp=vp, block=min(block, vp), ch=ch)
            # occurrence i of the group is row i % b of column cols[i // b]
            tap_row = (np.arange(rows.size, dtype=np.int32) % b) * f + np.repeat(cols, b)
            aux[f"embaux{g}_ids"] = ids2d
            aux[f"embaux{g}_src"] = tap_row[idx]
            aux[f"embaux{g}_ptr"] = cptr
        return aux

    return prep


def apply_updates_fused(tables: dict, state: dict, plan: EmbedPlan, batch: dict,
                        pert_grad: torch.Tensor, *, lr: float, step: int,
                        weight_decay: float = 0.0, kind: str = "adam",
                        block: int = DEFAULT_BLOCK, mm_bf16: bool = True) -> None:
    """One fused update of every group table, in place.

    ``batch`` carries :func:`make_host_prep`'s arrays on the tables'
    device; ``pert_grad`` is the (B, F, D) tap cotangent.  ``kind='adam'``
    takes ``state[name] = {'m', 'v'}``, ``kind='rowwise_adagrad'``
    ``{'acc'}`` (``sparse_embed.init_state``).  ``step`` is 1-based.

    Every group goes through the kernel.  The JAX package sends groups
    under 64 KB to an XLA scatter-add instead (``TINY_TABLE_BYTES``), only
    because a mix of tiny and wide Pallas calls crashed the TPU worker;
    that fault has no counterpart on this card, and the math is the plain
    version's either way.
    """
    if kind not in ("adam", "rowwise_adagrad"):
        raise ValueError(f"unknown fused kind {kind!r}")
    flat = pert_grad.reshape(-1, plan.embed_dim)
    with torch.no_grad():
        for g, name in enumerate(plan.table_names):
            cot = flat.index_select(0, batch[f"embaux{g}_src"])
            if mm_bf16:
                cot = cot.bfloat16()
            ids2d, cptr = batch[f"embaux{g}_ids"], batch[f"embaux{g}_ptr"]
            t, st = tables[name], state[name]
            blk = min(block, t.shape[0])
            if kind == "adam":
                dispatch.fused_embedding_adam(t, st["m"], st["v"], cot, ids2d, cptr, step,
                                              block=blk, lr=lr, wd=weight_decay,
                                              mm_bf16=mm_bf16)
            else:
                dispatch.fused_embedding_rowwise_adagrad(t, st["acc"], cot, ids2d, cptr,
                                                         block=blk, lr=lr, wd=weight_decay,
                                                         mm_bf16=mm_bf16)

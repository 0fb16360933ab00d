"""Fused embedding backward + optimizer updates (the port of
recsys_tpu.train.streaming_embed).

Exact dense-optimizer semantics: every table row is updated, duplicate ids
sum, as a dense scatter-add followed by dense Adam (or rowwise AdaGrad)
would, in one pass over each table.  Per step and table group:

1. HOST (the native library, ``data/native.py``, in the Trainer's
   prefetch thread): stable-sort the batch's ids of the group, bucket them
   by table block into ``ch``-slot chunks at a static chunk count, and emit
   ``(ids2d, src, cptr)`` (:func:`make_host_prep`; :func:`host_prep_group`
   is its plain numpy version).
2. DEVICE: permute the per-occurrence cotangent of the ``perturb_out`` tap
   into sorted order with one ``index_select``, then one fused kernel
   launch updates the table and its optimizer state in place
   (``kernels/dispatch.py::fused_embedding_adam`` /
   ``fused_embedding_rowwise_adagrad``).

On a (data, model) mesh (``parallel/mesh.py``) the same exact math runs
on every rank.  Model axis: a row-sharded table's prep fences align to its
row shards (``shards``), so rank s of the model axis updates its shard
through the kernels' shard window.  Data axis: under the global data
contract every rank preps the global batch, and the cotangent of the rank's
rows is all-gathered into the global batch before the permutation; under
the local contract each rank preps and permutes its own rows, and the
sorted streams are all-gathered, one stream a data rank, for the kernels'
multi-stream form.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.data import native
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.parallel import mesh as mesh_lib
from recsys_tpu_torch.train.sparse_embed import EmbedPlan

DEFAULT_BLOCK = 512  # table rows per kernel block: 196 blocks per 100k-row table
DEFAULT_CH = 256  # the JAX package's chunk length: the TPU's one-hot MXU width
# The port's chunk length.  The CUDA kernels walk a block's chunks slot by
# slot, so a chunk is no unit of their work: what ``ch`` costs is each
# touched block's padding (up to ch - 1 slots) and the nb·ch static padding
# slots of a table, in the host's fill, the copy to the card and the
# cotangent gather.  ``tools/prep_sweep.py`` read all of them fall, and #4
# stay within 1%, from 256 down to 1 at both shapes that prep (26 tables of
# 2^20 rows with 4096 ids, of 100,000 with 16384; PERF.md's sweep), so
# every batch preps at 1, whatever the tables.
PREP_CH = 1


def host_prep_group(rows: np.ndarray, *, pack: int = 1, vp: int,
                    block: int = DEFAULT_BLOCK, ch: int = DEFAULT_CH, shards: int = 1):
    """Sort and bucket one group's vocab ids for the fused kernels.

    rows: (n,) non-negative int32 vocab ids (field offsets applied, ids
    validated by the caller, as ``Trainer`` does); ``vp`` table rows
    of ``pack`` vocab rows each (the port's tables have pack 1).  Returns
    ``(ids2d (nc_max, ch) int32, idx (nc_max·ch,) int32, cptr (nb+1,)
    int32)`` with the static ``nc_max = n // ch + nb``: block k's ids fill
    chunks ``[cptr[k], cptr[k+1])`` in stable sorted order, ``idx`` holds
    each slot's position in ``rows``, and the rest is the sentinel
    ``nb·block·pack`` (idx 0).  The static padding chunks belong to the
    last block (``cptr[nb] = nc_max``).  ``shards`` > 1 (a table row-sharded
    over a model axis, ``vp % shards == 0``) aligns the block fences to the
    shards: shard s owns rows ``[s·vs, (s+1)·vs)`` in ``nb_s =
    ceil(vs / block)`` blocks.  Bit-equal to the JAX package's
    ``host_prep_group``; the per-block copy loop is one vectorised scatter
    here.
    """
    if shards < 1 or vp % shards:
        raise ValueError(f"vp={vp} not divisible by shards={shards}")
    n = rows.shape[0]
    vs = vp // shards
    nb_s = -(-vs // block)
    nb = shards * nb_s
    sentinel = np.int32(nb * block * pack)
    prow = rows // pack
    order = np.argsort(prow, kind="stable")
    # nb_s fences a shard, at s·vs + j·block clamped to the shard's end
    s_idx = np.arange(nb + 1) // nb_s
    j_idx = np.arange(nb + 1) - s_idx * nb_s
    bounds = np.minimum(s_idx * vs + j_idx * block, np.minimum((s_idx + 1) * vs, vp))
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


def make_host_prep(plan: EmbedPlan, block: int = DEFAULT_BLOCK, ch: int = PREP_CH,
                   pin: bool = False, shards_by_name: dict | None = None):
    """Returns ``prep(sparse (B, F) int) -> {aux key: array}``: the native
    prep (``data.native.fused_prep_group``) of every group at chunk length
    ``ch`` (one for every group: one launch of #4 takes one).

    Per group g: ``embaux{g}_ids`` and ``embaux{g}_ptr`` are
    :func:`host_prep_group`'s ``ids2d`` and ``cptr``; ``embaux{g}_src``
    maps each slot to its row of the tap's ``(B·F, D)`` cotangent, so the
    device permutes with one ``index_select``.  The arrays are numpy, or
    with ``pin`` int32 tensors in pinned host memory (from torch's caching
    host allocator, which reuses a block only after the copies recorded on
    it have run), for ``non_blocking`` copies to the card.  Run it on the
    host, behind the prefetch thread, as ``Trainer.fit`` does: the native
    calls release the interpreter lock.

    ``shards_by_name`` (table name -> shard count, as ``Trainer`` placed the
    tables; 1 where a name is missing) sets each group's shard fences;
    ``apply_updates_fused`` must run with the same.  Under the local data
    contract each rank preps only its own rows, and ``apply_updates_fused``
    all-gathers the sorted streams."""
    geoms = []
    for name, v, cols, offs in zip(plan.table_names, plan.group_vocab, plan.group_cols,
                                   plan.group_offsets):
        vp = max(v, 1)
        shards = (shards_by_name or {}).get(name, 1)
        geoms.append((vp, min(block, vp // shards), np.asarray(cols, np.int32),
                      np.asarray(offs, np.int32), shards))

    def empty(shape):
        if not pin:
            a = np.empty(shape, np.int32)
            return a, a
        t = torch.empty(shape, dtype=torch.int32, pin_memory=True)
        return t, t.numpy()

    def prep(sparse: np.ndarray) -> dict:
        sparse = np.ascontiguousarray(sparse, np.int32)
        b = sparse.shape[0]
        aux = {}
        for g, (vp, blk, cols, offs, shards) in enumerate(geoms):
            nc, nb = native.prep_geometry(b * len(cols), vp, blk, ch, shards)
            (ids2d, ids_np), (src, src_np), (cptr, cptr_np) = (
                empty((nc, ch)), empty((nc * ch,)), empty((nb + 1,)))
            native.fused_prep_group(sparse, cols, offs, vp, blk, ch, ids_np, src_np, cptr_np,
                                    shards)
            aux[f"embaux{g}_ids"], aux[f"embaux{g}_src"], aux[f"embaux{g}_ptr"] = ids2d, src, cptr
        return aux

    return prep


def apply_updates_fused(tables: dict, state: dict, plan: EmbedPlan, batch: dict,
                        pert_grad: torch.Tensor, *, lr: float, step: int,
                        weight_decay: float = 0.0, kind: str = "adam",
                        block: int = DEFAULT_BLOCK, mm_bf16: bool = True, mesh=None,
                        shards_by_name: dict | None = None,
                        data_contract: str = "global") -> None:
    """One fused update of every group table, in place.

    ``batch`` carries :func:`make_host_prep`'s arrays on the tables'
    device; ``pert_grad`` is the (B, F, D) tap cotangent.  ``kind='adam'``
    takes ``state[name] = {'m', 'v'}``, ``kind='rowwise_adagrad'``
    ``{'acc'}`` (``sparse_embed.init_state``).  ``step`` is 1-based.

    Every group goes through the kernel.  The JAX package sends groups
    under 64 KB to an XLA scatter-add instead (``TINY_TABLE_BYTES``), only
    because a mix of tiny and wide Pallas calls crashed the TPU worker;
    that fault has no counterpart on this card, and the math is the plain
    version's either way.  Adam makes every group's cotangent first and
    then updates all the groups in one launch
    (``dispatch.fused_embedding_adam_pass``).

    With a ``mesh``, ``tables`` and ``state`` are this rank's (a row-sharded
    table's shard, ``shards_by_name`` giving each table's shard count as
    the prep had it) and ``pert_grad`` is the cotangent of this rank's rows.
    Under ``data_contract='global'`` the batch's arrays are the global
    batch's prep; under ``'local'`` this rank's rows', and the sorted
    streams of the data axis are all-gathered.
    """
    if kind not in ("adam", "rowwise_adagrad"):
        raise ValueError(f"unknown fused kind {kind!r}")
    if data_contract not in ("global", "local"):
        raise ValueError(f"data_contract={data_contract!r} not in ('global', 'local')")
    flat = pert_grad.reshape(-1, plan.embed_dim)
    streams, model_index = 1, 0
    if mesh is not None:
        model_index = mesh.index(mesh_lib.MODEL_AXIS)
        if data_contract == "global":  # the global batch's cotangent, rows in order
            flat = mesh_lib.all_gather(flat, mesh, mesh_lib.DATA_AXIS)
        else:
            streams = mesh.size(mesh_lib.DATA_AXIS)
    with torch.no_grad():
        groups = []  # (table, state, cotangent, ids2d, cptr, block, shard index) a group
        for g, name in enumerate(plan.table_names):
            cot = flat.index_select(0, batch[f"embaux{g}_src"])
            if mm_bf16:
                cot = cot.bfloat16()
            ids2d, cptr = batch[f"embaux{g}_ids"], batch[f"embaux{g}_ptr"]
            if streams > 1:  # every data rank's sorted stream, one after the other
                cot, ids2d, cptr = (mesh_lib.all_gather(x, mesh, mesh_lib.DATA_AXIS)
                                    for x in (cot, ids2d, cptr))
            sharded = (shards_by_name or {}).get(name, 1) > 1
            if sharded and mesh is None:
                raise ValueError(f"{name} is prepped for model shards but no mesh was passed")
            t = tables[name]
            groups.append((t, state[name], cot, ids2d, cptr, min(block, t.shape[0]),
                           model_index if sharded else 0))
        if kind == "adam":  # every group's cotangent first, then one launch
            t, st, cot, ids2d, cptr, blk, si = zip(*groups)
            dispatch.fused_embedding_adam_pass(
                t, [s["m"] for s in st], [s["v"] for s in st], cot, ids2d, cptr, step,
                blocks=blk, lr=lr, wd=weight_decay, mm_bf16=mm_bf16, streams=streams,
                shard_indices=si)
            return
        for t, st, cot, ids2d, cptr, blk, si in groups:
            dispatch.fused_embedding_rowwise_adagrad(t, st["acc"], cot, ids2d, cptr,
                                                     block=blk, lr=lr, wd=weight_decay,
                                                     mm_bf16=mm_bf16, streams=streams,
                                                     shard_index=si)

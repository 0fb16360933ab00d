"""Kernel wrappers: a CUDA tensor launches the hand-written kernel or raises;
a CPU tensor takes the plain PyTorch version.  There is no fallback from a
failed launch to the plain path.

``LAUNCHES`` counts, per kernel, the launches each wrapper made (plain
integers, incremented only where a kernel is launched), so a run can show
that its main path went through the kernels.

``DotInteraction``, ``FMPairwiseVector``, ``FusedMLPFunction``,
``FlashAttention`` and ``SegmentSumGather`` are the autograd functions the
model layers call: their forwards are the forward kernels; the dot
interaction's, the FM bi-interaction's and the pooled gather's backwards are
torch ops (the JAX package leaves them to XLA), the
fused MLP's backward is the ``mlp_bwd`` kernel and the attention's the
``flash_attention_bwd`` kernels.  ``topk_scores_fused`` (retrieval) has no
gradient, nor have the probe kernels' wrappers ``adam_stream_pass_``
(and its one-table case ``adam_stream_step_``), ``perrow_colsum`` and
``hot_gather`` (``tools/stream_probe.py``,
``tools/gather_split_probe.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from recsys_tpu_torch.kernels import attention as attn_ref
from recsys_tpu_torch.kernels import build
from recsys_tpu_torch.kernels import embedding as gather_ref
from recsys_tpu_torch.kernels import embedding_update as emb_ref
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.kernels import mlp as mlp_ref
from recsys_tpu_torch.kernels import probes as probe_ref
from recsys_tpu_torch.kernels import topk as topk_ref

LAUNCHES = {"dot_interaction": 0, "fm_pairwise_vector": 0, "mlp_fwd": 0, "mlp_bwd": 0,
            "embedding_adam": 0, "embedding_rowwise_adagrad": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "pooled_gather": 0, "topk_scores": 0,
            "adam_stream": 0, "perrow_walk": 0, "hot_gather": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, tensors: Sequence[torch.Tensor], device) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def dot_interaction(x: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """(B, F, D) f32 or bf16 -> (B, P) f32 packed lower Gram triangle."""
    if x.dim() != 3:
        raise ValueError(f"dot_interaction: expected (B, F, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dot_interaction: dtype {x.dtype} not f32 or bf16")
    if x.device.type == "cpu":
        return int_ref.dot_interaction(x, self_interaction)
    if x.device.type != "cuda":
        raise ValueError(f"dot_interaction: no kernel for device {x.device}")
    _check_cuda("dot_interaction", [x], x.device)
    b, f, d = x.shape
    lib = build.libraries()["dot_interaction"]
    p = int_ref.num_pairs(f, self_interaction)
    if p < 1 or lib.dot_interaction_tile(f, d, int(self_interaction)) < 1:
        raise ValueError(f"dot_interaction: kernel does not take F={f}, D={d}")
    out = torch.empty((b, p), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        rc = lib.dot_interaction_launch(
            x.data_ptr(), out.data_ptr(), b, f, d, int(self_interaction),
            int(x.dtype == torch.bfloat16), _stream(x),
        )
    build.check(rc, "dot_interaction")
    LAUNCHES["dot_interaction"] += 1
    return out


def fm_pairwise_vector_fused(x: torch.Tensor) -> torch.Tensor:
    """(B, F, D) f32 or bf16 -> (B, D) f32 bi-interaction pooling
    0.5·((Σ_f x)² − Σ_f x²), f32 sums; see ``kernels/interactions.py``.  The
    kernel takes every F ≥ 1 and D ≥ 1."""
    if x.dim() != 3 or x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"fm_pairwise_vector: expected (B, F, D) with F, D >= 1, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fm_pairwise_vector: dtype {x.dtype} not f32 or bf16")
    if x.device.type == "cpu":
        return int_ref.fm_pairwise_vector(x)
    if x.device.type != "cuda":
        raise ValueError(f"fm_pairwise_vector: no kernel for device {x.device}")
    _check_cuda("fm_pairwise_vector", [x], x.device)
    b, f, d = x.shape
    out = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        rc = build.libraries()["fm_interaction"].fm_pairwise_vector_launch(
            x.data_ptr(), out.data_ptr(), b, f, d, int(x.dtype == torch.bfloat16),
            _stream(x))
    build.check(rc, "fm_pairwise_vector")
    LAUNCHES["fm_pairwise_vector"] += 1
    return out


def _mlp_dims(name: str, x: torch.Tensor, ws, bs) -> list[int]:
    """The widths the layers chain through; raises on shapes or dtypes the
    kernels do not take."""
    if x.dim() != 2 or len(ws) != len(bs) or not ws:
        raise ValueError(f"{name}: expected x (B, D0) and one bias per weight")
    dims = [x.shape[1]]
    for w, b in zip(ws, bs):
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.numel() != w.shape[1]:
            raise ValueError(
                f"{name}: layer shapes {tuple(w.shape)}, "
                f"{tuple(b.shape)} do not chain from width {dims[-1]}"
            )
        dims.append(w.shape[1])
    if any(t.dtype != torch.float32 for t in (x, *ws, *bs)):
        raise TypeError(f"{name}: x, weights and biases must be f32")
    return dims


# The launches of a fused-MLP call, for launching them apart
MLP_PACK, MLP_CHAIN, MLP_DW = 1, 2, 4
# Kernel B's batch slices hold at least this many rows
MLP_MIN_SLICE_ROWS = 256


def _ptrs(ts):
    """A host array of device pointers, and the ctypes array to keep alive."""
    arr = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


_MLP_WRAPPER = {"mlp_fwd": "fused_mlp_forward", "mlp_bwd": "fused_mlp_backward"}


def _mlp_lib(name: str, dims: list[int], mm_bf16: bool):
    """The kernel library ``name`` and the C dims array; raises on widths
    the kernels do not take."""
    lib = build.libraries()[name]
    c_dims = (ctypes.c_int * len(dims))(*dims)
    smem = getattr(lib, f"{name}_smem_bytes")
    if smem(ctypes.cast(c_dims, ctypes.c_void_p), len(dims) - 1, int(mm_bf16)) == 0:
        raise ValueError(f"{_MLP_WRAPPER[name]}: kernel does not take widths {dims}")
    return lib, c_dims


def _packed(dims, backward, device) -> torch.Tensor:
    """Scratch for the pre-pass's tiles (bf16, uninitialised)."""
    n = mlp_ref.packed_tile_count(dims, backward)
    return torch.empty((n, mlp_ref.TILE_K, mlp_ref.TILE_LD), dtype=torch.bfloat16, device=device)


def mlp_forward_call(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                     mm_bf16: bool = True):
    """One fused forward on CUDA tensors with B >= 1, checked and allocated
    but not launched: returns ``(launch, bufs)``.  ``launch(parts)`` runs
    the chosen kernels, ``MLP_PACK`` (the bf16 pre-pass that rounds and
    packs the weights into ``bufs["packed"]``) and ``MLP_CHAIN`` (which
    writes ``bufs["out"]``); the f32 path has no pre-pass.
    ``fused_mlp_forward`` launches both; apart they time each part and hold
    the pre-pass against ``kernels/mlp.py::pack_weight_tiles``.  It counts
    no launch."""
    dims = _mlp_dims("fused_mlp_forward", x, ws, bs)
    _check_cuda("fused_mlp_forward", [x, *ws, *bs], x.device)
    lib, c_dims = _mlp_lib("mlp_fwd", dims, mm_bf16)
    bufs = {"out": torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device),
            "packed": _packed(dims, False, x.device) if mm_bf16 else None}
    packed = bufs["packed"].data_ptr() if mm_bf16 else None

    def launch(parts: int) -> None:
        (pw, _kw), (pb, _kb) = _ptrs(ws), _ptrs(bs)
        with torch.cuda.device(x.device):
            rc = lib.mlp_fwd_launch(
                x.data_ptr(), bufs["out"].data_ptr(), pw, pb, packed,
                ctypes.cast(c_dims, ctypes.c_void_p), len(ws), x.shape[0], int(mm_bf16), parts,
                _stream(x))
        build.check(rc, "fused_mlp_forward")

    return launch, bufs


def fused_mlp_forward(x: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor], mm_bf16: bool = True) -> torch.Tensor:
    """x (B, D0) f32; ws [(D_{i-1}, D_i)] f32; bs [(D_i,) or (1, D_i)] f32
    -> (B, D_k) f32.  Relu hidden layers, linear last layer; matmuls in
    bf16 with f32 accumulation when ``mm_bf16``, else exact f32."""
    dims = _mlp_dims("fused_mlp_forward", x, ws, bs)
    if x.device.type == "cpu":
        return mlp_ref.mlp_forward(x, ws, bs, mm_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_forward: no kernel for device {x.device}")
    if x.shape[0] == 0:
        _check_cuda("fused_mlp_forward", [x, *ws, *bs], x.device)
        _mlp_lib("mlp_fwd", dims, mm_bf16)
        return torch.empty((0, dims[-1]), dtype=torch.float32, device=x.device)
    launch, bufs = mlp_forward_call(x, ws, bs, mm_bf16)
    launch(MLP_PACK | MLP_CHAIN)
    LAUNCHES["mlp_fwd"] += 1
    return bufs["out"]


def mlp_bwd_split(dims: Sequence[int], b: int, sms: int) -> tuple[int, int]:
    """(slices, rows a slice) of kernel B's batch sum: where the bf16 dW
    tiles (``kernels/mlp.py::DW_TILE`` square) of a tower leave more than
    half the card's ``sms`` idle, the batch is cut into sms // tiles slices
    of at least ``MLP_MIN_SLICE_ROWS`` rows, each a multiple of 32, none
    empty.  The launch takes the rows; the slices follow from them."""
    ceil = lambda a, c: -(-a // c)  # noqa: E731
    t = mlp_ref.DW_TILE
    tiles = sum(ceil(a, t) * ceil(c, t) for a, c in zip(dims, dims[1:]))
    split = max(1, min(sms // tiles, b // MLP_MIN_SLICE_ROWS))
    rows = ceil(ceil(b, split), 32) * 32
    return ceil(b, rows), rows


def mlp_backward_call(x: torch.Tensor, g: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor], mm_bf16: bool = True):
    """One fused backward on CUDA tensors with B >= 1, checked and
    allocated but not launched: returns ``(launch, bufs)``.
    ``launch(parts)`` runs the chosen kernels: ``MLP_PACK`` (the bf16
    pre-pass, into ``bufs["packed"]``), ``MLP_CHAIN`` (kernel A: ``dx`` and
    the h, dz scratch) and ``MLP_DW`` (kernel B and, with ``bufs["split"]``
    > 1 slices, the pass that sums them: ``dws``, ``dbs``).
    ``fused_mlp_backward`` launches all three; apart they time each part.
    It counts no launch."""
    dims = _mlp_dims("fused_mlp_backward", x, ws, bs)
    if g.shape != (x.shape[0], dims[-1]) or g.dtype != torch.float32:
        raise ValueError(f"fused_mlp_backward: g must be f32 {(x.shape[0], dims[-1])}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    _check_cuda("fused_mlp_backward", [x, g, *ws, *bs], x.device)
    lib, c_dims = _mlp_lib("mlp_bwd", dims, mm_bf16)
    n, b, dev = len(ws), x.shape[0], x.device
    bufs = {"dx": torch.empty_like(x), "dws": [torch.empty_like(w) for w in ws],
            "dbs": [torch.empty_like(v) for v in bs], "packed": None, "split": 1,
            "split_rows": -(-b // 32) * 32}
    if mm_bf16:
        bufs["packed"] = _packed(dims, True, dev)
        bufs["split"], bufs["split_rows"] = mlp_bwd_split(
            dims, b, torch.cuda.get_device_properties(dev).multi_processor_count)
        # the f32 chain multiplies by W_iᵀ from a transposed copy; the bf16
        # pre-pass packs W_iᵀ from W_i itself
        wts = list(ws)
    else:
        wts = [w.t().contiguous() for w in ws]
    if bufs["split"] > 1:  # kernel B's partial sums, a slice at a time
        per_slice = sum(a * c + c for a, c in zip(dims, dims[1:]))
        bufs["partial"] = torch.empty(bufs["split"] * per_slice, dtype=torch.float32,
                                      device=dev)
    # scratch: each layer's rounded input h_i and masked cotangent dz_i in
    # the matmul type, rows padded to 8 columns for 16-byte loads
    mm = torch.bfloat16 if mm_bf16 else torch.float32
    bufs["h"] = torch.empty(b * sum(_round8(d) for d in dims[:-1]), dtype=mm, device=dev)
    bufs["dz"] = torch.empty(b * sum(_round8(d) for d in dims[1:]), dtype=mm, device=dev)
    ptr = lambda k: bufs[k].data_ptr() if bufs.get(k) is not None else None  # noqa: E731

    def launch(parts: int) -> None:
        (pw, _kw), (pt, _kt), (pb, _kb) = _ptrs(ws), _ptrs(wts), _ptrs(bs)
        (pdw, _kdw), (pdb, _kdb) = _ptrs(bufs["dws"]), _ptrs(bufs["dbs"])
        with torch.cuda.device(dev):
            rc = lib.mlp_bwd_launch(
                x.data_ptr(), g.data_ptr(), ptr("dx"), pw, pt, pb, pdw, pdb, ptr("h"),
                ptr("dz"), ptr("packed"), ptr("partial"), ctypes.cast(c_dims, ctypes.c_void_p),
                n, b, int(mm_bf16), bufs["split_rows"], parts, _stream(x))
        build.check(rc, "fused_mlp_backward")

    return launch, bufs


def fused_mlp_backward(x: torch.Tensor, g: torch.Tensor, ws: Sequence[torch.Tensor],
                       bs: Sequence[torch.Tensor], mm_bf16: bool = True):
    """Backward of :func:`fused_mlp_forward` for the output cotangent ``g``
    (B, D_k) f32 -> (dx (B, D0) f32, [dW_i] f32, [db_i] f32 shaped like
    b_i).  The hidden layers are recomputed from ``x`` with the forward's
    rounding (``kernels/mlp.py::mlp_backward``)."""
    dims = _mlp_dims("fused_mlp_backward", x, ws, bs)
    if g.shape != (x.shape[0], dims[-1]) or g.dtype != torch.float32:
        raise ValueError(f"fused_mlp_backward: g must be f32 {(x.shape[0], dims[-1])}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    if x.device.type == "cpu":
        return mlp_ref.mlp_backward(x, g, ws, bs, mm_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_backward: no kernel for device {x.device}")
    if x.shape[0] == 0:
        _check_cuda("fused_mlp_backward", [x, g, *ws, *bs], x.device)
        _mlp_lib("mlp_bwd", dims, mm_bf16)
        return (torch.empty_like(x), [torch.zeros_like(w) for w in ws],
                [torch.zeros_like(v) for v in bs])
    launch, bufs = mlp_backward_call(x, g, ws, bs, mm_bf16)
    launch(MLP_PACK | MLP_CHAIN | MLP_DW)
    LAUNCHES["mlp_bwd"] += 1
    return bufs["dx"], bufs["dws"], bufs["dbs"]


def mlp_chain_clusters(dims: Sequence[int], backward: bool = False) -> tuple[int, int]:
    """(C, clusters): the CTAs of a cluster of the bf16 chain (the forward,
    or the backward's kernel A), and how many such clusters the card holds
    at once at these widths (``cudaOccupancyMaxActiveClusters``)."""
    name = "mlp_bwd" if backward else "mlp_fwd"
    lib, c_dims = _mlp_lib(name, list(dims), True)
    c = ctypes.c_int(0)
    n = getattr(lib, f"{name}_max_active_clusters")(
        ctypes.cast(c_dims, ctypes.c_void_p), len(dims) - 1, ctypes.byref(c))
    if n < 0:
        raise RuntimeError(f"{name}_max_active_clusters: CUDA error {-n}")
    return c.value, n


def _check_embedding(name, p, state, cot_sorted, ids2d, cptr, block, streams=1,
                     shard_index=0):
    """Shapes and types the update kernels take (and the plain versions
    assume)."""
    if p.dim() != 2 or p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: table must be (V, D) f32 or bf16, got {p.dtype} {tuple(p.shape)}")
    for t, shape in state:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: optimizer state must be f32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    vp, d = p.shape
    if ids2d.dim() != 2 or ids2d.dtype != torch.int32 or cptr.dtype != torch.int32:
        raise TypeError(f"{name}: ids2d (nc, ch) and cptr must be int32")
    if cot_sorted.dim() != 2 or cot_sorted.shape[1] != d or \
            cot_sorted.shape[0] < ids2d.numel() or \
            cot_sorted.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: cot_sorted must be f32 or bf16 (>= nc*ch, {d})")
    if streams < 1 or ids2d.shape[0] % streams or cptr.dim() != 1 or \
            cptr.shape[0] % streams or shard_index < 0:
        raise ValueError(f"{name}: ids2d and cptr must split into {streams} streams, "
                         f"shard_index {shard_index} >= 0")
    nb = emb_ref.num_blocks(vp, block)
    if block < 1 or cptr.shape[0] // streams < (shard_index + 1) * nb + 1:
        raise ValueError(f"{name}: cptr must hold nb + 1 = {nb + 1} entries a stream for "
                         f"block {block} (past shard {shard_index}'s window)")
    if block * d * 4 > 227 * 1024:
        raise ValueError(f"{name}: a ({block}, {d}) f32 gradient tile exceeds shared memory")


def _chunk_ints(p, ids2d, cptr, block, streams, shard_index):
    """(cptr address of the shard's first block, the kernel's nc, streams,
    cstride and row0) of one table."""
    nb = emb_ref.num_blocks(p.shape[0], block)
    return (cptr.data_ptr() + 4 * shard_index * nb,
            [ids2d.shape[0] // streams, streams, cptr.shape[0] // streams,
             shard_index * p.shape[0]])


def fused_embedding_adam(p, m, v, cot_sorted, ids2d, cptr, step: int, *,
                         block: int, lr: float, b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8, wd: float = 0.0, mm_bf16: bool = True,
                         streams: int = 1, shard_index: int = 0) -> None:
    """Fused table backward + dense Adam on the logical table ``p`` (V, D)
    f32 or bf16 and its f32 moments, IN PLACE; see
    ``kernels/embedding_update.py`` for the inputs, their ``streams`` and
    ``shard_index`` forms and the math.  ``step`` is 1-based; the bias
    corrections are computed here in f32.  The pass of one table
    (``fused_embedding_adam_pass``): one launch."""
    return fused_embedding_adam_pass([p], [m], [v], [cot_sorted], [ids2d], [cptr], step,
                                     blocks=[block], lr=lr, b1=b1, b2=b2, eps=eps, wd=wd,
                                     mm_bf16=mm_bf16, streams=streams,
                                     shard_indices=[shard_index])


EMBEDDING_ADAM_TABLES = 32  # tables a launch of fused Adam takes (csrc/embedding_update.cu)


def fused_embedding_adam_pass(ps, ms, vs, cots, ids2ds, cptrs, step: int, *, blocks,
                              lr: float, b1: float = 0.9, b2: float = 0.999,
                              eps: float = 1e-8, wd: float = 0.0,
                              mm_bf16: bool = True, streams: int = 1,
                              shard_indices=None) -> None:
    """``fused_embedding_adam`` over a list of tables in place, table t with
    its own (p, m, v, cot, ids2d, cptr), block ``blocks[t]`` and model-shard
    index ``shard_indices[t]`` (default 0), all of ``streams`` streams.  On
    the card one launch takes up to ``EMBEDDING_ADAM_TABLES`` tables of one
    D, one chunk length and one pair of types (a step's group tables); a
    table of no rows is skipped.  On the CPU the plain step runs table by
    table."""
    if shard_indices is None:
        shard_indices = [0] * len(ps)
    tables = list(zip(ps, ms, vs, cots, ids2ds, cptrs, blocks, shard_indices, strict=True))
    for p, m, v, cot, ids2d, cptr, block, si in tables:
        _check_embedding("fused_embedding_adam", p, [(m, tuple(p.shape)), (v, tuple(p.shape))],
                         cot, ids2d, cptr, block, streams, si)
    if not tables:
        return None
    device = tables[0][0].device
    if device.type == "cpu":
        for p, m, v, cot, ids2d, cptr, block, si in tables:
            emb_ref.fused_adam(p, m, v, cot, ids2d, cptr, step, block=block, lr=lr, b1=b1,
                               b2=b2, eps=eps, wd=wd, mm_bf16=mm_bf16, streams=streams,
                               shard_index=si)
        return None
    if device.type != "cuda":
        raise ValueError(f"fused_embedding_adam: no kernel for device {device}")
    for tab in tables:
        _check_cuda("fused_embedding_adam", tab[:6], device)
    tables = [tab for tab in tables if tab[0].shape[0]]
    if mm_bf16:  # the cotangent rounded to bf16, as the TPU kernel's wrapper does
        tables = [(*tab[:3], tab[3].bfloat16(), *tab[4:]) for tab in tables]
    kinds = {(p.shape[1], ids2d.shape[1], p.dtype, cot.dtype)
             for p, _, _, cot, ids2d, *_ in tables}
    if len(kinds) > 1:
        raise ValueError(f"fused_embedding_adam: one launch takes one D, chunk length and "
                         f"pair of types, got {sorted(map(str, kinds))}")
    c1, c2 = emb_ref.adam_corrections(step, b1, b2)
    lib = build.libraries()["embedding_update"]
    for at in range(0, len(tables), EMBEDDING_ADAM_TABLES):
        part = tables[at:at + EMBEDDING_ADAM_TABLES]
        addrs, ints = [], []
        for p, m, v, cot, ids2d, cptr, block, si in part:
            cp, chunk_ints = _chunk_ints(p, ids2d, cptr, block, streams, si)
            addrs += [p.data_ptr(), m.data_ptr(), v.data_ptr(), cot.data_ptr(),
                      ids2d.data_ptr(), cp]
            ints += [p.shape[0], block, *chunk_ints]
        ptrs = (ctypes.c_uint64 * len(addrs))(*addrs)
        c_ints = (ctypes.c_int * len(ints))(*ints)
        p0, cot0, ids0 = part[0][0], part[0][3], part[0][4]
        with torch.cuda.device(device):
            rc = lib.embedding_adam_launch(
                ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(c_ints, ctypes.c_void_p),
                len(part), p0.shape[1], ids0.shape[1], int(p0.dtype == torch.bfloat16),
                int(cot0.dtype == torch.bfloat16), lr, b1, b2, 1.0 - b1, 1.0 - b2, c1, c2,
                eps, wd, _stream(p0))
        build.check(rc, "fused_embedding_adam")
        LAUNCHES["embedding_adam"] += 1
    return None


def fused_embedding_rowwise_adagrad(p, acc, cot_sorted, ids2d, cptr, *, block: int,
                                    lr: float, eps: float = 1e-8, wd: float = 0.0,
                                    mm_bf16: bool = True, streams: int = 1,
                                    shard_index: int = 0) -> None:
    """Fused table backward + rowwise AdaGrad on ``p`` (V, D) and its f32
    per-row accumulator ``acc`` (V,), IN PLACE."""
    _check_embedding("fused_embedding_rowwise_adagrad", p, [(acc, (p.shape[0],))],
                     cot_sorted, ids2d, cptr, block, streams, shard_index)
    if p.device.type == "cpu":
        return emb_ref.fused_rowwise_adagrad(p, acc, cot_sorted, ids2d, cptr, block=block,
                                             lr=lr, eps=eps, wd=wd, mm_bf16=mm_bf16,
                                             streams=streams, shard_index=shard_index)
    if p.device.type != "cuda":
        raise ValueError(f"fused_embedding_rowwise_adagrad: no kernel for device {p.device}")
    _check_cuda("fused_embedding_rowwise_adagrad", [p, acc, cot_sorted, ids2d, cptr],
                p.device)
    if mm_bf16:  # the cotangent rounded to bf16, as the TPU kernel's wrapper does
        cot_sorted = cot_sorted.bfloat16()
    cp, chunk_ints = _chunk_ints(p, ids2d, cptr, block, streams, shard_index)
    lib = build.libraries()["embedding_update"]
    with torch.cuda.device(p.device):
        rc = lib.embedding_rowwise_adagrad_launch(
            p.data_ptr(), acc.data_ptr(), cot_sorted.data_ptr(), ids2d.data_ptr(), cp,
            p.shape[0], p.shape[1], block, ids2d.shape[1], *chunk_ints,
            int(p.dtype == torch.bfloat16), int(cot_sorted.dtype == torch.bfloat16), lr,
            eps, wd, _stream(p))
    build.check(rc, "fused_embedding_rowwise_adagrad")
    LAUNCHES["embedding_rowwise_adagrad"] += 1


def _check_attention(name, q, k, v, mask, extra=()) -> None:
    """Shapes the attention functions take: q (B, H, Sq, D), k and v
    (B, H, Sk, D), mask (B, Sk) or None, and ``extra`` (tensor, shape)
    pairs."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: expected q (B, H, Sq, D), k and v (B, H, Sk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if mask is not None and tuple(mask.shape) != (q.shape[0], k.shape[2]):
        raise ValueError(f"{name}: mask must be (B, Sk) = {(q.shape[0], k.shape[2])}, "
                         f"got {tuple(mask.shape)}")
    for t, shape in extra:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not all(t.is_floating_point() for t in (q, k, v, *(t for t, _ in extra))):
        raise TypeError(f"{name}: q, k and v must be floating point")


def _attention_kernel_args(name, tensors, mask, smem_bytes):
    """Checks of the CUDA path (``smem_bytes(D)`` is 0 for a head dim the
    kernel does not take); returns the kernel's int32 mask or None."""
    q = tensors[0]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the kernel computes f32 tensors only")
    d = q.shape[-1]
    if smem_bytes(d) == 0:
        raise ValueError(f"{name}: the kernel takes a head dim that is a multiple of 8 "
                         f"in [8, 128], got {d}")
    _check_cuda(name, tensors, q.device)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")
    if mask is None:
        return None
    if mask.device != q.device:
        raise ValueError(f"{name}: mask on {mask.device}, expected {q.device}")
    return mask.to(torch.int32).contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None, causal: bool = False):
    """Masked attention with online softmax: q (B, H, Sq, D), k/v (B, H, Sk,
    D), mask (B, Sk) key padding (nonzero = attend) or None -> (out in q's
    dtype, lse (B, H, Sq) f32); see ``kernels/attention.py`` for the
    semantics.  The kernel takes f32 and a head dim that is a multiple of 8
    up to 128."""
    _check_attention("flash_attention_fwd", q, k, v, mask)
    if q.device.type == "cpu":
        return attn_ref.flash_attention_fwd(q, k, v, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")
    lib = build.libraries()["flash_attention_fwd"]
    mask_i = _attention_kernel_args("flash_attention_fwd", [q, k, v], mask,
                                    lib.flash_attention_fwd_smem_bytes)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or sk == 0:  # no key to attend: the masked-row result
        return out.zero_(), lse.fill_(attn_ref.NEG_INF)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_i is None else mask_i.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b * h, h, sq, sk, d, attn_ref.softmax_scale(d), int(causal), _stream(q))
    build.check(rc, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd(q, k, v, mask, out, lse, do, causal: bool = False):
    """(dq, dk, dv) of :func:`flash_attention_fwd` for the output cotangent
    ``do``, from its residuals ``out`` and ``lse``.  delta = rowsum(do·out)
    is computed here with torch ops, as the JAX package computes it outside
    its kernels; the launch runs the dq kernel and the dk/dv kernel."""
    b, h, sq, d = q.shape
    _check_attention("flash_attention_bwd", q, k, v, mask,
                     [(out, q.shape), (do, q.shape), (lse, (b, h, sq))])
    if q.device.type == "cpu":
        return attn_ref.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    lib = build.libraries()["flash_attention_bwd"]
    mask_i = _attention_kernel_args("flash_attention_bwd", [q, k, v, out, lse, do], mask,
                                    lib.flash_attention_bwd_smem_bytes)
    sk = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = (do * out).sum(-1)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask_i is None else mask_i.data_ptr(), lse.data_ptr(), do.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, h, sq, sk,
            d, attn_ref.softmax_scale(d), int(causal), _stream(q))
    build.check(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def pooled_gather(table: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(V, D) f32 or bf16 table, (B, L) integer rows in [0, V), (B, L) mask
    (nonzero = a real position) -> (B, D) f32 masked sum; see
    ``kernels/embedding.py::pooled_gather``.  The kernel takes every D."""
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pooled_gather: table must be (V, D) f32 or bf16, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if rows.dim() != 2 or rows.shape != mask.shape or rows.is_floating_point():
        raise ValueError(f"pooled_gather: rows must be integer (B, L) and mask (B, L), got "
                         f"{rows.dtype} {tuple(rows.shape)} and {tuple(mask.shape)}")
    if table.device.type == "cpu":
        return gather_ref.pooled_gather(table, rows, mask)
    if table.device.type != "cuda":
        raise ValueError(f"pooled_gather: no kernel for device {table.device}")
    rows = rows.to(torch.int32).contiguous()
    mask = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    _check_cuda("pooled_gather", [table, rows, mask], table.device)
    b, length = rows.shape
    out = torch.empty((b, table.shape[1]), dtype=torch.float32, device=table.device)
    if b == 0:
        return out
    with torch.cuda.device(table.device):
        rc = build.libraries()["pooled_gather"].pooled_gather_launch(
            table.data_ptr(), rows.data_ptr(), mask.data_ptr(), out.data_ptr(), b, length,
            table.shape[1], int(table.dtype == torch.bfloat16), _stream(table))
    build.check(rc, "pooled_gather")
    LAUNCHES["pooled_gather"] += 1
    return out


def _chunked(x: torch.Tensor) -> torch.Tensor:
    """x (R, D) f32 with D padded by zero columns to a multiple of 4 and its
    storage 16-byte aligned, for the top-k kernel's 16-byte copies (zero
    columns leave every dot product as it is)."""
    x = x.float().contiguous()
    pad = -x.shape[1] % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.clone() if x.data_ptr() % 16 else x


def topk_plan(nq: int, n: int, d: int, k: int):
    """``topk_scores_plan``'s launch plan on the current card (threads,
    items a tile, catalog splits, items a split, shared bytes) as a ctypes
    int array, or None where the kernel does not take the shape."""
    plan = (ctypes.c_int * 5)()
    ok = build.libraries()["topk_scores"].topk_scores_plan(
        nq, n, -(-d // 4), k, ctypes.cast(plan, ctypes.c_void_p))
    return plan if ok else None


def topk_scores_fused(q: torch.Tensor, items: torch.Tensor, k: int = 10):
    """The k best items of each query by f32 dot product (split TF32 on the
    tensor cores), without the (Q, N) score matrix: q (Q, D), items (N, D)
    -> (values (Q, k) f32, indices (Q, k) int32), best first, ties to the
    lower id; see ``kernels/topk.py``.  Takes 1 <= k <= 16 and N > k, as
    the TPU kernel's callers route it, and D <= 128
    (``kernels/topk.py::in_domain``, the mirror of ``topk_scores_plan``)."""
    if q.dim() != 2 or items.dim() != 2 or q.shape[1] != items.shape[1]:
        raise ValueError(f"topk_scores_fused: expected q (Q, D) and items (N, D), got "
                         f"{tuple(q.shape)} and {tuple(items.shape)}")
    if not topk_ref.takes_k(k, items.shape[0]):
        raise ValueError(f"topk_scores_fused: the kernel takes 1 <= k <= {topk_ref.MAX_K} "
                         f"and more than k items, got k={k}, N={items.shape[0]}")
    if not topk_ref.fits_d(k, q.shape[1]):
        raise ValueError(f"topk_scores_fused: the kernel does not take D={q.shape[1]}")
    if q.device.type == "cpu":
        return topk_ref.topk_scores(q, items, k)
    if q.device.type != "cuda":
        raise ValueError(f"topk_scores_fused: no kernel for device {q.device}")
    if items.device != q.device:
        raise ValueError(f"topk_scores_fused: items on {items.device}, expected {q.device}")
    nq, n = q.shape[0], items.shape[0]
    values = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    indices = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return values, indices
    qc, ic = _chunked(q), _chunked(items)
    with torch.cuda.device(q.device):
        plan = topk_plan(nq, n, q.shape[1], k)
        if plan is None:
            raise ValueError(f"topk_scores_fused: the kernel does not take D={q.shape[1]}")
        splits = plan[2]
        parts = [torch.empty((nq, splits, k), dtype=dt, device=q.device)
                 for dt in (torch.float32, torch.int32)] if splits > 1 else [None, None]
        rc = build.libraries()["topk_scores"].topk_scores_launch(
            qc.data_ptr(), ic.data_ptr(), values.data_ptr(), indices.data_ptr(),
            *[None if t is None else t.data_ptr() for t in parts], nq, n, qc.shape[1] // 4, k,
            ctypes.cast(plan, ctypes.c_void_p), _stream(q))
    build.check(rc, "topk_scores_fused")
    LAUNCHES["topk_scores"] += 1
    return values, indices


# -- the probe kernels --------------------------------------------------------
ADAM_PASS_TABLES = 32  # tables a launch of the Adam pass takes (csrc/adam_stream.cu)


def adam_stream_pass_(ps: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor], gs: Sequence[torch.Tensor]) -> None:
    """Elementwise Adam with no bias correction and the probe's constants
    over a list of tables, in place over each p, m and v (f32, one shape a
    table), each g read; see ``kernels/probes.py``.  On the card one launch
    takes up to ``ADAM_PASS_TABLES`` tables of any counts; on the CPU the
    plain step runs table by table."""
    if not len(ps) == len(ms) == len(vs) == len(gs):
        raise ValueError(f"adam_stream_pass_: ps, ms, vs and gs must be lists of one length, "
                         f"got {len(ps)}, {len(ms)}, {len(vs)}, {len(gs)}")
    quads = list(zip(ps, ms, vs, gs))
    if any(t.dtype != torch.float32 or t.shape != q[0].shape for q in quads for t in q):
        raise ValueError("adam_stream_pass_: p, m, v and g must be f32 of one shape")
    if not quads:
        return None
    device = quads[0][0].device
    if any(t.device != device for q in quads for t in q):
        raise ValueError(f"adam_stream_pass_: every tensor must be on {device}, got "
                         f"{sorted({str(t.device) for q in quads for t in q})}")
    if device.type == "cpu":
        for q in quads:
            probe_ref.adam_stream_step_(*q)
        return None
    if device.type != "cuda":
        raise ValueError(f"adam_stream_pass_: no kernel for device {device}")
    for q in quads:
        _check_cuda("adam_stream_pass_", q, device)
    quads = [q for q in quads if q[0].numel()]
    lr, b1, b2, eps = (probe_ref.ADAM[k] for k in ("lr", "b1", "b2", "eps"))
    lib = build.libraries()["adam_stream"]
    for at in range(0, len(quads), ADAM_PASS_TABLES):
        part = quads[at:at + ADAM_PASS_TABLES]
        ptrs = (ctypes.c_uint64 * (4 * len(part)))(*(t.data_ptr() for q in part for t in q))
        counts = (ctypes.c_longlong * len(part))(*(q[0].numel() for q in part))
        with torch.cuda.device(device):
            rc = lib.adam_stream_launch(
                ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(counts, ctypes.c_void_p),
                len(part), b1, 1.0 - b1, b2, 1.0 - b2, eps, lr, _stream(part[0][0]))
        build.check(rc, "adam_stream_pass_")
        LAUNCHES["adam_stream"] += 1
    return None


def adam_stream_step_(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      g: torch.Tensor) -> None:
    """Elementwise Adam with no bias correction and the probe's constants,
    in place over p, m and v (f32, one shape), g read: the one-table pass
    (``adam_stream_pass_``)."""
    return adam_stream_pass_([p], [m], [v], [g])


PERROW_COLS = 4           # columns a block of the walk (csrc/perrow_walk.cu)
PERROW_CHUNK_ROWS = 1024  # rows a staged chunk: a multiple of the kernel's 64-row groups
PERROW_STAGES = 6         # chunks in the ring


def perrow_plan(n: int, w: int) -> dict:
    """The per-row walk's geometry for an (n, W) block: ``blocks`` of
    ``cols`` adjacent columns (one thread walks each column), a ring of
    ``stages`` chunks of ``chunk_rows`` rows in ``smem_bytes`` of shared
    memory (an 8-byte ``full`` and ``empty`` barrier a stage, then each
    stage's columns, ``pitch`` floats each: the rows rounded up to a
    multiple of 4, and 4 more).  A walk of at most ``PERROW_CHUNK_ROWS``
    rows is one chunk.  The launch takes the two choices, ``chunk_rows``
    and ``stages``; the kernel derives the grid and the bytes from them
    as here, and the rest of the plan describes that launch."""
    chunk_rows = max(1, min(PERROW_CHUNK_ROWS, n))
    stages = max(1, min(PERROW_STAGES, -(-n // chunk_rows)))
    pitch = -(-chunk_rows // 4) * 4 + 4
    return {"blocks": -(-w // PERROW_COLS), "cols": PERROW_COLS, "chunk_rows": chunk_rows,
            "stages": stages, "pitch": pitch,
            "smem_bytes": 16 * stages + 4 * stages * PERROW_COLS * pitch}


def perrow_colsum(x: torch.Tensor) -> torch.Tensor:
    """(n, W) f32 -> (1, W) f32, the column sums in serial row order; see
    ``kernels/probes.py``.  The kernel takes W up to 1024, spread over
    column slices (``perrow_plan``)."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"perrow_colsum: expected (n, W) f32, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return probe_ref.perrow_colsum(x)
    if x.device.type != "cuda":
        raise ValueError(f"perrow_colsum: no kernel for device {x.device}")
    _check_cuda("perrow_colsum", [x], x.device)
    n, w = x.shape
    if not 1 <= w <= 1024:
        raise ValueError(f"perrow_colsum: the kernel takes 1 <= W <= 1024, got W={w}")
    plan = perrow_plan(n, w)
    out = torch.empty((1, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = build.libraries()["perrow_walk"].perrow_walk_launch(
            x.data_ptr(), out.data_ptr(), n, w, plan["chunk_rows"], plan["stages"], _stream(x))
    build.check(rc, "perrow_colsum")
    LAUNCHES["perrow_walk"] += 1
    return out


def hot_gather(hot: torch.Tensor, ids: torch.Tensor, pack: int = 1) -> torch.Tensor:
    """hot (H, pack·d) f32, integer ids (any shape) -> (ids.numel(), d) f32,
    the rows of hot slot ids ``slot·pack + sub`` and a zero row for an id
    outside [0, H·pack); see ``kernels/probes.py``.  The kernel reads the
    buffer through the caches, a 16-byte piece of a row a thread over every
    SM; the buffer is on-chip by contract, so one beyond the card's opt-in
    shared memory is refused."""
    if hot.dim() != 2 or hot.dtype != torch.float32 or pack < 1 or hot.shape[1] % pack:
        raise ValueError(f"hot_gather: expected hot (H, pack*d) f32 with pack={pack}, got "
                         f"{hot.dtype} {tuple(hot.shape)}")
    if ids.is_floating_point():
        raise ValueError(f"hot_gather: ids must be integers, got {ids.dtype}")
    if hot.device.type == "cpu":
        return probe_ref.hot_gather(hot, ids, pack)
    if hot.device.type != "cuda":
        raise ValueError(f"hot_gather: no kernel for device {hot.device}")
    h, d = hot.shape[0], hot.shape[1] // pack
    ids = ids.reshape(-1)
    if ids.dtype != torch.int32:  # outside ids become the sentinel before the cast can wrap
        ids = torch.where((ids >= 0) & (ids < h * pack), ids.long(), h * pack).to(torch.int32)
    ids = ids.contiguous()
    _check_cuda("hot_gather", [hot, ids], hot.device)
    lib = build.libraries()["hot_gather"]
    with torch.cuda.device(hot.device):
        limit = lib.hot_gather_smem_limit()
    if hot.numel() * 4 > limit:
        raise ValueError(f"hot_gather: a {hot.numel() * 4}-byte hot buffer exceeds the "
                         f"{limit} bytes of shared memory a block may have")
    out = torch.empty((ids.numel(), d), dtype=torch.float32, device=hot.device)
    if ids.numel() == 0:
        return out
    with torch.cuda.device(hot.device):
        rc = lib.hot_gather_launch(hot.data_ptr(), ids.data_ptr(), out.data_ptr(), h, pack, d,
                                   ids.numel(), _stream(hot))
    build.check(rc, "hot_gather")
    LAUNCHES["hot_gather"] += 1
    return out


# -- autograd ---------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _dot_sel(f: int, self_interaction: bool, device: torch.device) -> torch.Tensor:
    """(P, F·F) f32 selection: packed slot (i, j) -> its two symmetric
    positions (2 on the diagonal), as the JAX package's ``_dot_sel_matrix``."""
    rows, cols = int_ref.tril_pairs(f, self_interaction)
    sel = torch.zeros((len(rows), f * f), dtype=torch.float32)
    slot = torch.arange(len(rows))
    sel.index_put_((slot, torch.as_tensor(rows * f + cols)), torch.ones(len(rows)),
                   accumulate=True)
    sel.index_put_((slot, torch.as_tensor(cols * f + rows)), torch.ones(len(rows)),
                   accumulate=True)
    return sel.to(device)


class DotInteraction(torch.autograd.Function):
    """The dot interaction with a gradient: the forward is the kernel (or
    the plain version on a CPU tensor), the backward is the JAX package's
    ``_dot_bwd`` in torch ops, ``dx = (g @ sel) · x`` per example."""

    @staticmethod
    def forward(ctx, x, self_interaction=False):
        ctx.save_for_backward(x)
        ctx.self_interaction = self_interaction
        return dot_interaction(x, self_interaction)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        b, f, _ = x.shape
        sel = _dot_sel(f, ctx.self_interaction, g.device).to(g.dtype)
        sym = (g @ sel).reshape(b, f, f)
        return torch.bmm(sym, x.float()).to(x.dtype), None


class FMPairwiseVector(torch.autograd.Function):
    """The FM bi-interaction with a gradient: the forward is the kernel (or
    the plain version on a CPU tensor), cast to x's dtype as the JAX
    package's ``_fm_vec_pallas``; the backward is its ``_fm_bwd`` in torch
    ops, ``dx = g[:, None, :] · (Σ_f x − x)``, cast to x's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return fm_pairwise_vector_fused(x.contiguous()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.float()
        return (g.float()[:, None, :] * (xf.sum(dim=1, keepdim=True) - xf)).to(x.dtype)


def fm_pairwise_vector(x: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B, D) in x's dtype, differentiable: the bi-interaction
    kernel on a CUDA tensor, the plain version on a CPU tensor.  The JAX
    package runs its Pallas kernel here only when asked
    (``RECSYS_TPU_PALLAS_INTERACTIONS``); the port always takes its kernel,
    as it does for the dot interaction (ROADMAP Queue 3)."""
    return FMPairwiseVector.apply(x)


def fm_pairwise(x: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B,): the FM second-order term, the bi-interaction
    summed over D."""
    return fm_pairwise_vector(x).sum(dim=-1)


class FusedMLPFunction(torch.autograd.Function):
    """The fused MLP with a gradient: forward ``fused_mlp_forward``,
    backward ``fused_mlp_backward``.  Called as
    ``FusedMLPFunction.apply(x, mm_bf16, *ws, *bs)``."""

    @staticmethod
    def forward(ctx, x, mm_bf16, *params):
        n = len(params) // 2
        ctx.save_for_backward(x, *params)
        ctx.mm_bf16 = mm_bf16
        return fused_mlp_forward(x, params[:n], params[n:], mm_bf16)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        n = len(params) // 2
        dx, dws, dbs = fused_mlp_backward(x, g.contiguous(), params[:n], params[n:],
                                          ctx.mm_bf16)
        return (dx, None, *dws, *dbs)


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is ``flash_attention_fwd``,
    which keeps its output and lse, and the backward ``flash_attention_bwd``
    (kernels on a CUDA tensor, plain versions on a CPU tensor).  Called as
    ``FlashAttention.apply(q, k, v, mask, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None, None


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor | None = None, causal: bool = False) -> torch.Tensor:
    """Fused attention over (B, H, S, D) with a (B, Sk) key-padding mask
    (nonzero = attend) or None, the counterpart of the JAX package's
    ``kernels/dispatch.py::sdpa``.  A CUDA tensor takes the flash kernels at
    every length: the JAX package's switch to its materialised softmax below
    Sq·Sk = 512² was measured on a TPU (ROADMAP Queue 3).  The kernels take
    the head dims of ``kernels/attention.py::flash_in_domain``;
    ``ops/attention.py::attention`` routes the others.  The semantics are
    the flash kernel's: a query row with no key to attend gives 0."""
    return FlashAttention.apply(q, k, v, mask, causal)


class SegmentSumGather(torch.autograd.Function):
    """The pooled lookup with a gradient to the table: the forward is the
    pooled-gather kernel's masked sum (its plain version on a CPU tensor)
    with the ``mean`` or ``sqrtn`` scaling applied after it; the backward is
    the JAX package's ``_ssg_bwd`` in torch ops, each position's cotangent
    weighted by its mask (and the scaling) and scatter-added into a zero
    (V, D) table gradient.  Masked positions add 0, so the pad row's
    gradient stays 0.  Called as ``SegmentSumGather.apply(table, rows, mask,
    mode)``."""

    @staticmethod
    def forward(ctx, table, rows, mask, mode):
        summed = pooled_gather(table, rows, mask)
        ctx.save_for_backward(rows, mask)
        ctx.mode, ctx.table_shape, ctx.table_dtype = mode, table.shape, table.dtype
        return gather_ref.pool_scale(summed, mask, mode)

    @staticmethod
    def backward(ctx, g):
        rows, mask = ctx.saved_tensors
        w = gather_ref.pool_scale((mask != 0).to(g.dtype), mask, ctx.mode)  # (B, L)
        d = ctx.table_shape[1]
        per_row = (g[:, None, :] * w[..., None]).reshape(-1, d)
        dtable = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        dtable.index_add_(0, rows.reshape(-1).long(), per_row)
        return dtable.to(ctx.table_dtype), None, None, None


def segment_sum_gather(table: torch.Tensor, rows: torch.Tensor, mask: torch.Tensor,
                       mode: str = "mean") -> torch.Tensor:
    """Pooled embedding of padded sequences (the counterpart of the JAX
    package's ``kernels/dispatch.py::segment_sum_gather``): table (V, D),
    rows (B, L), mask (B, L) -> (B, D) with ``mode`` in sum, mean, sqrtn.
    A CUDA tensor takes the pooled-gather kernel at every D: the JAX rule
    ``D % 128 == 0`` fits the TPU's 128 lanes, not the card (ROADMAP Queue
    3)."""
    gather_ref.check_mode(mode)
    return SegmentSumGather.apply(table, rows, mask, mode)

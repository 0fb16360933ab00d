"""Kernel wrappers: a CUDA tensor launches the hand-written kernel or raises;
a CPU tensor takes the plain PyTorch version.  There is no fallback from a
failed launch to the plain path.

``LAUNCHES`` counts, per kernel, the launches each wrapper made (plain
integers, incremented only where a kernel is launched), so a run can show
that its main path went through the kernels.

``DotInteraction`` and ``FusedMLPFunction`` are the autograd functions the
model layers call: their forwards are the forward kernels; the dot
interaction's backward is torch ops (the JAX package leaves it to XLA), the
fused MLP's backward is the ``mlp_bwd`` kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from recsys_tpu_torch.kernels import build
from recsys_tpu_torch.kernels import embedding_update as emb_ref
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.kernels import mlp as mlp_ref

LAUNCHES = {"dot_interaction": 0, "mlp_fwd": 0, "mlp_bwd": 0,
            "embedding_adam": 0, "embedding_rowwise_adagrad": 0}


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


def fused_mlp_forward(x: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor], mm_bf16: bool = True) -> torch.Tensor:
    """x (B, D0) f32; ws [(D_{i-1}, D_i)] f32; bs [(D_i,) or (1, D_i)] f32
    -> (B, D_k) f32.  Relu hidden layers, linear last layer; matmuls in
    bf16 with f32 accumulation when ``mm_bf16``, else exact f32."""
    dims = _mlp_dims("fused_mlp_forward", x, ws, bs)
    tensors = [x, *ws, *bs]
    if x.device.type == "cpu":
        return mlp_ref.mlp_forward(x, ws, bs, mm_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_forward: no kernel for device {x.device}")
    _check_cuda("fused_mlp_forward", tensors, x.device)
    lib = build.libraries()["mlp_fwd"]
    n = len(ws)
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    if lib.mlp_fwd_smem_bytes(ctypes.cast(c_dims, ctypes.c_void_p), n,
                              int(mm_bf16)) == 0:
        raise ValueError(f"fused_mlp_forward: kernel does not take widths {dims}")
    out = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    if x.shape[0] == 0:
        return out
    c_ws = (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws])
    c_bs = (ctypes.c_void_p * n)(*[b.data_ptr() for b in bs])
    with torch.cuda.device(x.device):
        rc = lib.mlp_fwd_launch(
            x.data_ptr(), out.data_ptr(), ctypes.cast(c_ws, ctypes.c_void_p),
            ctypes.cast(c_bs, ctypes.c_void_p), ctypes.cast(c_dims, ctypes.c_void_p),
            n, x.shape[0], int(mm_bf16), _stream(x),
        )
    build.check(rc, "fused_mlp_forward")
    LAUNCHES["mlp_fwd"] += 1
    return out


def _ptrs(ts):
    """A host array of device pointers, and the ctypes array to keep alive."""
    arr = (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


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
    _check_cuda("fused_mlp_backward", [x, g, *ws, *bs], x.device)
    lib = build.libraries()["mlp_bwd"]
    n, b = len(ws), x.shape[0]
    c_dims = (ctypes.c_int * (n + 1))(*dims)
    if lib.mlp_bwd_smem_bytes(ctypes.cast(c_dims, ctypes.c_void_p), n, int(mm_bf16)) == 0:
        raise ValueError(f"fused_mlp_backward: kernel does not take widths {dims}")
    dx = torch.empty_like(x)
    dws = [torch.empty_like(w) for w in ws]
    dbs = [torch.empty_like(v) for v in bs]
    if b == 0:
        return dx, [t.zero_() for t in dws], [t.zero_() for t in dbs]
    # the backward chain multiplies by W_iᵀ, staged like the forward's W_i
    wts = [w.t().contiguous() for w in ws]
    # scratch: each layer's rounded input h_i and masked cotangent dz_i in
    # the matmul type, rows padded to 8 columns for 16-byte loads
    mm = torch.bfloat16 if mm_bf16 else torch.float32
    h = torch.empty(b * sum(_round8(d) for d in dims[:-1]), dtype=mm, device=x.device)
    dz = torch.empty(b * sum(_round8(d) for d in dims[1:]), dtype=mm, device=x.device)
    (pw, _kw), (pt, _kt), (pb, _kb) = _ptrs(ws), _ptrs(wts), _ptrs(bs)
    (pdw, _kdw), (pdb, _kdb) = _ptrs(dws), _ptrs(dbs)
    with torch.cuda.device(x.device):
        rc = lib.mlp_bwd_launch(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), pw, pt, pb, pdw, pdb,
            h.data_ptr(), dz.data_ptr(), ctypes.cast(c_dims, ctypes.c_void_p),
            n, b, int(mm_bf16), _stream(x),
        )
    build.check(rc, "fused_mlp_backward")
    LAUNCHES["mlp_bwd"] += 1
    return dx, dws, dbs


def _check_embedding(name, p, state, cot_sorted, ids2d, cptr, block):
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
    if block < 1 or cptr.shape != (emb_ref.num_blocks(vp, block) + 1,):
        raise ValueError(f"{name}: cptr must hold nb + 1 = "
                         f"{emb_ref.num_blocks(vp, block) + 1} entries for block {block}")
    if block * d * 4 > 227 * 1024:
        raise ValueError(f"{name}: a ({block}, {d}) f32 gradient tile exceeds shared memory")


def _embedding_args(p, cot_sorted, ids2d, block, mm_bf16):
    """The common launch arguments; the cotangent is rounded to bf16 here
    when ``mm_bf16``, as the TPU kernel's wrapper does."""
    if mm_bf16:
        cot_sorted = cot_sorted.bfloat16()
    nc, ch = ids2d.shape
    return cot_sorted, [cot_sorted.data_ptr(), ids2d.data_ptr()], [
        p.shape[0], p.shape[1], block, ch, nc, int(p.dtype == torch.bfloat16),
        int(cot_sorted.dtype == torch.bfloat16)]


def fused_embedding_adam(p, m, v, cot_sorted, ids2d, cptr, step: int, *,
                         block: int, lr: float, b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8, wd: float = 0.0, mm_bf16: bool = True) -> None:
    """Fused table backward + dense Adam on the logical table ``p`` (V, D)
    f32 or bf16 and its f32 moments, IN PLACE; see
    ``kernels/embedding_update.py`` for the inputs and the math.  ``step``
    is 1-based; the bias corrections are computed here in f32."""
    _check_embedding("fused_embedding_adam", p, [(m, tuple(p.shape)), (v, tuple(p.shape))],
                     cot_sorted, ids2d, cptr, block)
    if p.device.type == "cpu":
        return emb_ref.fused_adam(p, m, v, cot_sorted, ids2d, cptr, step, block=block,
                                  lr=lr, b1=b1, b2=b2, eps=eps, wd=wd, mm_bf16=mm_bf16)
    if p.device.type != "cuda":
        raise ValueError(f"fused_embedding_adam: no kernel for device {p.device}")
    _check_cuda("fused_embedding_adam", [p, m, v, cot_sorted, ids2d, cptr], p.device)
    c1, c2 = emb_ref.adam_corrections(step, b1, b2)
    cot, ptrs, ints = _embedding_args(p, cot_sorted, ids2d, block, mm_bf16)
    lib = build.libraries()["embedding_update"]
    with torch.cuda.device(p.device):
        rc = lib.embedding_adam_launch(
            p.data_ptr(), m.data_ptr(), v.data_ptr(), *ptrs, cptr.data_ptr(), *ints,
            lr, b1, b2, 1.0 - b1, 1.0 - b2, c1, c2, eps, wd, _stream(p))
    build.check(rc, "fused_embedding_adam")
    LAUNCHES["embedding_adam"] += 1


def fused_embedding_rowwise_adagrad(p, acc, cot_sorted, ids2d, cptr, *, block: int,
                                    lr: float, eps: float = 1e-8, wd: float = 0.0,
                                    mm_bf16: bool = True) -> None:
    """Fused table backward + rowwise AdaGrad on ``p`` (V, D) and its f32
    per-row accumulator ``acc`` (V,), IN PLACE."""
    _check_embedding("fused_embedding_rowwise_adagrad", p, [(acc, (p.shape[0],))],
                     cot_sorted, ids2d, cptr, block)
    if p.device.type == "cpu":
        return emb_ref.fused_rowwise_adagrad(p, acc, cot_sorted, ids2d, cptr, block=block,
                                             lr=lr, eps=eps, wd=wd, mm_bf16=mm_bf16)
    if p.device.type != "cuda":
        raise ValueError(f"fused_embedding_rowwise_adagrad: no kernel for device {p.device}")
    _check_cuda("fused_embedding_rowwise_adagrad", [p, acc, cot_sorted, ids2d, cptr],
                p.device)
    cot, ptrs, ints = _embedding_args(p, cot_sorted, ids2d, block, mm_bf16)
    lib = build.libraries()["embedding_update"]
    with torch.cuda.device(p.device):
        rc = lib.embedding_rowwise_adagrad_launch(
            p.data_ptr(), acc.data_ptr(), *ptrs, cptr.data_ptr(), *ints, lr, eps, wd,
            _stream(p))
    build.check(rc, "fused_embedding_rowwise_adagrad")
    LAUNCHES["embedding_rowwise_adagrad"] += 1


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

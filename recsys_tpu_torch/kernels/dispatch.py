"""Kernel wrappers: a CUDA tensor launches the hand-written kernel or raises;
a CPU tensor takes the plain PyTorch version.  There is no fallback from a
failed launch to the plain path.

``LAUNCHES`` counts, per kernel, the launches each wrapper made (plain
integers, incremented only where a kernel is launched), so a run can show
that its main path went through the kernels.

The kernels are forward only: serving runs under ``torch.inference_mode``.
A CUDA call that would need a gradient raises until the backward kernels
exist.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from recsys_tpu_torch.kernels import build
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.kernels import mlp as mlp_ref

LAUNCHES = {"dot_interaction": 0, "mlp_fwd": 0}


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; run under "
            "torch.inference_mode() or torch.no_grad()"
        )


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


def fused_mlp_forward(x: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor], mm_bf16: bool = True) -> torch.Tensor:
    """x (B, D0) f32; ws [(D_{i-1}, D_i)] f32; bs [(D_i,) or (1, D_i)] f32
    -> (B, D_k) f32.  Relu hidden layers, linear last layer; matmuls in
    bf16 with f32 accumulation when ``mm_bf16``, else exact f32."""
    if x.dim() != 2 or len(ws) != len(bs) or not ws:
        raise ValueError("fused_mlp_forward: expected x (B, D0) and one bias per weight")
    dims = [x.shape[1]]
    for w, b in zip(ws, bs):
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.numel() != w.shape[1]:
            raise ValueError(
                f"fused_mlp_forward: layer shapes {tuple(w.shape)}, "
                f"{tuple(b.shape)} do not chain from width {dims[-1]}"
            )
        dims.append(w.shape[1])
    tensors = [x, *ws, *bs]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_mlp_forward: x, weights and biases must be f32")
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

"""Build the CUDA kernels at first use and load them through ctypes.

Every ``csrc/*.cu`` is compiled on its own by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
All sources compile in parallel.  Libraries go to ``build/recsys_tpu_torch/``
at the root of the checkout, named by a hash of their source, so an edited
source (or a shared ``csrc/*.cuh`` header) is rebuilt and an unchanged one
is reused.  Pointers and the stream
go in as ``c_void_p``; every launch function returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "recsys_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each library's entry points: name -> (restype, argtypes)
SIGNATURES = {
    "dot_interaction": {
        "dot_interaction_tile": (_I, [_I, _I, _I]),
        "dot_interaction_launch": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
        "dot_interaction_floor": (_I, [_I, _I, _I, _I, _P]),
    },
    "fm_interaction": {
        "fm_pairwise_vector_launch": (_I, [_P, _P, _I, _I, _I, _I, _P]),
    },
    "mlp_fwd": {
        "mlp_fwd_smem_bytes": (ctypes.c_longlong, [_P, _I, _I]),
        "mlp_fwd_max_active_clusters": (_I, [_P, _I, _P]),
        "mlp_fwd_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    },
    "mlp_bwd": {
        "mlp_bwd_smem_bytes": (ctypes.c_longlong, [_P, _I, _I]),
        "mlp_bwd_max_active_clusters": (_I, [_P, _I, _P]),
        "mlp_bwd_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _P]),
    },
    "embedding_update": {
        "embedding_adam_launch": (_I, [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                                       _F, _F, _F, _F, _P]),
        "embedding_rowwise_adagrad_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                                  _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                                  _P]),
    },
    "flash_attention_fwd": {
        "flash_attention_fwd_smem_bytes": (ctypes.c_longlong, [_I]),
        "flash_attention_fwd_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                            _F, _I, _P]),
    },
    "pooled_gather": {
        "pooled_gather_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "pooled_gather_floor": (_I, [_I, _I, _P]),
    },
    "topk_scores": {
        "topk_scores_plan": (_I, [_I, _I, _I, _I, _P]),
        "topk_scores_launch": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
        "topk_scores_floor": (_I, [_I, _P, _P]),
    },
    "adam_stream": {
        "adam_stream_launch": (_I, [_P, _P, _I, _F, _F, _F, _F, _F, _F, _P]),
    },
    "perrow_walk": {
        "perrow_walk_launch": (_I, [_P, _P, _I, _I, _I, _I, _P]),
        "perrow_add_chain_cycles": (_I, [_P, _P, _P, _I, _P]),
    },
    "hot_gather": {
        "hot_gather_smem_limit": (_I, []),
        "hot_gather_grid": (_I, [_I, _I, _I]),
        "hot_gather_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
        "hot_gather_floor": (_I, [_I, _P]),
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_smem_bytes": (ctypes.c_longlong, [_I]),
        "flash_attention_bwd_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                            _I, _I, _I, _I, _F, _I, _P]),
    },
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    {name: library path}.  Raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    libs = {s.stem: _target(s) for s in srcs}
    procs = []
    for src in srcs:
        out = libs[src.stem]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return libs


@functools.cache
def libraries() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library, with typed entry
    points.  Cached: the first call pays the build."""
    loaded = {}
    for name, path in build_all().items():
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        loaded[name] = lib
    return loaded


def check(rc: int, what: str) -> None:
    """Raise when a launch function reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")

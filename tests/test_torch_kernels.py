"""Port kernels (recsys_tpu_torch.kernels) against the JAX package's Pallas
kernels in interpret mode, and the wrappers' routing and input checks.  The
CUDA kernels themselves are held against their plain versions on the card
in tests/test_torch_cuda.py.

Inputs come from numpy with a seed; JAX stays on the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.kernels import dispatch as jax_dispatch
from recsys_tpu.kernels.pallas.mlp_tpu import mlp_fwd_pallas
from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels.interactions import dot_interaction
from recsys_tpu_torch.kernels.mlp import mlp_forward

REPO = Path(__file__).resolve().parents[1]


def _bf16_np(a):
    """f32 numpy -> the same values rounded to bf16, as f32 numpy."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _mlp_params(dims, seed):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(rng.standard_normal((1, b)) * 0.1).astype(np.float32) for b in dims[1:]]
    return ws, bs


# -- parity with the JAX package (CPU) --------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_dot_interaction_matches_pallas_interpret(dtype, self_interaction):
    x = np.random.default_rng(0).normal(size=(10, 11, 8)).astype(np.float32)
    if dtype == "bf16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jax_dispatch.dot_interaction(
        jx, self_interaction=self_interaction, interpret=True))
    got = dot_interaction(tx, self_interaction).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    # both accumulate exact (bf16) products in f32; only the order differs
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mm_bf16", [False, True])
def test_mlp_forward_matches_pallas_interpret(mm_bf16):
    dims = [13, 48, 32, 8, 1]
    ws, bs = _mlp_params(dims, seed=1)
    x = np.random.default_rng(2).standard_normal((40, dims[0])).astype(np.float32)
    want = np.asarray(mlp_fwd_pallas(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
        tile_b=16, mm_bf16=mm_bf16, interpret=True))
    got = mlp_forward(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                      [torch.from_numpy(b) for b in bs], mm_bf16).numpy()
    if mm_bf16:
        # same roundings at the same places; an f32 sum in another order
        # can still round a hidden value to the neighbouring bf16 (2^-8
        # relative), which moves the output by a few bf16 ulps at most
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        # every output is a bf16 value, as the TPU kernel's last rounding
        np.testing.assert_array_equal(got, _bf16_np(got))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- routing and input checks -----------------------------------------------
def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    dispatch.reset_launches()
    x = torch.randn(4, 5, 8)
    torch.testing.assert_close(dispatch.dot_interaction(x), dot_interaction(x))
    ws, bs = _mlp_params([8, 16, 1], seed=3)
    tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    xm = torch.randn(6, 8)
    torch.testing.assert_close(dispatch.fused_mlp_forward(xm, tw, tb),
                               mlp_forward(xm, tw, tb))
    assert set(dispatch.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad, err", [
    (lambda: dispatch.dot_interaction(torch.randn(4, 5)), ValueError),
    (lambda: dispatch.dot_interaction(torch.randn(2, 3, 4).double()), TypeError),
    (lambda: dispatch.fused_mlp_forward(torch.randn(3, 4), [torch.randn(5, 2)],
                                        [torch.zeros(2)]), ValueError),
    (lambda: dispatch.fused_mlp_forward(torch.randn(3, 4).double(),
                                        [torch.randn(4, 2).double()],
                                        [torch.zeros(2).double()]), TypeError),
])
def test_wrappers_refuse_bad_inputs(bad, err):
    with pytest.raises(err):
        bad()


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


# -- the port stands alone ---------------------------------------------------
def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, recsys_tpu_torch.train.loop, recsys_tpu_torch.models.ctr.dlrm, "
            "recsys_tpu_torch.convert, recsys_tpu_torch.train.losses, "
            "recsys_tpu_torch.train.streaming_embed, recsys_tpu_torch.train.sparse_embed, "
            "recsys_tpu_torch.kernels.embedding_update, mlp_bwd_check; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'recsys_tpu')]; print(bad); sys.exit(bool(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_module():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|recsys_tpu)(\.|\s|$)", re.M)
    files = [*sorted((REPO / "recsys_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py",
             REPO / "mlp_bwd_check.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


def test_every_kernel_source_has_a_bound_c_interface(monkeypatch, tmp_path):
    from recsys_tpu_torch.kernels import build

    stems = {p.stem for p in build.CSRC.glob("*.cu")}
    assert stems == set(build.SIGNATURES)
    # one launch count per kernel entry point
    launchers = {fn.removesuffix("_launch") for sig in build.SIGNATURES.values()
                 for fn in sig if fn.endswith("_launch")}
    assert launchers == set(dispatch.LAUNCHES)
    # the library name follows the source's content, so an edit rebuilds
    src = tmp_path / "k.cu"
    src.write_text("a")
    first = build._target(src)
    src.write_text("b")
    assert build._target(src) != first and first.name.startswith("k-")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()

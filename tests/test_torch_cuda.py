"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the same inputs, and a small DLRM served on the card against the
same model on the CPU.  They skip inside a fixture when there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels.interactions import dot_interaction
from recsys_tpu_torch.kernels.mlp import mlp_forward
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.train.loop import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mlp_params(dims, seed, dev):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)).to(dev)
          for a, b in zip(dims, dims[1:])]
    bs = [torch.from_numpy((rng.standard_normal((1, b)) * 0.1).astype(np.float32)).to(dev)
          for b in dims[1:]]
    return ws, bs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("b, f, d", [(4096, 27, 16), (1000, 27, 16), (7, 64, 8), (33, 5, 33)])
def test_dot_interaction_kernel_matches_plain(cuda, dtype, self_interaction, b, f, d):
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(b, f, d)).astype(np.float32)).to(cuda, dtype)
    before = dispatch.LAUNCHES["dot_interaction"]
    got = dispatch.dot_interaction(x, self_interaction)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["dot_interaction"] == before + 1
    # both sum d exact products in f32, in another order
    torch.testing.assert_close(got, dot_interaction(x, self_interaction),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dims", [[13, 512, 256, 16, 16], [367, 1024, 1024, 512, 256, 1],
                                  [5, 7, 3]])
@pytest.mark.parametrize("b", [4096, 1000, 1])
def test_mlp_fwd_kernel_matches_plain(cuda, mm_bf16, dims, b):
    tw, tb = _mlp_params(dims, 5, cuda)
    x = torch.from_numpy(np.random.default_rng(6).random((b, dims[0]), np.float32)).to(cuda)
    before = dispatch.LAUNCHES["mlp_fwd"]
    got = dispatch.fused_mlp_forward(x, tw, tb, mm_bf16)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["mlp_fwd"] == before + 1
    want = mlp_forward(x, tw, tb, mm_bf16)
    if mm_bf16:
        # an f32 sum in another order may round a hidden value to the
        # neighbouring bf16 (2^-8 relative): a few bf16 ulps at the output
        torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
        assert torch.equal(got, got.bfloat16().float())  # the last rounding
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_kernels_refuse_what_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.dot_interaction(torch.randn(4, 16, 5, device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="widths"):
        w = torch.randn(8, 4096, device=cuda)
        dispatch.fused_mlp_forward(torch.randn(2, 8, device=cuda), [w],
                                   [torch.zeros(4096, device=cuda)])
    with pytest.raises(NotImplementedError, match="forward only"):
        dispatch.dot_interaction(torch.randn(2, 3, 4, device=cuda, requires_grad=True))


@pytest.mark.parametrize("fused", [False, True])
def test_dlrm_predict_on_card_matches_cpu(cuda, fused):
    schema, data = synthetic_ctr(num_examples=1000, num_dense=13, num_sparse=26,
                                 vocab_size=500, embed_dim=16, seed=1)
    torch.manual_seed(0)
    model = DLRM(schema, bottom_units=(64, 16), top_units=(128, 64),
                 compute_dtype=torch.bfloat16, fused_mlps=fused,
                 dense_microbatch=4, device="cpu")
    want = Trainer(model, device="cpu").predict(data, batch_size=256)
    dispatch.reset_launches()
    got = Trainer(model).predict(data, batch_size=256)
    assert dispatch.LAUNCHES == {"dot_interaction": 16, "mlp_fwd": 32 if fused else 0}
    assert got.shape == (1000,) and np.isfinite(got).all()
    # bf16 towers: a sum in another order can flip a bf16 rounding
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)

"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the same inputs, a small DLRM served on the card against the
same model on the CPU, and one training step on the card against the same
step on the CPU.  They skip inside a fixture when there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

import mlp_bwd_check
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels import embedding_update as emb_ref
from recsys_tpu_torch.kernels.interactions import dot_interaction
from recsys_tpu_torch.kernels.mlp import mlp_backward, mlp_forward
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.train.loop import Trainer
from recsys_tpu_torch.train.streaming_embed import host_prep_group

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
    # the kernels take tensors that require grad: the gradient through the
    # kernel's DotInteraction equals the plain version's autograd gradient
    x = torch.randn(64, 27, 16, device=cuda, requires_grad=True)
    w = torch.randn(64, 351, device=cuda)
    (dispatch.DotInteraction.apply(x, False) * w).sum().backward()
    xp = x.detach().clone().requires_grad_()
    (dot_interaction(xp, False) * w).sum().backward()
    torch.testing.assert_close(x.grad, xp.grad, rtol=1e-4, atol=1e-4)


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
    assert dispatch.LAUNCHES == {"dot_interaction": 16, "mlp_fwd": 32 if fused else 0,
                                 "mlp_bwd": 0, "embedding_adam": 0,
                                 "embedding_rowwise_adagrad": 0}
    assert got.shape == (1000,) and np.isfinite(got).all()
    # bf16 towers: a sum in another order can flip a bf16 rounding
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dims", [[13, 512, 256, 16, 16], [367, 1024, 1024, 512, 256, 1],
                                  [5, 7, 3], [9, 4]])
@pytest.mark.parametrize("b", [4096, 1000, 1])
def test_mlp_bwd_kernel_matches_plain(cuda, mm_bf16, dims, b):
    tw, tb = _mlp_params(dims, 7, cuda)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((b, dims[0]), np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((b, dims[-1]), np.float32)).to(cuda)
    # rows at a relu kink may differ by O(1) between two correct sums
    keep = mlp_bwd_check.kink_free_rows(x, tw, tb)
    assert keep.float().mean() > 0.8
    x, g = x[keep].contiguous(), g[keep].contiguous()
    before = dispatch.LAUNCHES["mlp_bwd"]
    got = dispatch.fused_mlp_backward(x, g, tw, tb, mm_bf16)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["mlp_bwd"] == before + 1
    want = mlp_backward(x, g, tw, tb, mm_bf16)
    # dx: a sum in another order (and the tensor cores' accumulation) can
    # round a hidden value or a cotangent to the neighbouring bf16; f32:
    # sums in another order.  dW and db: a share of their terms (f32) or
    # their norm (bf16); mlp_bwd_check explains the limits
    tol = dict(rtol=3e-2, atol=3e-2) if mm_bf16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[0], want[0], **tol)
    sw, sb = mlp_bwd_check.term_scales(x, g, tw, tb)
    for u, v, sc in zip(got[1] + got[2], want[1] + want[2], sw + sb):
        if mm_bf16:
            assert mlp_bwd_check.norm_err(u, v) <= mlp_bwd_check.BF16_NORM_RTOL
        else:
            assert mlp_bwd_check.f32_outside(u, v, sc) == 0.0
    assert [t.shape for t in got[2]] == [t.shape for t in tb]


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dims", [[13, 512, 256, 16, 16], [367, 1024, 1024, 512, 256, 1],
                                  [5, 7, 3]])
@pytest.mark.parametrize("b", [4096, 1000, 1])
def test_mlp_bwd_kernel_bit_equal_on_integer_values(cuda, mm_bf16, dims, b):
    # every sum exact in f32, every bf16 rounding of the same value
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    x, g, ws, bs = mlp_bwd_check.exact_case(np.random.default_rng(9), b, dims)
    x, g, ws, bs = to(x), to(g), [to(w) for w in ws], [to(v) for v in bs]
    assert mlp_bwd_check.largest_term_sum(x, g, ws, bs) < mlp_bwd_check.EXACT_LIMIT
    got = dispatch.fused_mlp_backward(x, g, ws, bs, mm_bf16)
    want = mlp_backward(x, g, ws, bs, mm_bf16)
    for u, v in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        assert torch.equal(u, v)


def _embedding_case(cuda, v, d, n, block, *, hot=False, seed=0, cot_scale=1e-2):
    rng = np.random.default_rng(seed)
    ids = (rng.integers(0, 3, n) * 7 if hot else rng.integers(0, v, n)).astype(np.int32)
    ids2d, idx, cptr = host_prep_group(ids, vp=v, block=block, ch=64)
    cot = (rng.standard_normal((n, d)) * cot_scale).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    return (to(cot[idx]), to(ids2d), to(cptr),
            rng.uniform(-0.05, 0.05, (v, d)).astype(np.float32),
            (rng.standard_normal((v, d)) * 1e-3).astype(np.float32),
            rng.uniform(1e-8, 1e-4, (v, d)).astype(np.float32), to)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("v, d, n, block, wd", [(100_000, 16, 16384, 512, 0.0),
                                                (1000, 16, 700, 96, 0.01),
                                                (37, 8, 300, 16, 0.0)])
def test_embedding_adam_kernel_matches_plain(cuda, p_dtype, mm_bf16, v, d, n, block, wd):
    cot, ids2d, cptr, p, m, vv, to = _embedding_case(cuda, v, d, n, block)
    state = [to(p).to(p_dtype), to(m), to(vv)]
    plain = [t.clone() for t in state]
    before = dispatch.LAUNCHES["embedding_adam"]
    dispatch.fused_embedding_adam(*state, cot, ids2d, cptr, 3, block=block, lr=1e-3,
                                  wd=wd, mm_bf16=mm_bf16)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["embedding_adam"] == before + 1
    emb_ref.fused_adam(*plain, cot, ids2d, cptr, 3, block=block, lr=1e-3, wd=wd,
                       mm_bf16=mm_bf16)
    # sums of the same values in another order (atomics): the tolerances
    # of tests/test_streaming_embed.py; a bf16 table is one bf16 rounding
    # of the f32 update, which the order can move by one ulp
    for name, got, want in zip("pmv", state, plain):
        tol = dict(rtol=8e-3, atol=1e-6) if got.dtype == torch.bfloat16 else \
            dict(rtol=2e-4, atol=1e-7)
        torch.testing.assert_close(got.float(), want.float(), **tol, msg=name)


def test_embedding_adam_kernel_hot_ids_first_step(cuda):
    cot, ids2d, cptr, p, _, _, to = _embedding_case(cuda, 300, 16, 4096, 8, hot=True,
                                                    cot_scale=1.0)
    state = [to(p), torch.zeros((300, 16), device=cuda), torch.zeros((300, 16), device=cuda)]
    plain = [t.clone() for t in state]
    dispatch.fused_embedding_adam(*state, cot, ids2d, cptr, 1, block=8, lr=1e-3, wd=0.01)
    emb_ref.fused_adam(*plain, cot, ids2d, cptr, 1, block=8, lr=1e-3, wd=0.01)
    torch.cuda.synchronize()
    # first-step Adam is sign(g)-like: 4096 duplicates summed in another
    # order can flip a sum near zero, so m and v tightly, p by share
    torch.testing.assert_close(state[1], plain[1], rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(state[2], plain[2], rtol=1e-4, atol=1e-9)
    assert ((state[0] - plain[0]).abs() > 1e-5).float().mean() < 1e-3


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("v, d, n, block, wd", [(100_000, 16, 16384, 512, 0.0),
                                                (1000, 16, 700, 96, 0.01)])
def test_embedding_rowwise_adagrad_kernel_matches_plain(cuda, p_dtype, mm_bf16, v, d, n,
                                                        block, wd):
    cot, ids2d, cptr, p, _, _, to = _embedding_case(cuda, v, d, n, block, seed=1)
    acc = np.random.default_rng(2).uniform(0, 1e-4, v).astype(np.float32)
    state = [to(p).to(p_dtype), to(acc)]
    plain = [t.clone() for t in state]
    before = dispatch.LAUNCHES["embedding_rowwise_adagrad"]
    dispatch.fused_embedding_rowwise_adagrad(*state, cot, ids2d, cptr, block=block,
                                             lr=1e-3, wd=wd, mm_bf16=mm_bf16)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["embedding_rowwise_adagrad"] == before + 1
    emb_ref.fused_rowwise_adagrad(*plain, cot, ids2d, cptr, block=block, lr=1e-3, wd=wd,
                                  mm_bf16=mm_bf16)
    # as tests/test_streaming_embed.py::test_fused_rowwise_adagrad_matches_sparse_path
    torch.testing.assert_close(state[1], plain[1], rtol=1e-4, atol=1e-9)
    tol = dict(rtol=8e-3, atol=1e-6) if p_dtype == torch.bfloat16 else \
        dict(rtol=1e-3, atol=2e-7)
    torch.testing.assert_close(state[0].float(), plain[0].float(), **tol)


@pytest.mark.parametrize("opt", ["fused_adam", "fused_rowwise_adagrad"])
def test_train_step_on_card_matches_cpu(cuda, opt):
    schema, data = synthetic_ctr(num_examples=512, num_dense=13, num_sparse=26,
                                 vocab_size=500, embed_dim=16, seed=2)
    torch.manual_seed(0)
    model = DLRM(schema, bottom_units=(64, 16), top_units=(128, 64), fused_mlps=True,
                 dense_microbatch=4, sparse_embed_grads=True, device="cpu")
    kw = dict(learning_rate=1e-3, embedding_optimizer=opt, embedding_fused_bf16=False)
    cpu = Trainer(copy.deepcopy(model), device="cpu", **kw)
    card = Trainer(model, **kw)
    batch = {k: v[:256] for k, v in data.items()}
    dispatch.reset_launches()
    loss = card.train_step(batch)
    torch.cuda.synchronize()
    kernel = "embedding_adam" if opt == "fused_adam" else "embedding_rowwise_adagrad"
    assert dispatch.LAUNCHES == {"dot_interaction": 4, "mlp_fwd": 8, "mlp_bwd": 8,
                                 "embedding_adam": 0, "embedding_rowwise_adagrad": 0,
                                 kernel: 26}
    want = cpu.train_step(batch)
    # exact f32 on both sides: sums in another order
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=1e-6)
    got_sd, want_sd = card.model.state_dict(), cpu.model.state_dict()
    for name, w in want_sd.items():
        diff = (got_sd[name].cpu() - w).abs()
        # an Adam step moves a cell by about lr·sign(g): a g within the sum
        # order's noise of zero may move the other way
        assert (diff > 1e-5).float().mean() < 1e-3, name
    for name, st in cpu.emb_state.items():
        for k, w in st.items():
            torch.testing.assert_close(card.emb_state[name][k].cpu(), w, rtol=1e-3,
                                       atol=1e-9)

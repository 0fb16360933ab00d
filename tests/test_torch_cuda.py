"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version on the same inputs (the probe kernels bit for bit, probe_check.py), a small DLRM, SASRec, YoutubeDNN, MIND,
the two towers, FM-match, the CTR protocol models, NCF, DIN (PReLU and
Dice), ESMM, MMoE and PLE served on the card against the same model on the CPU, and
one training step of each on the card against the same step on the CPU.  They skip inside a fixture
when there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import copy
import ctypes

import numpy as np
import pytest
import torch

import ctr_check
import flash_check
import mlp_bwd_check
import probe_check
import retrieval_check
from recsys_tpu_torch.core.features import (DenseFeature, FeatureSchema, SparseFeature,
                                            VarLenSparseFeature)
from recsys_tpu_torch.data.realistic import din_schema
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.kernels import attention as attn
from recsys_tpu_torch.kernels import build, dispatch
from recsys_tpu_torch.kernels import embedding_update as emb_ref
from recsys_tpu_torch.kernels import interactions as int_ref
from recsys_tpu_torch.kernels import mlp as mlp_ref
from recsys_tpu_torch.kernels import topk as topk_ref
from recsys_tpu_torch.kernels.interactions import dot_interaction
from recsys_tpu_torch.kernels.mlp import mlp_backward, mlp_forward
from recsys_tpu_torch.models.ctr.din import DIN
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.models.ctr.esmm import ESMM
from recsys_tpu_torch.models.ctr.mmoe import MMoE
from recsys_tpu_torch.models.ctr.ple import PLE
from recsys_tpu_torch.models.match.fm_match import FMMatch
from recsys_tpu_torch.models.match.mind import MIND
from recsys_tpu_torch.models.match.ncf import NCF
from recsys_tpu_torch.models.match.sasrec import SASRec
from recsys_tpu_torch.models.match.two_tower import TwoTower
from recsys_tpu_torch.models.match.youtube_dnn import YoutubeDNN
from recsys_tpu_torch.ops.attention import MultiHeadAttention
from recsys_tpu_torch.ops.interactions import DotInteraction
from recsys_tpu_torch.tools.protocol import CTR_MODELS, ctr_model_kwargs
from recsys_tpu_torch.train.losses import (bce_probs, in_batch_sampled_softmax,
                                           multi_task_bce, pairwise_bce)
from recsys_tpu_torch.train.loop import Trainer
from recsys_tpu_torch.train.retrieval import topk_scores, topk_scores_streaming
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


def _widest_f(d):
    return max(f for f in range(2, 400) if int_ref.dot_in_domain(f, d, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("d", [1, 8, 16, 36, 128])
@pytest.mark.parametrize("f", [1, 2, 26, 27, 64, "widest"])
def test_dot_interaction_kernel_at_every_block_layout(cuda, dtype, self_interaction, d, f):
    # the 4 x 4 blocks of the Gram matrix at every edge: F not a multiple
    # of 4, D not whole float4s, the widest F the kernel takes at this D;
    # a ragged last tile of examples
    f = _widest_f(d) if f == "widest" else f
    if f == 1 and not self_interaction:
        with pytest.raises(ValueError, match="does not take"):
            dispatch.dot_interaction(torch.zeros(3, 1, d, device=cuda, dtype=dtype))
        return
    b = 9 if f > 64 else 1001
    x = torch.from_numpy(np.random.default_rng(f * d).normal(
        size=(b, f, d)).astype(np.float32) * 0.5).to(cuda, dtype)
    before = dispatch.LAUNCHES["dot_interaction"]
    got = dispatch.dot_interaction(x, self_interaction)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["dot_interaction"] == before + 1
    # both sum d exact products in f32, in another order
    torch.testing.assert_close(got, dot_interaction(x, self_interaction), rtol=1e-4, atol=1e-4)


def test_dot_interaction_kernel_on_an_unaligned_input(cuda):
    storage = torch.randn(1000 * 27 * 16 + 1, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        x = storage.to(dtype)[1:].view(1000, 27, 16)  # 4 (2) bytes into its storage
        torch.testing.assert_close(dispatch.dot_interaction(x), dot_interaction(x),
                                   rtol=1e-4, atol=1e-4)


def test_dot_in_domain_mirrors_the_kernel(cuda):
    lib = build.libraries()["dot_interaction"]
    for si in (False, True):
        for d in (1, 2, 3, 4, 7, 8, 16, 36, 128, 129, 256, 800, 1000, 4096, 20000):
            for f in range(0, 400):
                assert int_ref.dot_in_domain(f, d, si) == (
                    lib.dot_interaction_tile(f, d, int(si)) >= 1), (f, d, si)


def test_flash_in_domain_mirrors_the_kernels(cuda):
    libs = build.libraries()
    for d in range(0, 200):
        takes = (libs["flash_attention_fwd"].flash_attention_fwd_smem_bytes(d) != 0
                 and libs["flash_attention_bwd"].flash_attention_bwd_smem_bytes(d) != 0)
        assert attn.flash_in_domain(d) == takes, d


def test_topk_in_domain_mirrors_the_kernels_plan(cuda):
    lib = build.libraries()["topk_scores"]
    plan = (ctypes.c_int * 5)()
    for k in (1, 2, 10, 16, 17):
        for n in (k, k + 1, 20_000):
            for d in (*range(1, 1200, 37), 124, 125, 128, 129, 132, 133, 904, 909):
                got = lib.topk_scores_plan(64, n, -(-d // 4), k,
                                           ctypes.cast(plan, ctypes.c_void_p))
                assert topk_ref.in_domain(k, n, d) == bool(got), (k, n, d)


def test_f4_dot_route_on_card_matches_cpu(cuda):
    # past the kernel's shared memory: the route, forward and gradient
    x = torch.from_numpy(np.random.default_rng(40).normal(
        size=(16, 80, 800)).astype(np.float32) * 0.3)
    g = torch.randn(16, 80 * 79 // 2)
    res = {}
    for dev in ("cpu", cuda):
        xi = x.detach().to(dev).requires_grad_()
        dispatch.reset_launches()
        out = DotInteraction()(xi)
        (out * g.to(dev)).sum().backward()
        res[str(dev)] = (out.detach().cpu(), xi.grad.cpu())
    assert not any(dispatch.LAUNCHES.values())
    for got, want in zip(res[str(cuda)], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    dispatch.reset_launches()
    DotInteraction()(x[:, :27, :16].contiguous().to(cuda))  # in the domain: the kernel
    assert dispatch.LAUNCHES["dot_interaction"] == 1


def test_f4_attention_route_on_card_matches_cpu(cuda):
    torch.manual_seed(0)
    mha = MultiHeadAttention(24, 2, causal=True)  # head width 12
    rng = np.random.default_rng(41)
    mask = torch.from_numpy(rng.random((8, 20)) > 0.3)
    mask[0] = False
    x = torch.from_numpy(rng.normal(size=(8, 20, 24)).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda):
        m = copy.deepcopy(mha).to(dev)
        xi = x.detach().to(dev).requires_grad_()
        dispatch.reset_launches()
        out = m(xi, mask=mask.to(dev))
        out.square().sum().backward()
        res[str(dev)] = [t.cpu() for t in (out.detach(), xi.grad, m.wq.weight.grad)]
    assert not any(dispatch.LAUNCHES.values())
    for got, want in zip(res[str(cuda)], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_f4_autoint_train_step_at_d8_on_card_matches_cpu(cuda):
    schema, data = synthetic_ctr(num_examples=512, num_dense=13, num_sparse=26,
                                 vocab_size=5000, embed_dim=8, seed=42)
    torch.manual_seed(0)
    model = CTR_MODELS["autoint"](schema)  # two heads of width 4: the route
    cpu = Trainer(copy.deepcopy(model), device="cpu")
    card = Trainer(model)
    dispatch.reset_launches()
    loss = card.train_step(data)
    torch.cuda.synchronize()
    assert not any(dispatch.LAUNCHES.values())
    want = cpu.train_step(data)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=1e-6)
    got_sd, want_sd = card.model.state_dict(), cpu.model.state_dict()
    for key, w in want_sd.items():
        # a first Adam step moves a cell by about lr·sign(g): a g within the
        # sum order's noise of zero may move the other way
        assert ((got_sd[key].cpu() - w).abs() > 1e-5).float().mean() < 1e-3, key


def test_f4_topk_route_at_d1024_on_card_matches_cpu(cuda):
    q, items, dup = retrieval_check.topk_inputs(np.random.default_rng(43), 256, 3000, 1024,
                                                cuda)
    for fn in (topk_scores, topk_scores_streaming):
        dispatch.reset_launches()
        res = retrieval_check.check_topk(q, items, 10, fn, dup)
        torch.cuda.synchronize()
        assert not any(dispatch.LAUNCHES.values())
        assert res["ok"], res
        v_cpu, _ = fn(q.cpu(), items.cpu(), 10)
        v, _ = fn(q, items, 10)
        assert ((v.cpu() - v_cpu).abs() <= retrieval_check.score_limit(q, items).cpu()).all()


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
    assert dispatch.LAUNCHES == {**dict.fromkeys(dispatch.LAUNCHES, 0), "dot_interaction": 16,
                                 "mlp_fwd": 32 if fused else 0}
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


def _exact_mlp_case(cuda, b, dims, seed=9):
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    x, g, ws, bs = mlp_bwd_check.exact_case(np.random.default_rng(seed), b, dims)
    x, g, ws, bs = to(x), to(g), [to(w) for w in ws], [to(v) for v in bs]
    assert mlp_bwd_check.largest_term_sum(x, g, ws, bs) < mlp_bwd_check.EXACT_LIMIT
    return x, g, ws, bs


def _bwd_equal(got, want) -> bool:
    return all(torch.equal(u, v) for u, v in
               zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]))


# K and N off the 64 x 128 weight tiles, N = 1, K = 13, two column chunks
# (1300); the batches leave a partial last cluster and a ragged last CTA
RAGGED_DIMS = [[13, 100, 1], [200, 130, 70, 1], [5, 7, 3], [9, 4], [13, 512, 256, 16, 16],
               [200, 1300, 70, 1]]


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dims", RAGGED_DIMS)
@pytest.mark.parametrize("b", [31, 33, 4095, 4097])
def test_mlp_fwd_kernel_bit_equal_on_ragged_shapes(cuda, mm_bf16, dims, b):
    x, _, ws, bs = _exact_mlp_case(cuda, b, dims)
    got = dispatch.fused_mlp_forward(x, ws, bs, mm_bf16)
    assert torch.equal(got, mlp_forward(x, ws, bs, mm_bf16))


@pytest.mark.parametrize("dims", [*RAGGED_DIMS, [367, 1024, 1024, 512, 256, 1]])
@pytest.mark.parametrize("b", [31, 33, 4095, 4097])
def test_mlp_bwd_kernel_bit_equal_on_ragged_shapes(cuda, dims, b):
    x, g, ws, bs = _exact_mlp_case(cuda, b, dims)
    got = dispatch.fused_mlp_backward(x, g, ws, bs)
    assert _bwd_equal(got, mlp_backward(x, g, ws, bs))
    # the check sees a dW that leaves out the first of kernel B's batch
    # slices, or one 32-row step
    split, rows = dispatch.mlp_bwd_split(
        dims, b, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert split * rows >= b > (split - 1) * rows
    want = mlp_backward(x, g, ws, bs)[1]
    for n_rows in (rows, 32):
        part = mlp_backward(x[:n_rows], g[:n_rows], ws, bs)[1]
        assert any(not torch.equal(u - p, v) for u, p, v in zip(got[1], part, want))


@pytest.mark.parametrize("dims", [[13, 512, 256, 16, 16], [367, 1024, 1024, 512, 256, 1]])
def test_mlp_bwd_kernel_gives_the_same_bits_twice(cuda, dims):
    tw, tb = _mlp_params(dims, 12, cuda)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.random((4096, dims[0]), np.float32)).to(cuda)
    g = torch.from_numpy(rng.standard_normal((4096, dims[-1]), np.float32)).to(cuda)
    first = dispatch.fused_mlp_backward(x, g, tw, tb)
    assert _bwd_equal(first, dispatch.fused_mlp_backward(x, g, tw, tb))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dims", [[13, 512, 256, 16, 16], [367, 1024, 1024, 512, 256, 1],
                                  [13, 100, 1], [200, 1300, 70, 1]])
def test_mlp_pack_kernel_matches_plain(cuda, backward, dims):
    # the pre-pass alone, over a buffer of ones: every value of every tile,
    # padding included, is what kernels/mlp.py::pack_weight_tiles writes
    tw, tb = _mlp_params(dims, 11, cuda)
    x = torch.zeros((5, dims[0]), device=cuda)
    if backward:
        launch, bufs = dispatch.mlp_backward_call(x, torch.zeros((5, dims[-1]), device=cuda),
                                                  tw, tb)
    else:
        launch, bufs = dispatch.mlp_forward_call(x, tw, tb)
    bufs["packed"].fill_(1.0)
    launch(dispatch.MLP_PACK)
    want = mlp_ref.pack_weight_tiles([w.cpu() for w in tw], backward)
    assert torch.equal(bufs["packed"].cpu(), want)


@pytest.mark.parametrize("dims", [[367, 1024, 1024, 512, 256, 1], [13, 100, 1]])
def test_mlp_kernels_bit_equal_at_every_cluster_size(cuda, dims):
    # the chains' one cluster size C is compiled in: the card holds
    # clusters of it at these widths, and the launches run apart (as the
    # timing does) give the wrapper's bits
    for backward in (False, True):
        c, active = dispatch.mlp_chain_clusters(dims, backward)
        assert c >= 2 and active >= 1
    x, g, ws, bs = _exact_mlp_case(cuda, 1000, dims)
    launch, bufs = dispatch.mlp_forward_call(x, ws, bs)
    launch(dispatch.MLP_PACK)
    launch(dispatch.MLP_CHAIN)
    assert torch.equal(bufs["out"], mlp_forward(x, ws, bs))
    launch, bufs = dispatch.mlp_backward_call(x, g, ws, bs)
    for part in (dispatch.MLP_PACK, dispatch.MLP_CHAIN, dispatch.MLP_DW):
        launch(part)
    assert _bwd_equal((bufs["dx"], bufs["dws"], bufs["dbs"]), mlp_backward(x, g, ws, bs))


@pytest.mark.parametrize("width", [1216, 1344, 1472, 1536])
def test_mlp_kernels_take_the_widest_stacks(cuda, width):
    # the first design took bf16 stacks up to 1536 wide; the ring falls
    # back from 8 stages to 4 (1216), 3 (1344) and 2 (1472, 1536)
    x, g, ws, bs = _exact_mlp_case(cuda, 100, [8, width, 8])
    assert torch.equal(dispatch.fused_mlp_forward(x, ws, bs), mlp_forward(x, ws, bs))
    assert _bwd_equal(dispatch.fused_mlp_backward(x, g, ws, bs), mlp_backward(x, g, ws, bs))


@pytest.mark.parametrize("dims", [[367, 1536, 1536, 512, 256, 1], [367, 1344, 1344, 1300, 1],
                                  [200, 1152, 367, 1]])
def test_mlp_kernels_bit_equal_where_chunks_do_not_divide_the_ring(cuda, dims):
    # deep stacks at 2, 3 and 4 ring stages with chunks of 3 column tiles
    # (367 and 1300 wide): consecutive uses of a slot belong to different
    # warps, whose copies may land out of order; a full 4096-row call, a
    # few times over
    x, g, ws, bs = _exact_mlp_case(cuda, 4096, dims)
    want_f, want_b = mlp_forward(x, ws, bs), mlp_backward(x, g, ws, bs)
    for _ in range(3):
        assert torch.equal(dispatch.fused_mlp_forward(x, ws, bs), want_f)
        assert _bwd_equal(dispatch.fused_mlp_backward(x, g, ws, bs), want_b)


def _embedding_case(cuda, v, d, n, block, *, hot=False, seed=0, cot_scale=1e-2, ids=None):
    rng = np.random.default_rng(seed)
    if ids is None:
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


def _adam_matches_plain(cuda, v, d, n, block, *, p_dtype=torch.float32, mm_bf16=True,
                        wd=0.0, ids=None, offset=0, cot_scale=1e-2):
    """One fused Adam launch against the plain step from the same state;
    the table a view ``offset`` elements into its storage."""
    cot, ids2d, cptr, p, m, vv, to = _embedding_case(cuda, v, d, n, block, seed=d, ids=ids,
                                                     cot_scale=cot_scale)
    storage = torch.zeros(v * d + offset, dtype=p_dtype, device=cuda)
    table = storage[offset:].view(v, d)
    table.copy_(to(p))
    state = [table, to(m), to(vv)]
    plain = [t.clone() for t in state]
    before = dispatch.LAUNCHES["embedding_adam"]
    dispatch.fused_embedding_adam(*state, cot, ids2d, cptr, 3, block=block, lr=1e-3, wd=wd,
                                  mm_bf16=mm_bf16)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["embedding_adam"] == before + 1
    emb_ref.fused_adam(*plain, cot, ids2d, cptr, 3, block=block, lr=1e-3, wd=wd,
                       mm_bf16=mm_bf16)
    # as test_embedding_adam_kernel_matches_plain
    for name, got, want in zip("pmv", state, plain):
        tol = dict(rtol=8e-3, atol=1e-6) if got.dtype == torch.bfloat16 else \
            dict(rtol=2e-4, atol=1e-7)
        torch.testing.assert_close(got.float(), want.float(), **tol, msg=name)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("d", [4, 8, 12, 16, 32, 64])
def test_embedding_adam_kernel_at_every_row_width(cuda, p_dtype, mm_bf16, wd, d):
    # 1000 rows in blocks of 96 (each block's parts a few rows at D = 64):
    # a ragged last block of 40 rows, and no id in block 3 (rows 288-383),
    # whose rows still decay with g = 0
    ids = np.random.default_rng(d).integers(0, 1000 - 96, 700)
    ids = np.where(ids >= 288, ids + 96, ids).astype(np.int32)
    _adam_matches_plain(cuda, 1000, d, 700, 96, p_dtype=p_dtype, mm_bf16=mm_bf16, wd=wd,
                        ids=ids)


@pytest.mark.parametrize("d", [16, 64])
def test_embedding_adam_kernel_across_the_parts_of_a_block(cuda, d):
    # blocks of 512 rows cut into parts of 2048 values: ids at every part's
    # edges, duplicated, and a ragged last block (100,000 = 195 * 512 + 160)
    rows = np.arange(0, 100_000, 2048 // d)
    ids = np.concatenate([rows, rows - 1, rows[:500], np.full(300, 99_999)])
    ids = np.clip(ids, 0, 99_999).astype(np.int32)
    _adam_matches_plain(cuda, 100_000, d, ids.size, 512, ids=ids)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_embedding_adam_kernel_on_4096_duplicates(cuda, p_dtype):
    _adam_matches_plain(cuda, 300, 16, 4096, 8, p_dtype=p_dtype,
                        ids=np.full(4096, 37, np.int32))


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
def test_embedding_adam_kernel_on_a_table_4_bytes_off(cuda, p_dtype, d):
    # not aligned to 4 elements: single values
    _adam_matches_plain(cuda, 1000, d, 700, 96, p_dtype=p_dtype, wd=0.01,
                        offset=1 if p_dtype == torch.float32 else 2)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_embedding_adam_pass_of_unequal_tables_is_one_launch(cuda, p_dtype):
    # a bench-size table, a small one with a ragged last block, one of 37
    # rows in blocks of 16, one no id touches, one of no rows; and 45
    # tables, 36 of them with rows: two launches
    cases = [(100_000, 16384, 512), (1000, 700, 96), (37, 300, 16), (5000, 500, 512)]
    tabs = []
    for i, (v, n, block) in enumerate(cases):
        cot, ids2d, cptr, p, m, vv, to = _embedding_case(cuda, v, 16, n, block, seed=50 + i)
        if i == 3:
            ids2d.fill_(emb_ref.num_blocks(v, block) * block)  # every slot the sentinel
            cptr.zero_()
        tabs.append([to(p).to(p_dtype), to(m), to(vv), cot, ids2d, cptr, block])
    t = tabs[2]
    tabs.append([t[0][:0], t[1][:0], t[2][:0], t[3], t[4], t[5][:1].clone(), 16])
    for count, launches in ((len(tabs), 1), (45, 2)):
        tables = [tabs[i % len(tabs)] for i in range(count)]
        state = [[tab[j].clone() for tab in tables] for j in range(3)]
        plain = [[tab[j].clone() for tab in tables] for j in range(3)]
        cols = [[tab[j] for tab in tables] for j in range(3, 6)]
        blocks = [tab[6] for tab in tables]
        dispatch.reset_launches()
        dispatch.fused_embedding_adam_pass(*state, *cols, 3, blocks=blocks, lr=1e-3)
        torch.cuda.synchronize()
        assert dispatch.LAUNCHES["embedding_adam"] == launches
        for i, block in enumerate(blocks):
            emb_ref.fused_adam(*(w[i] for w in plain), *(c[i] for c in cols), 3, block=block,
                               lr=1e-3)
            for name, got, want in zip("pmv", state, plain):
                tol = dict(rtol=8e-3, atol=1e-6) if got[i].dtype == torch.bfloat16 else \
                    dict(rtol=2e-4, atol=1e-7)
                torch.testing.assert_close(got[i].float(), want[i].float(), **tol,
                                           msg=f"{name} of table {i}")
    with pytest.raises(ValueError, match="one D"):
        wide = _embedding_case(cuda, 50, 8, 40, 16)
        dispatch.fused_embedding_adam_pass(
            [tabs[1][0], wide[6](wide[3]).to(p_dtype)], [tabs[1][1], wide[6](wide[4])],
            [tabs[1][2], wide[6](wide[5])], [tabs[1][3], wide[0]], [tabs[1][4], wide[1]],
            [tabs[1][5], wide[2]], 3, blocks=[96, 16], lr=1e-3)


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


def _adagrad_matches_plain(cuda, v, d, n, block, *, p_dtype=torch.float32, mm_bf16=True,
                           wd=0.0, ids=None, offset=0, cot_scale=1e-2):
    """One rowwise AdaGrad launch against the plain step from the same
    state; the table a view ``offset`` elements into its storage."""
    cot, ids2d, cptr, p, _, _, to = _embedding_case(cuda, v, d, n, block, seed=d, ids=ids,
                                                    cot_scale=cot_scale)
    acc = np.random.default_rng(2).uniform(0, 1e-4, v).astype(np.float32)
    storage = torch.zeros(v * d + offset, dtype=p_dtype, device=cuda)
    table = storage[offset:].view(v, d)
    table.copy_(to(p))
    state = [table, to(acc)]
    plain = [table.clone(), state[1].clone()]
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


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("d", [4, 8, 12, 16, 32, 64])
def test_embedding_rowwise_adagrad_kernel_at_every_row_width(cuda, p_dtype, mm_bf16, wd, d):
    # 1000 rows in blocks of 96: a ragged last block of 40 rows, and no id
    # in block 3 (rows 288-383), whose rows still decay with g = 0
    ids = np.random.default_rng(d).integers(0, 1000 - 96, 700)
    ids = np.where(ids >= 288, ids + 96, ids).astype(np.int32)
    _adagrad_matches_plain(cuda, 1000, d, 700, 96, p_dtype=p_dtype, mm_bf16=mm_bf16, wd=wd,
                           ids=ids)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_embedding_rowwise_adagrad_kernel_on_4096_duplicates(cuda, p_dtype):
    _adagrad_matches_plain(cuda, 300, 16, 4096, 8, p_dtype=p_dtype,
                           ids=np.full(4096, 37, np.int32), cot_scale=1.0)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
def test_embedding_rowwise_adagrad_kernel_on_a_table_4_bytes_off(cuda, p_dtype, d):
    # 4 bytes into its storage: not aligned to a lane's 4 elements, so the
    # warp-a-row path
    _adagrad_matches_plain(cuda, 1000, d, 700, 96, p_dtype=p_dtype, wd=0.01,
                           offset=1 if p_dtype == torch.float32 else 2)


@pytest.mark.parametrize("kind", ["adam", "adagrad"])
def test_embedding_updates_take_a_tile_of_odd_length(cuda, kind):
    # a (7, 5) tile: 35 floats, not whole float4s to zero; 50 = 7 * 7 + 1 rows
    if kind == "adagrad":
        return _adagrad_matches_plain(cuda, 50, 5, 300, 7, wd=0.01)
    cot, ids2d, cptr, p, m, vv, to = _embedding_case(cuda, 50, 5, 300, 7)
    state = [to(p), to(m), to(vv)]
    plain = [t.clone() for t in state]
    dispatch.fused_embedding_adam(*state, cot, ids2d, cptr, 3, block=7, lr=1e-3, wd=0.01)
    emb_ref.fused_adam(*plain, cot, ids2d, cptr, 3, block=7, lr=1e-3, wd=0.01)
    torch.cuda.synchronize()
    for name, got, want in zip("pmv", state, plain):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-7, msg=name)


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
    # fused Adam updates the 26 tables in one launch, AdaGrad one a table
    kernel = {"embedding_adam": 1} if opt == "fused_adam" else \
        {"embedding_rowwise_adagrad": 26}
    assert dispatch.LAUNCHES == {**dict.fromkeys(dispatch.LAUNCHES, 0), "dot_interaction": 4,
                                 "mlp_fwd": 8, "mlp_bwd": 8, **kernel}
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


# -- flash attention -----------------------------------------------------------
@pytest.mark.parametrize("mask_kind", flash_check.MASKS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b, h, s, d", [(256, 2, 512, 32), (64, 2, 300, 32), (16, 2, 2048, 32),
                                        (128, 1, 50, 64), (3, 3, 77, 8), (2, 2, 130, 128),
                                        (1, 1, 1, 16), (512, 2, 39, 8), (4, 2, 63, 32),
                                        (4, 2, 64, 32), (4, 2, 65, 32), (4, 2, 127, 32),
                                        (4, 2, 129, 32), (3, 2, 64, 128), (3, 2, 40, 128)])
def test_flash_attention_kernels_match_plain(cuda, mask_kind, causal, b, h, s, d):
    """flash_check.check: out, lse, dq, dk and dv within their limits, and
    each limit rejects the three wrong results (with one key, dq and dk are
    0 whatever the mask, so there only the limits).  The shapes reach both
    geometries of the kernels (whole heads at S <= 64 and D <= 64, key
    tiles above) and their edges: AutoInt's train step, S on both sides of
    the short route (63, 64, 65) and of a 128-row block (127, 129), D = 128
    at short S."""
    rng = np.random.default_rng(10)
    q, k, v, do, mask = flash_check.inputs(rng, b, h, s, d, mask_kind, cuda)
    before = dict(dispatch.LAUNCHES)
    res = flash_check.check(q, k, v, do, mask, causal, dispatch.flash_attention_fwd,
                            dispatch.flash_attention_bwd)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert dispatch.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    assert all(res["within"].values()), res
    assert s == 1 or res["ok"], res


@pytest.mark.parametrize("b, h, s, d, causal, mask_kind", [(64, 2, 512, 32, True, "front-padded"),
                                                          (512, 2, 39, 8, False, "none"),
                                                          (8, 2, 129, 128, True, "random")])
def test_flash_attention_kernels_are_deterministic(cuda, b, h, s, d, causal, mask_kind):
    """Every sum has one owner (no atomics): two launches give the same bits."""
    q, k, v, do, mask = flash_check.inputs(np.random.default_rng(13), b, h, s, d, mask_kind,
                                           cuda)
    first = dispatch.flash_attention_fwd(q, k, v, mask, causal)
    again = dispatch.flash_attention_fwd(q, k, v, mask, causal)
    grads = [dispatch.flash_attention_bwd(q, k, v, mask, *first, do, causal) for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip((*first, *grads[0]), (*again, *grads[1])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("b, h, s, d, causal, mask_kind", [(256, 2, 512, 32, True, "front-padded"),
                                                          (4096, 2, 39, 8, False, "none")])
def test_flash_attention_error_is_within_twice_the_plain_versions(cuda, b, h, s, d, causal,
                                                                  mask_kind):
    """The kernels' split-TF32 products keep f32 accuracy: against the same
    formulas in float64 (flash_check.float64_reference), each of out, lse,
    dq, dk and dv is at most twice as far off as the plain f32 versions,
    each pipeline's backward taking its own forward's residuals.  SASRec's
    and AutoInt's shapes."""
    q, k, v, do, mask = flash_check.inputs(np.random.default_rng(14), b, h, s, d, mask_kind,
                                           cuda)
    want = flash_check.float64_reference(q, k, v, do, mask, causal)
    errors = {}
    for name, fwd, bwd in (("plain", attn.flash_attention_fwd, attn.flash_attention_bwd),
                           ("kernel", dispatch.flash_attention_fwd,
                            dispatch.flash_attention_bwd)):
        out, lse = fwd(q, k, v, mask, causal)
        got = dict(zip(("out", "lse", "dq", "dk", "dv"),
                       (out, lse, *bwd(q, k, v, mask, out, lse, do, causal))))
        errors[name] = {n: float((got[n].double() - w).abs().max()) for n, w in want.items()}
    for n in want:
        assert errors["kernel"][n] <= 2 * errors["plain"][n], (n, errors)


def test_flash_attention_kernels_refuse_what_they_cannot_take(cuda):
    q = torch.randn(2, 2, 40, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn(2, 2, 40, 12, device=cuda)
        dispatch.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn(1, 1, 8, 136, device=cuda)
        dispatch.flash_attention_fwd(x, x, x)
    with pytest.raises(TypeError, match="f32"):
        dispatch.flash_attention_fwd(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.randn(2, 40, 2, 32, device=cuda).transpose(1, 2)
        dispatch.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="mask on"):
        dispatch.flash_attention_fwd(q, q, q, torch.ones(2, 40, dtype=torch.int32))


def _sasrec_batch(rng, n, maxlen, num_items, negs):
    lens = rng.integers(1, maxlen + 1, n)
    hist = rng.integers(1, num_items, (n, maxlen)).astype(np.int32)
    hist[np.arange(maxlen)[None, :] < maxlen - lens[:, None]] = 0
    return {"hist": hist, "pos": rng.integers(1, num_items, n).astype(np.int32),
            "neg": rng.integers(1, num_items, (n, negs)).astype(np.int32)}


def _sasrec_loss(out, batch):
    return pairwise_bce(out["pos_logits"], out["neg_logits"], mask=out.get("mask"))


def test_sasrec_predict_on_card_matches_cpu(cuda):
    data = _sasrec_batch(np.random.default_rng(11), 300, 64, 1000, 20)
    torch.manual_seed(0)
    model = SASRec(num_items=1000, embed_dim=32, num_blocks=2, num_heads=2, max_len=64,
                   dropout_rate=0.0)
    want = Trainer(model, device="cpu").predict(data, batch_size=128)
    dispatch.reset_launches()
    got = Trainer(model).predict(data, batch_size=128)
    # three batches (the last padded), one forward launch per block
    assert dispatch.LAUNCHES == {**dict.fromkeys(dispatch.LAUNCHES, 0), "flash_attention_fwd": 6}
    for key in want:
        # exact f32 on both sides: sums in another order through two blocks
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)


def test_sasrec_train_step_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(12)
    batch = _sasrec_batch(rng, 64, 100, 500, 1)
    torch.manual_seed(0)
    model = SASRec(num_items=500, embed_dim=32, num_blocks=2, num_heads=2, max_len=100,
                   dropout_rate=0.0)
    cpu = Trainer(copy.deepcopy(model), loss_fn=_sasrec_loss, device="cpu")
    card = Trainer(model, loss_fn=_sasrec_loss)
    dispatch.reset_launches()
    loss = card.train_step(batch)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES == {**dict.fromkeys(dispatch.LAUNCHES, 0),
                                 "flash_attention_fwd": 2, "flash_attention_bwd": 2}
    want = cpu.train_step(batch)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=1e-6)
    got_sd, want_sd = card.model.state_dict(), cpu.model.state_dict()
    for name, w in want_sd.items():
        # a first Adam step moves a cell by about lr·sign(g): a g within the
        # sum order's noise of zero may move the other way
        assert ((got_sd[name].cpu() - w).abs() > 1e-5).float().mean() < 1e-3, name


# -- pooled gather and top-k ---------------------------------------------------
@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, length, v, d", [(1024, 50, 20_000, 32), (1000, 50, 20_000, 128),
                                             (33, 7, 500, 7), (5, 70, 300, 300), (3, 1, 10, 16)])
def test_pooled_gather_kernel_matches_plain(cuda, skewed, dtype, b, length, v, d):
    """retrieval_check.check_pooled: within the limit, rows with no real
    position 0, and the sum without each row's last id rejected (D = 7 and
    300 take the one-element and the column-block paths)."""
    table, rows, mask = retrieval_check.pooled_inputs(np.random.default_rng(13), b, length, v,
                                                      d, dtype, skewed, cuda)
    before = dispatch.LAUNCHES["pooled_gather"]
    res = retrieval_check.check_pooled(table, rows, mask, dispatch.pooled_gather)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["pooled_gather"] == before + 1
    assert res["within"] and res["empty_rows_zero"], res
    assert length == 1 or res["wrong_rejected"], res


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 31, 32, 33, 50, 64, 65, 200])
@pytest.mark.parametrize("d", [4, 12, 32, 33, 128, 130])
def test_pooled_gather_kernel_geometry(cuda, skewed, dtype, length, d):
    """check_pooled across the kernel's geometries: histories of one pass
    of 64 positions and more, rows of 16 to 520 bytes (two examples a warp
    at D <= 16, column blocks past 32 lanes, the element-a-lane path at odd
    D), empty histories, and the same on an unaligned table."""
    table, rows, mask = retrieval_check.pooled_inputs(np.random.default_rng(length * d), 67,
                                                      length, 2000, d, dtype, skewed, cuda)
    for t in (table, retrieval_check.unaligned(table)):
        before = dispatch.LAUNCHES["pooled_gather"]
        res = retrieval_check.check_pooled(t, rows, mask, dispatch.pooled_gather)
        torch.cuda.synchronize()
        assert dispatch.LAUNCHES["pooled_gather"] == before + 1
        assert res["within"] and res["empty_rows_zero"] and res["empty_rows"] > 0, res
        assert length == 1 or res["wrong_rejected"], res


def test_segment_sum_gather_gradient_on_card_matches_cpu(cuda):
    table, rows, mask = retrieval_check.pooled_inputs(np.random.default_rng(14), 256, 20, 1000,
                                                      32, torch.float32, True, "cpu")
    g = torch.randn(256, 32)
    grads = []
    for dev, cot in (("cpu", g), (cuda, g), ("cpu", g.abs())):
        t = table.detach().to(dev).requires_grad_()
        (dispatch.segment_sum_gather(t, rows.to(dev), mask.to(dev), "mean") * cot.to(dev)) \
            .sum().backward()
        grads.append(t.grad.cpu())
    # index_add_ on the card adds in another order: a cell that sums many
    # terms (a Zipf-hot id collects thousands) may move by a few roundings
    # of the sum of its terms' magnitudes, which the gradient of |g| gives
    # (the mean's weights are >= 0)
    diff = (grads[1] - grads[0]).abs()
    assert (diff <= 1e-5 * grads[2] + 1e-7).all(), float(diff.max())


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("nq, n, d", [(8192, 19_203, 32), (3616, 19_203, 32), (100, 1000, 64),
                                      (5, 17, 30), (70, 500, 128), (300, None, 32),
                                      (1000, 5000, 4), (1000, 5000, 12), (1000, 5000, 64),
                                      (1000, 5000, 124)])
def test_topk_kernel_matches_plain(cuda, k, nq, n, d):
    """retrieval_check.check_topk: values and ranks within the score limit
    (near-ties may swap), exact ties lower id first (rows copied across the
    plan's tile and split boundaries), the k-th entry swapped for the
    (k+1)-th and single-pass TF32 scores rejected (D = 30 and 124 are padded
    to a multiple of 8 columns; n None is k + 1 items; D = 128 is the edge
    of the domain, 129 past it in the route test below)."""
    n = n or k + 1
    plan = dispatch.topk_plan(nq, n, d, k)
    dup = retrieval_check.boundary_ids(n, plan[1], plan[3])
    q, items, dup = retrieval_check.topk_inputs(np.random.default_rng(15), nq, n, d, cuda,
                                                dup_at=dup)
    before = dispatch.LAUNCHES["topk_scores"]
    res = retrieval_check.check_topk(q, items, k, dispatch.topk_scores_fused, dup)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["topk_scores"] == before + 1
    assert res["ok"], res


@pytest.mark.parametrize("d", [129, 300])
def test_topk_route_past_the_kernels_widths_matches_plain(cuda, d):
    """Past D = 128 both retrieval functions take the score route, with no
    launch, and meet check_topk's limits (D = 300 was a kernel case while
    the kernel staged queries in shared memory)."""
    q, items, dup = retrieval_check.topk_inputs(np.random.default_rng(15), 70, 500, d, cuda)
    before = dispatch.LAUNCHES["topk_scores"]
    for fn in (topk_scores, topk_scores_streaming):
        for k in (1, 10, 16):
            res = retrieval_check.check_topk(q, items, k, fn, dup)
            assert res["ok"], (fn.__name__, k, res)
    assert dispatch.LAUNCHES["topk_scores"] == before


def test_topk_kernel_takes_a_million_items(cuda):
    q, items, dup = retrieval_check.topk_inputs(np.random.default_rng(16), 1024, 1_000_000, 64,
                                                cuda, normalize=False)
    res = retrieval_check.check_topk(q, items, 10, dispatch.topk_scores_fused, dup)
    assert res["ok"], res


def test_topk_kernel_refuses_what_it_cannot_take(cuda):
    q, items = torch.randn(4, 8, device=cuda), torch.randn(20, 8, device=cuda)
    with pytest.raises(ValueError, match="1 <= k <= 16"):
        dispatch.topk_scores_fused(q, items, 17)
    with pytest.raises(ValueError, match="items on"):
        dispatch.topk_scores_fused(q, items.cpu(), 5)
    # outside the kernel's domain retrieval takes the full score matrix
    before = dispatch.LAUNCHES["topk_scores"]
    v, i = topk_scores(q, items, 17)
    assert dispatch.LAUNCHES["topk_scores"] == before and v.shape == (4, 17)


def _youtube(num_items, maxlen):
    schema = FeatureSchema(varlen=[VarLenSparseFeature("hist_item", num_items, 32,
                                                       max_len=maxlen)])
    torch.manual_seed(0)
    return YoutubeDNN(schema, num_items=num_items, embed_dim=32, hidden_units=(128, 64))


def _youtube_batch(rng, n, maxlen, num_items):
    lens = rng.integers(0, maxlen + 1, n)
    hist = rng.integers(1, num_items, (n, maxlen)).astype(np.int32)
    hist[np.arange(maxlen)[None, :] < maxlen - lens[:, None]] = 0
    return {"hist": hist, "item_id": rng.integers(1, num_items, n).astype(np.int32)}


def _youtube_loss(out, batch):
    return in_batch_sampled_softmax(out["user"], out["item"])


def test_youtube_retrieval_on_card_matches_cpu(cuda):
    data = _youtube_batch(np.random.default_rng(17), 600, 50, 5000)
    model = _youtube(5000, 50).eval()
    hist = torch.from_numpy(data["hist"])
    with torch.no_grad():
        want_u = model.user_embed({"hist": hist})
        want = topk_scores(want_u, model.all_item_embeddings(), k=10)
        card = copy.deepcopy(model).to(cuda)
        dispatch.reset_launches()
        got_u = card.user_embed({"hist": hist.to(cuda)})
        got = topk_scores(got_u, card.all_item_embeddings(), k=10)
        torch.cuda.synchronize()
    assert dispatch.LAUNCHES == {**dict.fromkeys(dispatch.LAUNCHES, 0), "pooled_gather": 1,
                                 "topk_scores": 1}
    # exact f32 on both sides, sums in another order
    torch.testing.assert_close(got_u.cpu(), want_u, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    assert (got[1].cpu() == want[1]).double().mean() > 0.99


def test_youtube_train_step_on_card_matches_cpu(cuda):
    batch = _youtube_batch(np.random.default_rng(18), 512, 50, 2000)
    model = _youtube(2000, 50)
    cpu = Trainer(copy.deepcopy(model), loss_fn=_youtube_loss, device="cpu")
    card = Trainer(model, loss_fn=_youtube_loss)
    dispatch.reset_launches()
    loss = card.train_step(batch)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES == {**dict.fromkeys(dispatch.LAUNCHES, 0), "pooled_gather": 1}
    want = cpu.train_step(batch)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=1e-6)
    got_sd, want_sd = card.model.state_dict(), cpu.model.state_dict()
    for name, w in want_sd.items():
        # a first Adam step moves a cell by about lr·sign(g): a g within the
        # sum order's noise of zero may move the other way
        assert ((got_sd[name].cpu() - w).abs() > 1e-5).float().mean() < 1e-3, name


# -- MIND, the two towers and FM-match -------------------------------------------
def _launched(**counts) -> dict:
    return {**dict.fromkeys(dispatch.LAUNCHES, 0), **counts}


def _mind(num_items):
    torch.manual_seed(0)
    return MIND(num_items, embed_dim=32, k_max=4, user_units=(64,))


def test_mind_retrieval_on_card_matches_cpu(cuda):
    data = _youtube_batch(np.random.default_rng(19), 600, 50, 5000)
    model = _mind(5000).eval()
    hist = torch.from_numpy(data["hist"])
    with torch.no_grad():
        want_caps = model.interests({"hist": hist})
        want = topk_scores(want_caps.reshape(-1, 32), model.all_item_embeddings(), k=10)
        card = copy.deepcopy(model).to(cuda)
        dispatch.reset_launches()
        got_caps = card.interests({"hist": hist.to(cuda)})
        got = topk_scores(got_caps.reshape(-1, 32), card.all_item_embeddings(), k=10)
        torch.cuda.synchronize()
    assert dispatch.LAUNCHES == _launched(topk_scores=1)
    torch.testing.assert_close(got_caps.cpu(), want_caps, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    assert (got[1].cpu() == want[1]).double().mean() > 0.99


def _share_off(got_sd, want_sd, lr=1e-3) -> float:
    """The share of the model's cells more than 1e-5 from the CPU step's;
    every cell within Adam's first step of 2·lr (a gradient within the sum
    order's noise of zero, or exactly zero as the in-batch softmax leaves
    the item tower's last bias, may move its cell the other way)."""
    off = total = 0
    for name, w in want_sd.items():
        diff = (got_sd[name].cpu() - w).abs()
        assert float(diff.max()) <= 2 * lr * 1.001, name
        off += int((diff > 1e-5).sum())
        total += diff.numel()
    return off / total


def test_mind_train_step_on_card_matches_cpu(cuda):
    batch = _youtube_batch(np.random.default_rng(20), 512, 50, 2000)
    model = _mind(2000)
    cpu = Trainer(copy.deepcopy(model), loss_fn=_youtube_loss, device="cpu")
    card = Trainer(model, loss_fn=_youtube_loss)
    dispatch.reset_launches()
    loss = card.train_step(batch)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES == _launched()
    torch.testing.assert_close(loss.cpu(), cpu.train_step(batch), rtol=1e-5, atol=1e-6)
    assert _share_off(card.model.state_dict(), cpu.model.state_dict()) < 1e-3


def _tower_schemas():
    user = FeatureSchema(sparse=[SparseFeature("user_id", 3000, 16),
                                 SparseFeature("age_bin", 9, 16),
                                 SparseFeature("gender", 3, 16),
                                 SparseFeature("occupation", 22, 16)])
    item = FeatureSchema(sparse=[SparseFeature("item_id", 2001, 16),
                                 SparseFeature("cate", 201, 16)])
    return user, item


def _tower_batch(rng, n):
    user, item = _tower_schemas()
    return {"user_sparse": np.stack([rng.integers(0, f.vocab_size, n) for f in user.sparse],
                                    1).astype(np.int32),
            "item_sparse": np.stack([rng.integers(0, f.vocab_size, n) for f in item.sparse],
                                    1).astype(np.int32),
            "label": (rng.random(n) < 0.4).astype(np.float32)}


def _tower_model(name):
    torch.manual_seed(0)
    if name == "fm_match":
        return FMMatch(*_tower_schemas())
    return TwoTower(*_tower_schemas(), out_dim=32, use_senet=name == "senet",
                    output_mode="pair")


@pytest.mark.parametrize("name", ["dssm", "senet", "fm_match"])
def test_tower_retrieval_on_card_matches_cpu(cuda, name):
    model = _tower_model(name).eval()
    batch = {k: torch.from_numpy(v) for k, v in _tower_batch(np.random.default_rng(21),
                                                             600).items()}
    catalog = {"item_sparse": torch.from_numpy(np.stack(
        [np.arange(1, 2001), np.random.default_rng(22).integers(1, 201, 2000)], 1).astype(
        np.int32))}
    with torch.no_grad():
        want_u, want_items = model.user_embed(batch), model.item_embed(catalog)
        want = topk_scores(want_u, want_items, k=10)
        card = copy.deepcopy(model).to(cuda)
        dispatch.reset_launches()
        got_u = card.user_embed({k: v.to(cuda) for k, v in batch.items()})
        got = topk_scores(got_u, card.item_embed({k: v.to(cuda) for k, v in catalog.items()}),
                          k=10)
        torch.cuda.synchronize()
    assert dispatch.LAUNCHES == _launched(topk_scores=1)
    torch.testing.assert_close(got_u.cpu(), want_u, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    assert (got[1].cpu() == want[1]).double().mean() > 0.99


@pytest.mark.parametrize("name", ["dssm", "senet", "fm_match"])
def test_tower_train_step_on_card_matches_cpu(cuda, name):
    batch = _tower_batch(np.random.default_rng(23), 2048)
    batch["item_id"] = batch["item_sparse"][:, 0].copy()
    model = _tower_model(name)
    kw = {} if name == "fm_match" else {"loss_fn": _youtube_loss}
    cpu = Trainer(copy.deepcopy(model), device="cpu", **kw)
    card = Trainer(model, **kw)
    dispatch.reset_launches()
    loss = card.train_step(batch)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES == _launched(
        **({"fm_pairwise_vector": 1} if name == "fm_match" else {}))
    torch.testing.assert_close(loss.cpu(), cpu.train_step(batch), rtol=1e-5, atol=1e-6)
    assert _share_off(card.model.state_dict(), cpu.model.state_dict()) < 1e-2


# -- NCF, DIN, ESMM, MMoE and PLE: no kernel on their paths -------------------
MT_SCHEMA = FeatureSchema(dense=[DenseFeature(f"I{i}") for i in range(8)],
                          sparse=[SparseFeature(f"C{i}", v, 16) for i, v in
                                  enumerate((5000, 300, 3, 1200, 40, 20000))])


def _slice_model(name):
    """(model, loss_fn, batch maker) of this slice's model ``name`` at the
    protocols' widths, weights from seed 0."""
    torch.manual_seed(0)
    if name == "ncf":
        def batch(rng, n, negs=1):
            return {"user": rng.integers(0, 3000, n).astype(np.int32),
                    "pos_item": rng.integers(0, 2000, n).astype(np.int32),
                    "neg_item": rng.integers(0, 2000, (n, negs)).astype(np.int32)}
        return NCF(3000, 2000), lambda o, b: pairwise_bce(o["pos_logits"], o["neg_logits"]), batch
    if name.startswith("din"):
        def batch(rng, n):
            hist = rng.integers(1, 3000, (n, 40)).astype(np.int32)
            hist[np.arange(40)[None, :] < rng.integers(0, 41, n)[:, None]] = 0  # front pads
            return {"sparse": np.stack([rng.integers(1, 3000, n), rng.integers(1, 200, n)],
                                       1).astype(np.int32),
                    "hist": hist, "hist_cate": np.where(hist > 0, hist % 199 + 1, 0).astype(
                        np.int32),
                    "label": (rng.random(n) < 0.5).astype(np.float32)}
        model = DIN(din_schema(3000, 200, 8, 40), ffn_activation=name.split("-")[1])
        return model, None, batch

    def batch(rng, n):
        return {"sparse": np.stack([rng.integers(0, f.vocab_size, n) for f in MT_SCHEMA.sparse],
                                   1).astype(np.int32),
                "dense": rng.random((n, 8)).astype(np.float32),
                "click": (rng.random(n) < 0.3).astype(np.float32),
                "ctcvr": (rng.random(n) < 0.1).astype(np.float32)}
    if name == "esmm":
        return (ESMM(MT_SCHEMA, num_user_fields=3),
                lambda o, b: bce_probs(o["ctr"], b["click"]) + bce_probs(o["ctcvr"], b["ctcvr"]),
                batch)
    model = (MMoE if name == "mmoe" else PLE)(MT_SCHEMA, task_names=("click", "ctcvr"))
    return model, lambda o, b: multi_task_bce(o, {t: b[t] for t in ("click", "ctcvr")}), batch


SLICE_MODELS = ["ncf", "din-prelu", "din-dice", "esmm", "mmoe", "ple"]


@pytest.mark.parametrize("name", SLICE_MODELS)
def test_slice_model_predict_on_card_matches_cpu(cuda, name):
    model, _, make = _slice_model(name)
    rng = np.random.default_rng(24)
    data = make(rng, 1500, 100) if name == "ncf" else make(rng, 1500)
    data = {k: v for k, v in data.items() if k not in ("label", "click", "ctcvr")}
    want = Trainer(copy.deepcopy(model), device="cpu").predict(data, batch_size=512)
    card = Trainer(model)
    dispatch.reset_launches()
    got = card.predict(data, batch_size=512)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES == _launched()
    for k, w in (want.items() if isinstance(want, dict) else [("out", want)]):
        g = got[k] if isinstance(got, dict) else got
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", SLICE_MODELS)
def test_slice_model_train_step_on_card_matches_cpu(cuda, name):
    """One step from the same weights: the loss within 1e-5, the parameters
    and the BatchNorm statistics as ``_share_off`` holds them."""
    model, loss_fn, make = _slice_model(name)
    batch = make(np.random.default_rng(25), 1024)
    kw = {} if loss_fn is None else {"loss_fn": loss_fn}
    cpu = Trainer(copy.deepcopy(model), device="cpu", **kw)
    card = Trainer(model, **kw)
    dispatch.reset_launches()
    loss = card.train_step(batch)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES == _launched()
    torch.testing.assert_close(loss.cpu(), cpu.train_step(batch), rtol=1e-5, atol=1e-6)
    assert _share_off(card.model.state_dict(), cpu.model.state_dict()) < 1e-3


# -- FM bi-interaction and the CTR protocol models ----------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ctr_check.WIDTHS)
@pytest.mark.parametrize("f", ctr_check.FIELDS)
def test_fm_kernel_matches_plain(cuda, dtype, d, f):
    rng = np.random.default_rng(19)
    for b in ctr_check.BATCHES:
        x = ctr_check.inputs(rng, b, f, d, dtype, "normal", cuda)
        before = dispatch.LAUNCHES["fm_pairwise_vector"]
        res = ctr_check.check(dispatch.fm_pairwise_vector_fused, x)
        torch.cuda.synchronize()
        assert dispatch.LAUNCHES["fm_pairwise_vector"] == before + (b > 0)
        assert res["excess"] <= 1.0, (b, res)
        assert res.get("wrong_least_excess", 2.0) > 1.0, (b, res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_kernel_on_cancelling_inputs_and_views(cuda, dtype):
    x = ctr_check.inputs(np.random.default_rng(20), 4096, 39, 16, dtype, "cancelling", cuda)
    res = ctr_check.check(dispatch.fm_pairwise_vector_fused, x)
    assert res["excess"] <= 1.0 < res["wrong_least_excess"], res
    # an input that is not 16-byte aligned takes the one-value path
    x = ctr_check.inputs(np.random.default_rng(21), 513, 26, 16, dtype, "normal", cuda)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert ctr_check.check(dispatch.fm_pairwise_vector_fused, shifted)["excess"] <= 1.0


def test_fm_gradient_on_card_matches_cpu(cuda):
    x = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (512, 26, 16)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(23).standard_normal((512,)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        (dispatch.fm_pairwise(xd) * g.to(dev)).sum().backward()
        grads.append(xd.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)


def _ctr_schema_and_data(n, seed):
    schema, data = synthetic_ctr(num_examples=n, num_dense=13, num_sparse=26,
                                 vocab_size=5000, embed_dim=16, seed=seed)
    return schema, data


@pytest.mark.parametrize("name", list(CTR_MODELS))
def test_ctr_model_predict_on_card_matches_cpu(cuda, name):
    schema, data = _ctr_schema_and_data(1000, 24)
    torch.manual_seed(0)
    model = CTR_MODELS[name](schema, **ctr_model_kwargs(name))
    want = Trainer(model, device="cpu").predict(data, batch_size=512)
    dispatch.reset_launches()
    got = Trainer(model).predict(data, batch_size=512)
    launches = {"fm": "fm_pairwise_vector", "deepfm": "fm_pairwise_vector",
                "dlrm": "dot_interaction", "autoint": "flash_attention_fwd"}
    expected = dict.fromkeys(dispatch.LAUNCHES, 0)
    if name in launches:  # two batches, the last padded; three layers in AutoInt
        expected[launches[name]] = 6 if name == "autoint" else 2
    assert dispatch.LAUNCHES == expected
    # f32 sums in another order; DLRM computes in bf16 (tests/test_torch_dlrm.py)
    tol = dict(rtol=1e-2, atol=2e-3) if name == "dlrm" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", ["fm", "deepfm", "autoint"])
def test_ctr_train_step_on_card_matches_cpu(cuda, name):
    schema, data = _ctr_schema_and_data(512, 25)
    torch.manual_seed(0)
    model = CTR_MODELS[name](schema)
    cpu = Trainer(copy.deepcopy(model), device="cpu")
    card = Trainer(model)
    dispatch.reset_launches()
    loss = card.train_step(data)
    torch.cuda.synchronize()
    kernels = {"fm_pairwise_vector": 1} if name != "autoint" else \
        {"flash_attention_fwd": 3, "flash_attention_bwd": 3}
    assert dispatch.LAUNCHES == {**dict.fromkeys(dispatch.LAUNCHES, 0), **kernels}
    want = cpu.train_step(data)
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=1e-6)
    got_sd, want_sd = card.model.state_dict(), cpu.model.state_dict()
    for key, w in want_sd.items():
        # a first Adam step moves a cell by about lr·sign(g): a g within the
        # sum order's noise of zero may move the other way
        assert ((got_sd[key].cpu() - w).abs() > 1e-5).float().mean() < 1e-3, key


@pytest.mark.parametrize("case", list(probe_check.ADAM_CASES))
def test_adam_stream_kernel_matches_plain_bit_for_bit(cuda, case):
    tables = probe_check.ADAM_CASES[case]
    dispatch.reset_launches()
    res = probe_check.check_adam(dispatch.adam_stream_pass_, np.random.default_rng(30), tables,
                                 cuda)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["adam_stream"] == probe_check.launches_of(tables)  # one a pass
    assert probe_check.passed(res), res
    if len(tables) == 1:  # the one-table step is the same launch
        dispatch.reset_launches()
        res = probe_check.check_adam(lambda *q: dispatch.adam_stream_step_(*(t[0] for t in q)),
                                     np.random.default_rng(30), tables, cuda)
        torch.cuda.synchronize()
        assert dispatch.LAUNCHES["adam_stream"] == 1
        assert probe_check.passed(res), res


@pytest.mark.parametrize("case", list(probe_check.PERROW_CASES))
def test_perrow_walk_kernel_matches_plain_bit_for_bit(cuda, case):
    n, w, offset = probe_check.PERROW_CASES[case]
    dispatch.reset_launches()
    res = probe_check.check_perrow(dispatch.perrow_colsum, np.random.default_rng(31), n, w,
                                   offset, cuda)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["perrow_walk"] == 1
    assert probe_check.passed(res), res


@pytest.mark.parametrize("case", list(probe_check.HOT_CASES))
def test_hot_gather_kernel_matches_plain_bit_for_bit(cuda, case):
    dispatch.reset_launches()
    res = probe_check.check_hot(dispatch.hot_gather, np.random.default_rng(32),
                                *probe_check.HOT_CASES[case], cuda)
    assert dispatch.LAUNCHES["hot_gather"] == 2  # int64 ids, then int32
    assert probe_check.passed(res), res


def test_probe_kernels_refuse_what_they_cannot_take(cuda):
    h, pack, d = probe_check.HOT_TOO_BIG
    with pytest.raises(ValueError, match="shared memory"):
        dispatch.hot_gather(torch.zeros((h, pack * d), device=cuda),
                            torch.zeros(256, dtype=torch.int32, device=cuda), pack)
    with pytest.raises(ValueError, match="1024"):
        dispatch.perrow_colsum(torch.zeros((4, 1025), device=cuda))
    with pytest.raises(ValueError, match="f32 of one shape"):
        dispatch.adam_stream_step_(*(torch.zeros(8, device=cuda) for _ in range(3)),
                                   torch.zeros(9, device=cuda))
    with pytest.raises(ValueError, match="one length"):
        dispatch.adam_stream_pass_(*([torch.zeros(8, device=cuda)] for _ in range(3)), [])
    with pytest.raises(ValueError, match="contiguous"):
        dispatch.adam_stream_pass_(*([torch.zeros(8, device=cuda)[::2]] for _ in range(4)))
    for first in ("cpu", cuda):  # a list across devices steps nothing
        other = cuda if first == "cpu" else "cpu"
        with pytest.raises(ValueError, match="every tensor must be on"):
            dispatch.adam_stream_pass_(*([torch.zeros(8, device=first),
                                          torch.zeros(8, device=other)] for _ in range(4)))


def test_perrow_walk_library_refuses_bad_plans_and_reads_the_add_latency(cuda):
    from recsys_tpu_torch.kernels import build

    lib = build.libraries()["perrow_walk"]
    stream = torch.cuda.current_stream(cuda).cuda_stream
    x, out = torch.ones((8192, 4), device=cuda), torch.empty((1, 4), device=cuda)
    # chunks of 100 rows (not whole 64-row groups), and a ring past shared memory
    for chunk_rows, stages in ((100, 6), (8192, 6)):
        assert lib.perrow_walk_launch(x.data_ptr(), out.data_ptr(), 8192, 4, chunk_rows,
                                      stages, stream) != 0
    cycles = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert lib.perrow_add_chain_cycles(x.data_ptr(), out.data_ptr(), cycles.data_ptr(), 100,
                                       stream) != 0  # not a multiple of 64
    build.check(lib.perrow_add_chain_cycles(x.data_ptr(), out.data_ptr(), cycles.data_ptr(),
                                            8192, stream), "perrow_add_chain_cycles")
    torch.cuda.synchronize()
    assert out[0, 0].item() == 8192.0  # 8192 ones, exact in f32
    assert 1.0 <= cycles.item() / 8192 < 64.0


# -- the file-fed training path: sparse kinds, device histogram, checkpoints ----
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("kind", ["lazy_adam", "rowwise_adagrad"])
def test_sparse_update_on_card_matches_cpu(cuda, kind, wd):
    """Three touched-rows steps of a 5000 x 16 table with duplicate ids (a
    thousand occurrences of row 17) on the card against the CPU:
    index_add_ sums duplicates in no fixed order on the card, so the
    other rows hold within 1e-6 and row 17, a sum of 1000 f32 terms in
    another order, within rtol 1e-4; the rows no batch touches, and
    their state, bit-unchanged on the card."""
    from recsys_tpu_torch.train import sparse_embed

    rng = np.random.default_rng(40)
    v, d = 5000, 16
    init = {"table": rng.standard_normal((v, d)).astype(np.float32),
            "m": np.zeros((v, d), np.float32), "v": np.zeros((v, d), np.float32),
            "acc": np.zeros(v, np.float32)}
    cpu = {k: torch.from_numpy(a.copy()) for k, a in init.items()}
    card = {k: torch.from_numpy(a.copy()).to(cuda) for k, a in init.items()}
    touched = set()
    for step in range(1, 4):
        rows = rng.integers(0, 3000, 4096)
        rows[:1000] = 17
        cot = rng.standard_normal((4096, d)).astype(np.float32)
        touched |= set(rows.tolist())
        for st, dev in ((cpu, "cpu"), (card, cuda)):
            r, c = torch.from_numpy(rows).to(dev), torch.from_numpy(cot).to(dev)
            if kind == "lazy_adam":
                sparse_embed.lazy_adam_update(st["table"], st["m"], st["v"], r, c, lr=1e-2,
                                              step=step, weight_decay=wd)
            else:
                sparse_embed.rowwise_adagrad_update(st["table"], st["acc"], r, c, lr=1e-2,
                                                    weight_decay=wd)
    torch.cuda.synchronize()
    keys = ("table", "m", "v") if kind == "lazy_adam" else ("table", "acc")
    untouched = torch.from_numpy(np.setdiff1d(np.arange(v), sorted(touched)))
    rest = torch.arange(v) != 17
    for k in keys:
        torch.testing.assert_close(card[k].cpu()[rest], cpu[k][rest], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(card[k].cpu()[17], cpu[k][17], rtol=1e-4, atol=1e-6)
        assert torch.equal(card[k].cpu()[untouched], torch.from_numpy(init[k])[untouched])


def test_device_histogram_on_card_matches_numpy(cuda):
    from recsys_tpu_torch.train import metrics

    rng = np.random.default_rng(41)
    s = np.concatenate([rng.random(100_000), [0.0, 1.0, -1.0, 2.0]]).astype(np.float32)
    y = (rng.random(len(s)) < 0.3).astype(np.float32)
    w = (rng.random(len(s)) < 0.95).astype(np.float32)
    pos, neg = metrics.auc_histogram_torch(*(torch.from_numpy(a).to(cuda) for a in (s, y)),
                                           8192, torch.from_numpy(w).to(cuda))
    want = metrics.auc_histogram(s, y, 8192, weights=w)
    # f32 sums of 0/1 weights below 2^24 are exact in any order
    np.testing.assert_array_equal(pos.cpu().numpy(), want[0])
    np.testing.assert_array_equal(neg.cpu().numpy(), want[1])


@pytest.mark.parametrize("opt", ["lazy_adam", "fused_adam"])
def test_checkpoint_saved_and_restored_on_card(cuda, tmp_path, opt):
    """A DLRM trained two steps on the card, saved, restored on the card
    into a fresh Trainer: the same state, bit for bit, and the same next
    step's loss."""
    from recsys_tpu_torch.train import checkpoint

    schema, data = synthetic_ctr(num_examples=3 * 512, num_dense=13, num_sparse=26,
                                 vocab_size=1000, embed_dim=16, seed=42)
    batches = [{k: v[i * 512:(i + 1) * 512] for k, v in data.items()} for i in range(3)]

    def make():
        torch.manual_seed(0)
        return Trainer(DLRM(schema, sparse_embed_grads=True, device=cuda),
                       embedding_optimizer=opt)

    saved = make()
    for b in batches[:2]:
        saved.train_step(b)
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, saved)
    restored = make()
    restored.train_step(batches[2])  # other weights and state
    checkpoint.restore(path, restored)
    assert restored.step == saved.step == 2
    for name, w in saved.model.state_dict().items():
        assert restored.model.state_dict()[name].device.type == "cuda"
        assert torch.equal(restored.model.state_dict()[name], w), name
    for name, st in saved.emb_state.items():
        for k, v in st.items():
            assert torch.equal(restored.emb_state[name][k], v), f"{name}.{k}"
    np.testing.assert_array_equal(restored.predict(batches[2]), saved.predict(batches[2]))
    torch.testing.assert_close(restored.train_step(batches[2]), saved.train_step(batches[2]),
                               rtol=1e-6, atol=1e-6)


def test_a_span_and_the_cards_trace_share_one_clock(cuda):
    """The spans stamp the clock the profiler puts the card's activity on:
    a span around a spin kernel's launch opens at or before the kernel
    starts on the card, and one that ends after a synchronize closes at or
    after the kernel ends (a device-only trace)."""
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.train import profiling

    torch.cuda.synchronize()
    with profiling.recording() as records, profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("launch"):
            torch.cuda._sleep(20_000_000)  # about 10 ms of spinning
        with profiling.span("wait"):
            torch.cuda.synchronize()
    launch, wait = records
    (k,) = [e for e in prof.profiler.kineto_results.events() if "spin_kernel" in e.name()]
    assert launch.start_ns <= k.start_ns() < k.end_ns() <= wait.end_ns
    assert k.end_ns() - k.start_ns() > 1_000_000  # the kernel spun, it was no mark
    assert launch.end_ns < k.end_ns()  # the launch returned before the kernel ended


def test_a_card_train_step_copies_the_pinned_prep_without_blocking(cuda):
    """On the card the fused prep's pinned arrays go ``non_blocking`` and
    the numpy arrays by blocking copies: the copy span counts each kind's
    bytes."""
    from recsys_tpu_torch.train import profiling

    schema, data = synthetic_ctr(num_examples=512, num_dense=13, num_sparse=26,
                                 vocab_size=1000, embed_dim=16, seed=5)
    torch.manual_seed(0)
    tt = Trainer(DLRM(schema, sparse_embed_grads=True, device=cuda),
                 embedding_optimizer="fused_adam")
    prep = tt._prep(data["sparse"])
    assert all(t.is_pinned() for t in prep.values())
    with profiling.recording() as records:
        tt.train_step(data)
    (copy,) = [r for r in records if r.name == "train_step.copy"]
    assert copy.counts == {"bytes_blocking": sum(v.nbytes for v in data.values()),
                           "bytes_async": sum(t.nbytes for t in prep.values())}
    assert [r.name for r in records].count("train_step") == 1


def test_trace_writes_the_spans_beside_the_cards_kernels(cuda, tmp_path):
    """``profiling.trace`` on the card: ``trace.json`` holds each step's
    spans and the kernels, on one time axis (a step's kernels start after
    its span opens)."""
    import json

    from recsys_tpu_torch.train import profiling

    schema, data = synthetic_ctr(num_examples=512, num_dense=13, num_sparse=26,
                                 vocab_size=1000, embed_dim=16, seed=6)
    torch.manual_seed(0)
    tt = Trainer(DLRM(schema, sparse_embed_grads=True, device=cuda),
                 embedding_optimizer="fused_adam")
    tt.train_step(data)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        tt.train_step(data)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "span"}
    assert {"train_step", "train_step.copy", "embedding.gather"} <= spans.keys()
    assert spans["train_step"]["args"]["step"] == 2
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and min(k["ts"] for k in kernels) >= spans["train_step"]["ts"]

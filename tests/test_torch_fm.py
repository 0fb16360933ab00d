"""The port's FM pieces against the JAX package on the CPU: the plain FM
bi-interaction (the ground truth of the CUDA kernel) against the jnp
reference and the Pallas kernel in interpret mode, its gradient
(``dispatch.FMPairwiseVector``) against ``jax.grad``, ``FMInteraction`` and
``SparseLinear`` (whose JAX weights are row-packed) from the same weights.
Inputs come from numpy with a seed.

Tolerances: the bi-interaction cancels, so it is held per element within
1e-5 of its terms' magnitude (Σ_f |x_fd|)² (ctr_check.py); gradients and
first-order sums are f32 sums in another order, 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctr_check
from recsys_tpu.core.features import FeatureSchema as JaxSchema
from recsys_tpu.core.features import SparseFeature as JaxSparse
from recsys_tpu.kernels import dispatch as jax_dispatch
from recsys_tpu.kernels import interactions as jax_int
from recsys_tpu.kernels.pallas.interactions_tpu import fm_pairwise_vector_pallas
from recsys_tpu.ops.embedding import SparseLinear as JaxSparseLinear
from recsys_tpu.ops.interactions import FMInteraction as JaxFMInteraction
from recsys_tpu_torch.convert import _unpack_sparse_linear, pack_factor
from recsys_tpu_torch.core.features import FeatureSchema, SparseFeature
from recsys_tpu_torch.kernels import dispatch
from recsys_tpu_torch.kernels.interactions import fm_pairwise, fm_pairwise_vector
from recsys_tpu_torch.ops.embedding import SparseLinear
from recsys_tpu_torch.ops.interactions import FMInteraction

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(b, f, d, kind="normal", seed=0):
    return ctr_check.inputs(np.random.default_rng(seed), b, f, d, torch.float32, kind, "cpu")


@pytest.mark.parametrize("kind", ctr_check.KINDS)
@pytest.mark.parametrize("b, f, d", [(64, 6, 8), (33, 1, 4), (17, 39, 16), (5, 2, 1)])
def test_plain_fm_matches_jnp_reference_and_pallas_interpret(kind, b, f, d):
    x = _x(b, f, d, kind)
    got = fm_pairwise_vector(x)
    assert got.dtype == torch.float32 and got.shape == (b, d)
    xj = jnp.asarray(x.numpy())
    for want in (jax_int.fm_pairwise_vector(xj), fm_pairwise_vector_pallas(xj, interpret=True)):
        assert ctr_check.excess(got, torch.from_numpy(np.asarray(want)), x) <= 1.0
    assert ctr_check.excess(fm_pairwise(x)[:, None], torch.from_numpy(
        np.asarray(jax_int.fm_pairwise(xj)))[:, None], x.abs().sum(2, keepdim=True)) <= 1.0


@pytest.mark.parametrize("kind", ctr_check.KINDS)
def test_plain_fm_takes_bf16_inputs_with_f32_sums(kind):
    """bf16 in, f32 sums, f32 out, as the Pallas kernel; the jnp reference
    computes in the input type, so it is run on the same values in f32."""
    x = _x(40, 26, 16, kind).bfloat16()
    got = fm_pairwise_vector(x)
    assert got.dtype == torch.float32
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    pallas = np.asarray(fm_pairwise_vector_pallas(xj, interpret=True))
    ref = np.asarray(jax_int.fm_pairwise_vector(xj.astype(jnp.float32)))
    for want in (pallas, ref):
        assert ctr_check.excess(got, torch.from_numpy(want), x) <= 1.0


def test_the_limit_rejects_the_wrong_results():
    for kind in ctr_check.KINDS:
        x = _x(64, 26, 16, kind)
        res = ctr_check.check(fm_pairwise_vector, x)
        assert res["excess"] <= 1.0 < res["wrong_least_excess"]


def test_dispatch_on_cpu_takes_the_plain_version_in_the_input_dtype():
    dispatch.reset_launches()
    x = _x(9, 5, 8)
    torch.testing.assert_close(dispatch.fm_pairwise_vector_fused(x), fm_pairwise_vector(x))
    torch.testing.assert_close(dispatch.fm_pairwise_vector(x), fm_pairwise_vector(x))
    torch.testing.assert_close(dispatch.fm_pairwise(x), fm_pairwise(x))
    xb = x.bfloat16()
    assert dispatch.fm_pairwise_vector(xb).dtype == torch.bfloat16
    torch.testing.assert_close(dispatch.fm_pairwise_vector(xb),
                               fm_pairwise_vector(xb).bfloat16())
    assert dispatch.fm_pairwise_vector_fused(x[:0]).shape == (0, 8)
    assert set(dispatch.LAUNCHES.values()) == {0}
    for bad, err in ((torch.randn(4, 5), ValueError), (torch.randn(2, 0, 4), ValueError),
                     (torch.randn(2, 3, 4).double(), TypeError)):
        with pytest.raises(err):
            dispatch.fm_pairwise_vector_fused(bad)


@pytest.mark.parametrize("b, f, d", [(16, 6, 8), (7, 39, 16), (3, 1, 4)])
def test_fm_gradient_matches_jax_grad_through_the_pallas_kernel(b, f, d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, f, d)).astype(np.float32)
    w = rng.standard_normal((b, d)).astype(np.float32)

    def loss(v):
        return jnp.sum(jax_dispatch.fm_pairwise_vector(v, interpret=True) * w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (dispatch.fm_pairwise_vector(tx) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, **TOL)
    # and through the scalar term, whose cotangent is one per column
    tx.grad = None
    dispatch.fm_pairwise(tx).sum().backward()
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax_dispatch.fm_pairwise(
        v, interpret=True)))(jnp.asarray(x)))
    np.testing.assert_allclose(tx.grad.numpy(), want, **TOL)


def test_fm_gradient_keeps_a_bf16_input_dtype():
    x = _x(4, 6, 8).bfloat16().requires_grad_()
    dispatch.fm_pairwise(x).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    xf = x.detach().float()
    want = (xf.sum(1, keepdim=True) - xf).bfloat16()
    torch.testing.assert_close(x.grad, want)


def test_fm_interaction_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 5, 8)).astype(np.float32)
    inputs = rng.random((12, 5)).astype(np.float32)
    jm = JaxFMInteraction()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"w_first": np.asarray(params["w_first"]), "bias": np.float32(0.3)}
    tm = FMInteraction(5)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    for fo in (None, inputs):
        want = jm.apply({"params": params}, jnp.asarray(x),
                        None if fo is None else jnp.asarray(fo))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), None if fo is None else torch.from_numpy(fo))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bare = FMInteraction(5, use_first_order=False)
    assert not list(bare.parameters())
    np.testing.assert_allclose(bare(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_int.fm_pairwise(jnp.asarray(x))), **TOL)


# -- SparseLinear --------------------------------------------------------------
# embed_dim 1 packs up to 128 weights to a physical row, fewer where the
# vocabulary is below 128·64: 3 -> 1, 1000 -> 8, 9000 -> 128
VOCABS = (3, 1000, 9000, 200)


@pytest.mark.parametrize("num_groups", [None, 2])
def test_sparse_linear_unpacks_and_matches_jax(num_groups):
    assert [pack_factor(1, v) for v in VOCABS[:3]] == [1, 8, 128]
    jschema = JaxSchema(sparse=[JaxSparse(f"C{i}", v, 4) for i, v in enumerate(VOCABS)])
    schema = FeatureSchema(sparse=[SparseFeature(f"C{i}", v, 4) for i, v in enumerate(VOCABS)])
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, v, 64) for v in VOCABS], 1).astype(np.int32)
    ids[0] = np.asarray(VOCABS) - 1  # the last row of every field
    jm = JaxSparseLinear(jschema, num_groups=num_groups)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    assert all(not np.asarray(p).any() for p in params.values())  # zeros, as the port's
    params = {k: rng.standard_normal(np.shape(p)).astype(np.float32) for k, p in params.items()}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))

    tm = SparseLinear(schema, num_groups=num_groups)
    assert all(not p.any() for p in tm.parameters())
    state = _unpack_sparse_linear(params, schema, "", num_groups)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(p.shape) for k, p in tm.state_dict().items()}
    tm.load_state_dict(state)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

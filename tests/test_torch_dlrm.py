"""Port DLRM (recsys_tpu_torch) against the JAX DLRM from the same weights:
the JAX params go through ``convert.params_from_jax``, and the same seeded
numpy batch goes through both.  On the CPU the JAX dot interaction takes its
jnp reference and FusedMLP its Pallas kernel in interpret mode; the port
takes its plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data.synthetic import synthetic_ctr as jax_synthetic_ctr
from recsys_tpu.models.ctr.dlrm import DLRM as JaxDLRM
from recsys_tpu_torch.convert import pack_factor, params_from_jax
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.models.ctr.dlrm import DLRM

# f32: the same math in another summation order.  bf16: the two frameworks
# may round at different places (XLA on the CPU can keep an intermediate in
# f32 where torch rounds it), which moves a logit by about one bf16 ulp,
# 2^-9 ~ 2e-3 at the logits' scale of a few tenths.
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=2e-3)}

CASES = {
    # id: (compute, fused_mlps, dense_microbatch, batch, extra options)
    "f32": ("f32", False, 1, 32, {}),
    "f32-fused": ("f32", True, 1, 32, {}),
    "bf16": ("bf16", False, 1, 32, {}),
    "bf16-fused": ("bf16", True, 1, 32, {}),
    "f32-mb4": ("f32", False, 4, 32, {}),
    "bf16-fused-mb4": ("bf16", True, 4, 32, {}),
    "f32-mb4-ragged": ("f32", False, 4, 30, {}),
    "bf16-mb4-ragged": ("bf16", True, 4, 30, {}),
    "f32-self-groups2": ("f32", False, 1, 32, dict(self_interaction=True, num_groups=2)),
    "bf16-tables": ("bf16", False, 4, 32, dict(param_dtype="bf16")),
    "f32-vocab60": ("f32", False, 1, 32, dict(vocab=60)),
    "f32-no-dense": ("f32", True, 1, 32, dict(num_dense=0)),
}


def build_pair(compute="f32", fused_mlps=False, dense_microbatch=1, *,
               self_interaction=False, num_groups=None, param_dtype="f32",
               vocab=1000, num_dense=5, num_sparse=4, embed_dim=8,
               num_examples=64, seed=0, bottom=(16, 8), top=(32, 16),
               sparse_embed_grads=False):
    """(JAX model, its params, port model loaded with them, data)."""
    kw = dict(num_examples=num_examples, num_dense=num_dense,
              num_sparse=num_sparse, vocab_size=vocab, embed_dim=embed_dim,
              seed=seed)
    jschema, data = jax_synthetic_ctr(**kw)
    schema, data_t = synthetic_ctr(**kw)
    for k in data:
        np.testing.assert_array_equal(data[k], data_t[k])
    jembed = {"num_groups": num_groups}
    tembed = {"num_groups": num_groups}
    if param_dtype == "bf16":
        jembed["param_dtype"] = jnp.bfloat16
        tembed["param_dtype"] = torch.bfloat16
    jm = JaxDLRM(jschema, bottom_units=bottom, top_units=top,
                 self_interaction=self_interaction,
                 compute_dtype=jnp.bfloat16 if compute == "bf16" else None,
                 fused_mlps=fused_mlps, dense_microbatch=dense_microbatch,
                 sparse_embed_grads=sparse_embed_grads, embed_kw=jembed)
    jbatch = {"sparse": jnp.asarray(data["sparse"][:8]),
              "dense": jnp.asarray(data["dense"][:8])}
    params = jm.init(jax.random.PRNGKey(seed), jbatch)["params"]
    tm = DLRM(schema, bottom_units=bottom, top_units=top,
              self_interaction=self_interaction,
              compute_dtype=torch.bfloat16 if compute == "bf16" else None,
              fused_mlps=fused_mlps, dense_microbatch=dense_microbatch,
              sparse_embed_grads=sparse_embed_grads, embed_kw=tembed, device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tm.load_state_dict(params_from_jax(np_params, schema, tm))
    return jm, params, tm.eval(), data


@pytest.mark.parametrize("case", list(CASES))
def test_dlrm_logits_match_jax(case):
    compute, fused, nm, b, extra = CASES[case]
    jm, params, tm, data = build_pair(compute, fused, nm, **extra)
    want = np.asarray(jm.apply({"params": params}, {
        "sparse": jnp.asarray(data["sparse"][:b]),
        "dense": jnp.asarray(data["dense"][:b])}))
    with torch.inference_mode():
        got = tm({"sparse": torch.from_numpy(data["sparse"][:b]),
                  "dense": torch.from_numpy(data["dense"][:b])}).numpy()
    assert got.dtype == np.float32 and got.shape == (b,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[compute])


def test_pack_factor_above_one_is_exercised():
    # vocab 1000 at D = 8 is stored 8 rows to a physical row by the JAX
    # package, so the default cases above go through the unpacking
    assert pack_factor(8, 1000) == 8
    _, params, tm, _ = build_pair()
    packed = np.asarray(params["StackedEmbedding_0"]["table_0"])
    assert packed.shape == (128, 64)
    np.testing.assert_array_equal(tm.embedding.table_0.detach().numpy(),
                                  packed.reshape(-1, 8)[:1000])


def test_params_from_jax_refuses_a_wrong_table_shape():
    _, params, tm, _ = build_pair()
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_params["StackedEmbedding_0"]["table_0"] = np_params[
        "StackedEmbedding_0"]["table_0"][:64]
    with pytest.raises(ValueError, match="table_0"):
        params_from_jax(np_params, tm.schema, tm)

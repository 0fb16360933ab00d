"""The port's fresh initial weights against the JAX package's, law by law.

For every ported model (DLRM with plain and fused towers, FM, DeepFM,
Wide&Deep, DeepCrossing, DCN, AutoInt, SASRec, YoutubeDNN, NCF, DIN, ESMM,
MMoE, PLE) and for ``FusedMLP``, a JAX init and a port init of the same schema are compared
parameter by parameter, after ``convert``'s layout (tables unpacked, dense
kernels transposed).  The law of each parameter is the one the JAX package
draws:

* an embedding table: flax ``uniform(scale=0.05)``, U[0, 0.05);
* a dense kernel: flax ``lecun_normal()``, a normal of sd σ = 1/√fan_in
  truncated at 2σ/0.8796 (two sd of the unscaled normal, rescaled);
* a zero-initialised leaf (biases, first-order weights): exactly 0; a
  layer norm's or batch norm's scale: exactly 1; PReLU's slope: exactly
  0.25;
* any other leaf (the normal draws of item tables, positions, dense-field
  vectors, NCF's tables, the expert banks' per-expert lecun normal):
  moments only.

Each port draw must lie inside the support of its law, and its mean and sd
must be within 6 standard errors of the JAX draw's (the errors of both
samples combined; the sd's error from each sample's own kurtosis).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.features import FeatureSchema as JaxSchema
from recsys_tpu.core.features import SparseFeature as JaxSparse
from recsys_tpu.core.features import VarLenSparseFeature as JaxVarLen
from recsys_tpu.data.synthetic import synthetic_ctr as jax_synthetic_ctr
from recsys_tpu.models.ctr.autoint import AutoInt as JaxAutoInt
from recsys_tpu.models.ctr.dcn import DCN as JaxDCN
from recsys_tpu.models.ctr.deep_crossing import DeepCrossing as JaxDeepCrossing
from recsys_tpu.models.ctr.deepfm import DeepFM as JaxDeepFM
from recsys_tpu.models.ctr.dlrm import DLRM as JaxDLRM
from recsys_tpu.models.ctr.fm import FM as JaxFM
from recsys_tpu.models.ctr.wide_deep import WideDeep as JaxWideDeep
from recsys_tpu.models.match.sasrec import SASRec as JaxSASRec
from recsys_tpu.models.match.youtube_dnn import YoutubeDNN as JaxYoutubeDNN
from recsys_tpu.models.ctr.din import DIN as JaxDIN
from recsys_tpu.models.ctr.esmm import ESMM as JaxESMM
from recsys_tpu.models.ctr.mmoe import MMoE as JaxMMoE
from recsys_tpu.models.ctr.ple import PLE as JaxPLE
from recsys_tpu.models.match.ncf import NCF as JaxNCF
from recsys_tpu.ops.mlp import FusedMLP as JaxFusedMLP
from recsys_tpu_torch.convert import (ctr_params_from_jax, din_variables_from_jax,
                                      esmm_params_from_jax, mmoe_params_from_jax,
                                      ncf_params_from_jax, ple_params_from_jax,
                                      sasrec_params_from_jax, youtube_dnn_params_from_jax)
from recsys_tpu_torch.core.features import FeatureSchema, VarLenSparseFeature
from recsys_tpu_torch.data.realistic import din_schema
from recsys_tpu_torch.data.synthetic import synthetic_ctr
from recsys_tpu_torch.models.ctr.autoint import AutoInt
from recsys_tpu_torch.models.ctr.dcn import DCN
from recsys_tpu_torch.models.ctr.deep_crossing import DeepCrossing
from recsys_tpu_torch.models.ctr.deepfm import DeepFM
from recsys_tpu_torch.models.ctr.dlrm import DLRM
from recsys_tpu_torch.models.ctr.fm import FM
from recsys_tpu_torch.models.ctr.din import DIN
from recsys_tpu_torch.models.ctr.esmm import ESMM
from recsys_tpu_torch.models.ctr.mmoe import MMoE
from recsys_tpu_torch.models.ctr.ple import PLE
from recsys_tpu_torch.models.ctr.wide_deep import WideDeep
from recsys_tpu_torch.models.match.ncf import NCF
from recsys_tpu_torch.models.match.sasrec import SASRec
from recsys_tpu_torch.models.match.youtube_dnn import YoutubeDNN
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.ops.mlp import FusedMLP

EMBED = 16
TABLE_HIGH = 0.05
TRUNC_SD = 0.87962566103423978
N_SE = 6.0
# widths large enough that every law's moments are told apart
CTR_OPTIONS = {
    "fm": (JaxFM, FM, {}),
    "deepfm": (JaxDeepFM, DeepFM, dict(hidden_units=(64, 32))),
    "widedeep": (JaxWideDeep, WideDeep, dict(hidden_units=(64, 32))),
    "deepcrossing": (JaxDeepCrossing, DeepCrossing, dict(hidden_units=(64, 64))),
    "dcn": (JaxDCN, DCN, dict(hidden_units=(64, 32))),
    "autoint": (JaxAutoInt, AutoInt, {}),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ctr_data():
    kw = dict(num_examples=16, num_dense=4, num_sparse=5, vocab_size=2000,
              embed_dim=EMBED, seed=0)
    jschema, data = jax_synthetic_ctr(**kw)
    schema, _ = synthetic_ctr(**kw)
    sample = {k: jnp.asarray(v[:8]) for k, v in data.items() if k != "label"}
    return jschema, schema, sample


def _ctr(name):
    jcls, tcls, opts = CTR_OPTIONS[name]
    jschema, schema, sample = _ctr_data()
    params = _np_tree(jcls(jschema, **opts).init(jax.random.PRNGKey(0), sample)["params"])
    tm = tcls(schema, **opts)
    return ctr_params_from_jax(params, tm), tm


def _dlrm(fused):
    jschema, schema, sample = _ctr_data()
    towers = dict(bottom_units=(64, 32), top_units=(128, 64), fused_mlps=fused)
    params = _np_tree(JaxDLRM(jschema, **towers).init(jax.random.PRNGKey(0), sample)["params"])
    tm = DLRM(schema, **towers)
    return ctr_params_from_jax(params, tm), tm


def _sasrec():
    opts = dict(num_items=3000, embed_dim=64, num_blocks=2, num_heads=2, max_len=50)
    sample = {"hist": jnp.zeros((2, 50), jnp.int32), "pos": jnp.ones((2,), jnp.int32),
              "neg": jnp.ones((2, 1), jnp.int32)}
    params = _np_tree(JaxSASRec(**opts).init(jax.random.PRNGKey(0), sample)["params"])
    tm = SASRec(**opts)
    return sasrec_params_from_jax(params, tm), tm


def _youtube():
    ni, maxlen = 3000, 20
    jschema = JaxSchema(varlen=[JaxVarLen("hist_item", ni, 32, max_len=maxlen)])
    schema = FeatureSchema(varlen=[VarLenSparseFeature("hist_item", ni, 32, max_len=maxlen)])
    opts = dict(num_items=ni, embed_dim=32, hidden_units=(128, 64))
    sample = {"hist": jnp.zeros((2, maxlen), jnp.int32), "item_id": jnp.ones((2,), jnp.int32)}
    params = _np_tree(JaxYoutubeDNN(jschema, **opts).init(jax.random.PRNGKey(0),
                                                          sample)["params"])
    tm = YoutubeDNN(schema, **opts)
    return youtube_dnn_params_from_jax(params, tm), tm


def _fused_mlp():
    dims = (96, (256, 128), 32)
    params = _np_tree(JaxFusedMLP(dims[1], dims[2]).init(
        jax.random.PRNGKey(0), jnp.zeros((4, dims[0]), jnp.float32))["params"])
    tm = FusedMLP(*dims)
    return {k: torch.from_numpy(np.array(v).reshape(getattr(tm, k).shape))
            for k, v in params.items()}, tm


def _ncf():
    sample = {"user": jnp.zeros((2,), jnp.int32), "pos_item": jnp.zeros((2,), jnp.int32),
              "neg_item": jnp.zeros((2, 3), jnp.int32)}
    params = _np_tree(JaxNCF(num_users=3000, num_items=2000).init(jax.random.PRNGKey(0),
                                                                   sample)["params"])
    tm = NCF(3000, 2000)
    return ncf_params_from_jax(params, tm), tm


def _din(activation):
    """DIN's parameters; its BatchNorm buffers start at flax's statistics
    (mean 0, var 1)."""
    vocabs, maxlen = (3000, 200), 40
    jschema = JaxSchema(
        sparse=[JaxSparse("item", vocabs[0], EMBED), JaxSparse("cate", vocabs[1], EMBED)],
        varlen=[JaxVarLen("hist_item", vocabs[0], EMBED, max_len=maxlen, shared_with="item"),
                JaxVarLen("hist_cate", vocabs[1], EMBED, max_len=maxlen, shared_with="cate")])
    sample = {"sparse": jnp.ones((4, 2), jnp.int32), "hist": jnp.ones((4, maxlen), jnp.int32),
              "hist_cate": jnp.ones((4, maxlen), jnp.int32)}
    variables = JaxDIN(jschema, ffn_activation=activation).init(jax.random.PRNGKey(0), sample)
    tm = DIN(din_schema(*vocabs, EMBED, maxlen), ffn_activation=activation)
    state = din_variables_from_jax(_np_tree(variables["params"]),
                                   _np_tree(variables["batch_stats"]), tm)
    for name, buf in tm.state_dict().items():  # the persistent buffers
        if name not in dict(tm.named_parameters()):
            assert torch.equal(buf, state.pop(name)), name
    return state, tm


def _multitask(name):
    jcls, tcls, convert = {"esmm": (JaxESMM, ESMM, esmm_params_from_jax),
                           "mmoe": (JaxMMoE, MMoE, mmoe_params_from_jax),
                           "ple": (JaxPLE, PLE, ple_params_from_jax)}[name]
    jschema, schema, sample = _ctr_data()
    kw = {"num_user_fields": 2} if name == "esmm" else {}
    params = _np_tree(jcls(jschema, **kw).init(jax.random.PRNGKey(0), sample)["params"])
    tm = tcls(schema, **kw)
    return convert(params, tm), tm


MAKERS = {"dlrm": lambda: _dlrm(False), "dlrm-fused": lambda: _dlrm(True),
            **{name: (lambda n=name: _ctr(n)) for name in CTR_OPTIONS},
            "sasrec": _sasrec, "youtube_dnn": _youtube, "fused_mlp": _fused_mlp,
            "ncf": _ncf, "din-prelu": lambda: _din("prelu"), "din-dice": lambda: _din("dice"),
            **{name: (lambda n=name: _multitask(n)) for name in ("esmm", "mmoe", "ple")}}


def _laws(model) -> dict:
    """{state-dict name: law} for the parameters whose law the module type
    names: embedding tables, dense kernels (with their fan-in)."""
    laws = {}
    for prefix, mod in model.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(mod, StackedEmbedding):
            for name, _ in mod.named_parameters(recurse=False):
                laws[dot + name] = ("uniform", 0.0, TABLE_HIGH)
        elif isinstance(mod, torch.nn.Linear):
            laws[dot + "weight"] = ("lecun", mod.in_features)
        elif isinstance(mod, FusedMLP):
            for i in range(mod.num_layers):
                laws[f"{dot}kernel_{i}"] = ("lecun", getattr(mod, f"kernel_{i}").shape[0])
    return laws


def _moment_errors(x: np.ndarray) -> tuple[float, float, float, float]:
    """(mean, sd, standard error of the mean, standard error of the sd)."""
    n = x.size
    mean, sd = float(x.mean()), float(x.std())
    kurt = float(((x - mean) ** 4).mean() / sd ** 4) if sd > 0 else 3.0
    return mean, sd, sd / np.sqrt(n), sd * np.sqrt(max(kurt - 1.0, 0.0) / (4 * n))


def _check_law(name, law, got):
    if law[0] == "uniform":
        lo, hi = law[1], law[2]
        assert got.min() >= lo and got.max() < hi, (
            f"{name}: draws in [{got.min():.4g}, {got.max():.4g}], outside [{lo}, {hi})")
    elif law[0] == "lecun":
        edge = 2.0 / np.sqrt(law[1]) / TRUNC_SD
        assert np.abs(got).max() <= edge * (1 + 1e-6), (
            f"{name}: |draw| up to {np.abs(got).max():.4g}, beyond the truncation "
            f"{edge:.4g} (fan_in {law[1]})")


@pytest.mark.parametrize("case", list(MAKERS))
def test_fresh_init_draws_the_jax_laws(case):
    torch.manual_seed(0)
    jax_state, model = MAKERS[case]()
    port_state = model.state_dict()
    params = dict(model.named_parameters())
    assert set(params) == set(jax_state), (set(params) ^ set(jax_state))
    laws = _laws(model)
    for name in params:
        got = port_state[name].detach().double().numpy().ravel()
        want = jax_state[name].double().numpy().ravel()
        assert got.size == want.size, name
        if not want.any() or (want == want[0]).all():  # zeros, a norm's ones, PReLU's 0.25
            np.testing.assert_array_equal(got, want, err_msg=f"{name}: not the constant")
            continue
        law = laws.get(name, ("normal",))
        _check_law(name, law, got)
        _check_law(f"{name} (JAX)", law, want)  # the law is the JAX one
        gm, gs, gme, gse = _moment_errors(got)
        wm, ws, wme, wse = _moment_errors(want)
        assert abs(gm - wm) <= N_SE * np.hypot(gme, wme), (
            f"{name}: mean {gm:.4g}, JAX {wm:.4g} (limit {N_SE * np.hypot(gme, wme):.3g})")
        assert abs(gs - ws) <= N_SE * np.hypot(gse, wse), (
            f"{name}: sd {gs:.4g}, JAX {ws:.4g} (limit {N_SE * np.hypot(gse, wse):.3g})")

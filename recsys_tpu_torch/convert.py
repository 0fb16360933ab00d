"""Weights and optimizer state from the JAX package's layout into the port.

``params`` is the flax ``params`` tree of a JAX model (the CTR models,
SASRec, YoutubeDNN, MIND, the two towers, FM-match, NCF, ESMM, MMoE, PLE,
the dense probe's ``DenseTail``; DIN's also takes its ``batch_stats``) as
nested dicts of numpy arrays (``np.asarray`` of each leaf; bf16 leaves may
carry numpy's ``bfloat16`` extension dtype).  Nothing here imports JAX:
the tree is plain data, and a seeded numpy tree in the same layout works
the same way.  A JAX array sharded over a mesh (the JAX package's virtual
CPU mesh included) becomes the whole numpy array under ``np.asarray``, so
sharded JAX state converts as unsharded state does;
``parallel/sharding_rules.py::shard_state`` then cuts the port's state to
one rank's shards.
"""
from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core.features import FeatureSchema
from recsys_tpu_torch.ops.embedding import group_assignment
from recsys_tpu_torch.ops.mlp import FusedMLP


def pack_factor(embed_dim: int, vocab: int | None = None) -> int:
    """Vocab rows per 128-lane physical row in the JAX package's tables
    (kept smaller for small vocabularies so a table keeps >= 64 rows)."""
    p = max(1, 128 // embed_dim)
    if vocab is not None:
        while p > 1 and vocab < p * 64:
            p //= 2
    return p


def _pad8(n: int) -> int:
    return ((n + 7) // 8) * 8


def _tensor(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _dense(tree: dict) -> dict:
    """flax Dense params -> torch Linear's: kernel (in, out) -> weight (out,
    in), and the bias where there is one."""
    out = {"weight": _tensor(tree["kernel"]).t().contiguous()}
    if "bias" in tree:
        out["bias"] = _tensor(tree["bias"])
    return out


def _tower(prefix: str, tree: dict, module) -> dict:
    out = {}
    if isinstance(module, FusedMLP):
        for i in range(module.num_layers):
            out[f"{prefix}.kernel_{i}"] = _tensor(tree[f"kernel_{i}"])
            out[f"{prefix}.bias_{i}"] = _tensor(tree[f"bias_{i}"]).reshape(1, -1)
        return out
    for i in range(len(module.layers)):
        out.update({f"{prefix}.layers.{i}.{k}": v for k, v in _dense(tree[f"Dense_{i}"]).items()})
    return out


def _unpack_tables(emb: dict, schema: FeatureSchema, num_groups: int | None,
                   prefix: str) -> dict:
    """A JAX ``StackedEmbedding``'s row-packed ``table_g``, each
    ``(_pad8(ceil(V_g / p)), p * D)``, -> the logical ``(V_g, D)`` views
    ``reshape(-1, D)[:V_g]`` under ``{prefix}table_g``."""
    d = schema.embed_dim
    _, _, group_vocab = group_assignment(schema, num_groups)
    state = {}
    for g, v in enumerate(group_vocab):
        packed = np.asarray(emb[f"table_{g}"])
        p = pack_factor(d, v)
        want = (_pad8(-(-max(v, 1) // p)), p * d)
        if packed.shape != want:
            raise ValueError(f"table_{g}: shape {packed.shape}, expected {want}")
        state[f"{prefix}table_{g}"] = _tensor(packed.reshape(-1, d)[:max(v, 1)])
    return state


def params_from_jax(params: dict, schema: FeatureSchema, model) -> dict:
    """JAX DLRM params -> the port DLRM's state dict.

    ``StackedEmbedding_0`` holds the row-packed tables (unpacked here);
    ``MLP_0``/``FusedMLP_0`` is the bottom tower when the schema has dense
    features, and the next one the top.
    """
    state = _unpack_tables(params["StackedEmbedding_0"], schema,
                           len(model.embedding.group_vocab), "embedding.")
    kind = "FusedMLP" if isinstance(model.top, FusedMLP) else "MLP"
    towers = ([("bottom", model.bottom)] if model.has_dense else []) + [("top", model.top)]
    for i, (name, module) in enumerate(towers):
        state.update(_tower(name, params[f"{kind}_{i}"], module))
    return state


def dense_tail_params_from_jax(params: dict, tail) -> dict:
    """The flax ``DenseTail``'s params (``recsys_tpu/tools/dense_probe.py``:
    ``MLP_0`` the bottom tower, ``MLP_1`` the top) -> the state dict of
    ``tools.dense_probe.DenseTail``."""
    return {**_tower("bottom", params["MLP_0"], tail.bottom),
            **_tower("top", params["MLP_1"], tail.top)}


def embedding_state_from_jax(emb_state: dict, schema: FeatureSchema, model) -> dict:
    """The JAX Trainer's embedding optimizer state (``opt_state['emb']``,
    numpy leaves) -> the port Trainer's ``emb_state``.

    Adam's ``m`` and ``v`` are packed like their tables, ``(V_phys,
    pack·D)``, and unpack with ``reshape(-1, D)[:V]``; rowwise AdaGrad's
    ``acc`` is ``(V_phys, pack)``, one value per vocab row, and unpacks
    with ``reshape(-1)[:V]``."""
    d = schema.embed_dim
    _, _, group_vocab = group_assignment(schema, len(model.embedding.group_vocab))
    out = {}
    for g, v in enumerate(group_vocab):
        name, rows = f"table_{g}", max(v, 1)
        if name not in emb_state:
            continue
        out[name] = {k: _tensor(np.asarray(a).reshape(-1, d)[:rows] if k in ("m", "v")
                                else np.asarray(a).reshape(-1)[:rows])
                     for k, a in emb_state[name].items()}
    return out


def attention_from_jax(tree: dict) -> dict:
    """flax ``MultiHeadAttention`` params (``wq``, ``wk``, ``wv`` without
    bias; ``wo`` and ``wr`` where the options made them) -> the port
    module's state dict."""
    return {f"{name}.{k}": v for name in ("wq", "wk", "wv", "wo", "wr") if name in tree
            for k, v in _dense(tree[name]).items()}


def transformer_block_from_jax(tree: dict) -> dict:
    """flax ``TransformerBlock`` params (``MultiHeadAttention_0``,
    ``LayerNorm_{0,1}/{scale,bias}``, the FFN's ``Dense_{0,1}``) -> the port
    block's state dict."""
    state = {f"attn.{k}": v for k, v in attention_from_jax(tree["MultiHeadAttention_0"]).items()}
    for j in (0, 1):
        ln = tree[f"LayerNorm_{j}"]
        state[f"ln{j}.weight"] = _tensor(ln["scale"])
        state[f"ln{j}.bias"] = _tensor(ln["bias"])
        state.update({f"ffn{j}.{k}": v for k, v in _dense(tree[f"Dense_{j}"]).items()})
    return state


def sasrec_params_from_jax(params: dict, model) -> dict:
    """JAX SASRec params -> the port SASRec's state dict: ``item_table``
    (V, D) (logical, not row-packed), ``pos_emb/pos`` (max_len, D) and one
    ``blocks_i`` tree per block."""
    state = {"item_table": _tensor(params["item_table"]),
             "pos_emb.pos": _tensor(params["pos_emb"]["pos"])}
    for i in range(len(model.blocks)):
        state.update({f"blocks.{i}.{k}": v
                      for k, v in transformer_block_from_jax(params[f"blocks_{i}"]).items()})
    return state


def youtube_dnn_params_from_jax(params: dict, model) -> dict:
    """JAX YoutubeDNN params -> the port YoutubeDNN's state dict: the user
    tables (``user_table/table_g``, one per owner field, row-packed)
    unpacked, ``item_table`` (num_items, D) as it is, and ``user_mlp``'s
    ``Dense_i`` kernels transposed."""
    state = _unpack_tables(params["user_table"], model.schema, None, "user_table.")
    state["item_table"] = _tensor(params["item_table"])
    state.update(_tower("user_mlp", params["user_mlp"], model.user_mlp))
    return state


def _unpack_sparse_linear(tree: dict, schema: FeatureSchema, prefix: str,
                          num_groups: int | None = None) -> dict:
    """A JAX ``SparseLinear``'s row-packed ``w_g``, each ``(_pad8(ceil(V_g /
    p)), p)`` with ``p = pack_factor(1, V_g)``, -> the logical ``(V_g, 1)``
    ``{prefix}w_g``."""
    _, _, group_vocab = group_assignment(schema, num_groups)
    state = {}
    for g, v in enumerate(group_vocab):
        packed = np.asarray(tree[f"w_{g}"])
        p = pack_factor(1, v)
        want = (_pad8(-(-max(v, 1) // p)), p)
        if packed.shape != want:
            raise ValueError(f"w_{g}: shape {packed.shape}, expected {want}")
        state[f"{prefix}w_{g}"] = _tensor(packed.reshape(-1, 1)[:max(v, 1)])
    return state


def ctr_params_from_jax(params: dict, model) -> dict:
    """JAX CTR model params (FM, DeepFM, WideDeep, DeepCrossing, DCN,
    AutoInt, DLRM) -> the port model's state dict.

    The flax submodules map onto the port's attributes:
    ``StackedEmbedding_0`` -> ``embedding`` (tables unpacked),
    ``SparseLinear_0`` -> ``linear`` (weights unpacked), ``MLP_0`` ->
    ``mlp``, ``Dense_0`` -> ``out``, ``LinearLogit_0`` -> ``wide``,
    ``CrossNetwork_0`` -> ``cross``, ``ResidualUnit_i`` -> ``residual.i``
    and ``MultiHeadAttention_i`` -> ``attention.i``; the leaves ``bias``,
    ``v_dense`` and ``w_dense`` keep their names.  DLRM goes through
    :func:`params_from_jax`."""
    from recsys_tpu_torch.models.ctr.dlrm import DLRM

    if isinstance(model, DLRM):
        return params_from_jax(params, model.schema, model)
    state = {}
    for name, tree in params.items():
        kind, _, index = name.rpartition("_")
        if name == "StackedEmbedding_0":
            state.update(_unpack_tables(tree, model.schema,
                                        len(model.embedding.group_vocab), "embedding."))
        elif name == "SparseLinear_0":
            state.update(_unpack_sparse_linear(tree, model.schema, "linear."))
        elif name == "MLP_0":
            state.update(_tower("mlp", tree, model.mlp))
        elif name == "Dense_0":
            state.update({f"out.{k}": v for k, v in _dense(tree).items()})
        elif name == "LinearLogit_0":
            state.update({f"wide.dense.{k}": v for k, v in _dense(tree["Dense_0"]).items()})
        elif name == "CrossNetwork_0":
            state.update({f"cross.{k}": _tensor(v) for k, v in tree.items()})
        elif kind == "ResidualUnit":
            for j in (0, 1):
                state.update({f"residual.{index}.dense{j}.{k}": v
                              for k, v in _dense(tree[f"Dense_{j}"]).items()})
        elif kind == "MultiHeadAttention":
            state.update({f"attention.{index}.{k}": v
                          for k, v in attention_from_jax(tree).items()})
        elif name in ("bias", "v_dense", "w_dense"):
            state[name] = _tensor(tree)
        else:
            raise ValueError(f"no counterpart in the port for the flax params {name!r}")
    return state


def two_tower_params_from_jax(params: dict, model) -> dict:
    """JAX ``TwoTower`` (DSSM, SENet-DSSM) params -> the port model's state
    dict: ``user_table``/``item_table`` unpacked, ``user_mlp``/``item_mlp``
    and, with SENet, ``user_se``/``item_se`` (``Dense_0``, ``Dense_1`` ->
    ``dense0``, ``dense1``) transposed."""
    state = {}
    for side in ("user", "item"):
        schema = model.sparse_schemas[f"{side}_sparse"]
        state.update(_unpack_tables(params[f"{side}_table"], schema, None, f"{side}_table."))
        state.update(_tower(f"{side}_mlp", params[f"{side}_mlp"], getattr(model, f"{side}_mlp")))
        if model.use_senet:
            for j in (0, 1):
                state.update({f"{side}_se.dense{j}.{k}": v
                              for k, v in _dense(params[f"{side}_se"][f"Dense_{j}"]).items()})
    return state


def fm_match_params_from_jax(params: dict, model) -> dict:
    """JAX ``FMMatch`` params -> the port model's state dict: both towers'
    tables and ``SparseLinear`` weights unpacked."""
    state = {}
    for side in ("user", "item"):
        schema = model.sparse_schemas[f"{side}_sparse"]
        state.update(_unpack_tables(params[f"{side}_table"], schema, None, f"{side}_table."))
        state.update(_unpack_sparse_linear(params[f"{side}_linear"], schema, f"{side}_linear."))
    return state


def mind_params_from_jax(params: dict, model) -> dict:
    """JAX ``MIND`` params -> the port model's state dict: ``item_table``
    (num_items, D) as it is, ``routing/S`` and ``user_mlp``'s ``Dense_i``
    kernels transposed."""
    state = {"item_table": _tensor(params["item_table"]),
             "routing.S": _tensor(params["routing"]["S"])}
    state.update(_tower("user_mlp", params["user_mlp"], model.user_mlp))
    return state


def ncf_params_from_jax(params: dict, model) -> dict:
    """JAX ``NCF`` params -> the port model's state dict: the four tables
    (``user_gmf``, ``item_gmf``, ``user_mlp``, ``item_mlp``) as they are,
    ``mlp``'s ``Dense_i`` and ``head`` transposed."""
    state = {k: _tensor(params[k]) for k in ("user_gmf", "item_gmf", "user_mlp", "item_mlp")}
    state.update(_tower("mlp", params["mlp"], model.mlp))
    state.update({f"head.{k}": v for k, v in _dense(params["head"]).items()})
    return state


def _batch_norm(prefix: str, params: dict | None, stats: dict) -> dict:
    """A flax ``BatchNorm``'s ``scale``/``bias`` (where ``params`` has them)
    and its ``batch_stats`` ``mean``/``var`` -> the port ``BatchNorm``'s."""
    state = {f"{prefix}.{k}": _tensor(v) for k, v in (params or {}).items()}
    state.update({f"{prefix}.{k}": _tensor(stats[k]) for k in ("mean", "var")})
    return state


def din_variables_from_jax(params: dict, batch_stats: dict, model) -> dict:
    """JAX ``DIN`` variables (``params`` and ``batch_stats``) -> the port
    model's state dict, buffers included: ``StackedEmbedding_0`` ->
    ``embedding`` (unpacked), ``TargetAttention_0`` -> ``attention``,
    ``BatchNorm_0`` -> ``bn``, ``Dense_i`` -> ``ffn.i``, ``PReLU_i`` or
    ``Dice_i`` -> ``acts.i`` (a Dice's ``BatchNorm_0`` statistics ->
    ``acts.i.bn``)."""
    state = _unpack_tables(params["StackedEmbedding_0"], model.schema,
                           len(model.embedding.group_vocab), "embedding.")
    state.update(_tower("attention", params["TargetAttention_0"], model.attention))
    state.update(_batch_norm("bn", params["BatchNorm_0"], batch_stats["BatchNorm_0"]))
    for i in range(len(model.ffn)):
        state.update({f"ffn.{i}.{k}": v for k, v in _dense(params[f"Dense_{i}"]).items()})
    for i in range(len(model.acts)):
        if f"Dice_{i}" in params:
            state[f"acts.{i}.alpha"] = _tensor(params[f"Dice_{i}"]["alpha"])
            state.update(_batch_norm(f"acts.{i}.bn", None,
                                     batch_stats[f"Dice_{i}"]["BatchNorm_0"]))
        else:
            state[f"acts.{i}.alpha"] = _tensor(params[f"PReLU_{i}"]["alpha"])
    return state


def esmm_params_from_jax(params: dict, model) -> dict:
    """JAX ``ESMM`` params -> the port model's state dict:
    ``StackedEmbedding_0`` -> ``embedding`` (unpacked), ``MLP_0`` ..
    ``MLP_3`` -> ``user_mlp``, ``item_mlp``, ``ctr_head``, ``cvr_head``."""
    state = _unpack_tables(params["StackedEmbedding_0"], model.schema,
                           len(model.embedding.group_vocab), "embedding.")
    for i, name in enumerate(("user_mlp", "item_mlp", "ctr_head", "cvr_head")):
        state.update(_tower(name, params[f"MLP_{i}"], getattr(model, name)))
    return state


def mmoe_params_from_jax(params: dict, model) -> dict:
    """JAX ``MMoE`` or ``PLE`` params -> the port model's state dict:
    ``StackedEmbedding_0`` -> ``embedding`` (unpacked); an expert bank's
    ``w{i}``/``b{i}`` as they are, MMoE's ``ExpertBank_0`` -> ``experts``
    and PLE's ``l{level}_experts_{task|shared}`` -> ``experts.<name>``; a
    gate's kernel transposed, ``gate_{task}`` and PLE's
    ``l{level}_gate_{task|shared}`` -> ``gates.<name>.dense``;
    ``tower_{task}`` -> ``towers.tower_{task}``."""
    state = {}
    for name, tree in params.items():
        if name == "StackedEmbedding_0":
            state.update(_unpack_tables(tree, model.schema, len(model.embedding.group_vocab),
                                        "embedding."))
        elif name == "ExpertBank_0" or "_experts_" in name:
            key = "experts" if name == "ExpertBank_0" else f"experts.{name}"
            state.update({f"{key}.{k}": _tensor(v) for k, v in tree.items()})
        elif "gate_" in name:
            state[f"gates.{name}.dense.weight"] = _dense(tree["Dense_0"])["weight"]
        elif name.startswith("tower_"):
            state.update(_tower(f"towers.{name}", tree, model.towers[name]))
        else:
            raise ValueError(f"no counterpart in the port for the flax params {name!r}")
    return state


ple_params_from_jax = mmoe_params_from_jax

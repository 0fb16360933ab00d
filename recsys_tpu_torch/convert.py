"""Weights and optimizer state from the JAX package's layout into the port.

``params`` is the flax ``params`` tree of the JAX DLRM as nested dicts of
numpy arrays (``np.asarray`` of each leaf; bf16 leaves may carry numpy's
``bfloat16`` extension dtype).  Nothing here imports JAX: the tree is plain
data, and a seeded numpy tree in the same layout works the same way.
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


def _tower(prefix: str, tree: dict, module) -> dict:
    out = {}
    if isinstance(module, FusedMLP):
        for i in range(module.num_layers):
            out[f"{prefix}.kernel_{i}"] = _tensor(tree[f"kernel_{i}"])
            out[f"{prefix}.bias_{i}"] = _tensor(tree[f"bias_{i}"]).reshape(1, -1)
        return out
    for i in range(len(module.layers)):
        dense = tree[f"Dense_{i}"]
        # flax Dense.kernel is (in, out); torch Linear.weight is (out, in)
        out[f"{prefix}.layers.{i}.weight"] = _tensor(dense["kernel"]).t().contiguous()
        out[f"{prefix}.layers.{i}.bias"] = _tensor(dense["bias"])
    return out


def params_from_jax(params: dict, schema: FeatureSchema, model) -> dict:
    """JAX DLRM params -> the port DLRM's state dict.

    ``StackedEmbedding_0/table_g`` is the row-packed
    ``(_pad8(ceil(V_g / p)), p * D)`` table; its logical ``(V_g, D)`` view
    is ``reshape(-1, D)[:V_g]``.  ``MLP_0``/``FusedMLP_0`` is the bottom
    tower when the schema has dense features, and the next one the top.
    """
    d = schema.embed_dim
    emb = params["StackedEmbedding_0"]
    num_groups = len(model.embedding.group_vocab)
    _, _, group_vocab = group_assignment(schema, num_groups)
    state = {}
    for g, v in enumerate(group_vocab):
        packed = np.asarray(emb[f"table_{g}"])
        p = pack_factor(d, v)
        want = (_pad8(-(-max(v, 1) // p)), p * d)
        if packed.shape != want:
            raise ValueError(f"table_{g}: shape {packed.shape}, expected {want}")
        state[f"embedding.table_{g}"] = _tensor(packed.reshape(-1, d)[:max(v, 1)])
    kind = "FusedMLP" if isinstance(model.top, FusedMLP) else "MLP"
    towers = ([("bottom", model.bottom)] if model.has_dense else []) + [("top", model.top)]
    for i, (name, module) in enumerate(towers):
        state.update(_tower(name, params[f"{kind}_{i}"], module))
    return state


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

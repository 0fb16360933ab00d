"""Serving export (the port's copy of ``recsys_tpu/train/export.py``): the
catalog's item embeddings, with an optional id map, in one ``.npz`` that a
serving process loads into a ``BruteForceIndex``.

The payload is the JAX package's: ``embeddings`` (N, D) float32, optional
``item_ids``, and ``metadata`` as the bytes of a JSON object, written with
``np.savez_compressed``; a file written by either package loads in the
other.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from recsys_tpu_torch.train.retrieval import BruteForceIndex


def export_item_embeddings(path: str, item_embs, item_ids=None,
                           metadata: dict | None = None) -> None:
    """Write (N, D) item embeddings (a tensor on any device, or an array)
    and optional external ids to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if isinstance(item_embs, torch.Tensor):
        item_embs = item_embs.detach().float().cpu().numpy()
    payload = {"embeddings": np.asarray(item_embs, np.float32)}
    if item_ids is not None:
        payload["item_ids"] = np.asarray(item_ids)
    payload["metadata"] = np.frombuffer(json.dumps(metadata or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **payload)


def load_item_embeddings(path: str):
    """Returns (embeddings (N, D), item_ids or None, metadata dict)."""
    with np.load(path, allow_pickle=False) as z:
        embs = z["embeddings"]
        ids = z["item_ids"] if "item_ids" in z.files else None
        meta = json.loads(bytes(z["metadata"]).decode() or "{}")
    return embs, ids, meta


def build_index(path: str, normalize: bool = False, device=None):
    """Load an exported snapshot into a ready ``BruteForceIndex`` on
    ``device`` (the card unless the caller names another); returns (index,
    item_ids or None, metadata)."""
    embs, ids, meta = load_item_embeddings(path)
    index = BruteForceIndex(embs.shape[1], normalize=normalize, device=device)
    index.add(embs)
    return index, ids, meta

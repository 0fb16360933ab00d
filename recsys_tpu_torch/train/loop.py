"""Trainer: the serving surface (``predict``, ``evaluate_auc``).

Batches are cut on the host at a fixed size; the last one is padded by
repeating its last row, and the padding rows are dropped from the outputs.
Batch assembly runs on the prefetch thread, ahead of the device.  Every
forward runs under ``torch.inference_mode()``.  Training (``fit``) comes
with the backward kernels.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from recsys_tpu_torch.data.prefetch import prefetch
from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.train import metrics as metrics_lib


def _num_examples(data: dict) -> int:
    return len(next(iter(data.values())))


class Trainer:
    """Runs ``model`` (whose ``forward(batch)`` returns per-example outputs)
    on ``device``: ``cuda`` unless the caller passes another; with no card
    and no explicit device this raises."""

    def __init__(self, model: torch.nn.Module, device=None):
        self.device = default_device(device)
        self.model = model.to(self.device)
        schema = getattr(model, "schema", None)
        self._vocab = (
            np.asarray([f.vocab_size for f in schema.sparse])
            if schema is not None and schema.sparse else None
        )

    def _batches(self, data: dict, batch_size: int):
        """Yield (host batch, number of real rows)."""
        n = _num_examples(data)
        for s in range(0, n, batch_size):
            batch = {k: v[s:s + batch_size] for k, v in data.items()}
            valid = len(next(iter(batch.values())))
            pad = batch_size - valid
            if pad > 0:
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                         for k, v in batch.items()}
            if self._vocab is not None and "sparse" in batch:
                # an id outside its table would fault the device gather
                ids = batch["sparse"]
                if (ids < 0).any() or (ids >= self._vocab).any():
                    raise ValueError(f"sparse ids outside their vocabularies "
                                     f"in rows {s}..{s + valid}")
            yield batch, valid

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items() if not k.startswith("_")}

    def predict(self, data: dict, batch_size: int = 4096,
                consumer: Callable | None = None):
        """Forward pass over a dataset; returns the stacked outputs as a
        numpy array with exactly one row per example.

        ``consumer(outputs, start)`` -- if given, each batch's host outputs
        (padding rows dropped; ``start`` is the dataset offset) are handed
        over as they arrive and nothing is accumulated (returns None)."""
        self.model.eval()
        outs, start = [], 0
        with torch.inference_mode():
            for batch, valid in prefetch(self._batches(data, batch_size)):
                out = self.model(self._to_device(batch))[:valid].cpu().numpy()
                if consumer is not None:
                    consumer(out, start)
                else:
                    outs.append(out)
                start += valid
        if consumer is not None:
            return None
        return np.concatenate(outs, axis=0)

    def evaluate_auc(self, data: dict, batch_size: int = 4096,
                     label_key: str = "label", from_logits: bool = True) -> float:
        """Binned AUC (8192 bins) of the predictions against
        ``data[label_key]``."""
        preds = self.predict(data, batch_size)
        scores = torch.sigmoid(torch.from_numpy(preds)).numpy() if from_logits else preds
        return metrics_lib.auc(scores, data[label_key])

"""Trainer: training (``fit``, ``train_step``, ``evaluate_loss``) and serving
(``predict``, ``evaluate_auc``).

Batches are cut on the host at a fixed size.  Training shuffles every
epoch and drops the remainder; evaluation pads the last batch by repeating
its last row and drops the padding from its outputs.  Batch assembly, id
validation and the fused embedding optimizers' host prep run on the
prefetch thread, ahead of the device.  Serving runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from recsys_tpu_torch.data.prefetch import prefetch
from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.train import losses as losses_lib
from recsys_tpu_torch.train import metrics as metrics_lib
from recsys_tpu_torch.train import sparse_embed, streaming_embed

# embedding optimizers of the JAX package that the port does not have yet
NOT_PORTED = ("lazy_adam", "rowwise_adagrad")
FUSED = {"fused_adam": "adam", "fused_rowwise_adagrad": "rowwise_adagrad"}


def _num_examples(data: dict) -> int:
    return len(next(iter(data.values())))


def default_loss(outputs: torch.Tensor, batch: dict) -> torch.Tensor:
    """BCE-with-logits on ``batch['label']``."""
    return losses_lib.bce_with_logits(outputs, batch["label"])


class Trainer:
    """Trains and runs ``model`` (whose ``forward(batch)`` returns
    per-example outputs, consumed by ``loss_fn(outputs, batch)``) on
    ``device``: ``cuda`` unless the caller passes another; with no card and
    no explicit device this raises.

    Dense parameters train with ``torch.optim.Adam`` (``AdamW`` when
    ``weight_decay`` > 0: decoupled decay, as ``optax.adamw``).
    ``embedding_optimizer`` takes the ``StackedEmbedding`` tables off that
    path (the model must be built with ``sparse_embed_grads=True``):

    * ``None`` -- the tables train through autograd and dense Adam;
    * ``'fused_adam'`` -- exact dense Adam through the fused
      embedding-update kernel, one launch per table and step;
    * ``'fused_rowwise_adagrad'`` -- rowwise AdaGrad through the same
      kernel's sibling.

    ``embedding_lr`` defaults to ``learning_rate``;
    ``embedding_fused_bf16`` rounds the table cotangent to bf16 before it
    is summed (pairs with bf16 compute), else the sum is exact f32.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable = default_loss,
                 learning_rate: float = 1e-3, weight_decay: float = 0.0, seed: int = 0,
                 embedding_optimizer: str | None = None,
                 embedding_lr: float | None = None,
                 embedding_fused_bf16: bool = True, device=None):
        if embedding_optimizer in NOT_PORTED:
            raise ValueError(f"embedding_optimizer={embedding_optimizer!r} is not "
                             "ported yet (ROADMAP.md Queue 1 item 5)")
        if embedding_optimizer is not None and embedding_optimizer not in FUSED:
            raise ValueError(f"embedding_optimizer={embedding_optimizer!r} not in "
                             f"{(None, *FUSED)}")
        self.device = default_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.embedding_optimizer = embedding_optimizer
        self.embedding_lr = learning_rate if embedding_lr is None else embedding_lr
        self.embedding_fused_bf16 = embedding_fused_bf16
        self.step = 0  # optimizer steps taken; the next one is step + 1
        self._shuffle_rng = np.random.default_rng(seed)
        schema = getattr(model, "schema", None)
        self._vocab = (
            np.asarray([f.vocab_size for f in schema.sparse])
            if schema is not None and schema.sparse else None
        )
        self.embedding, self.plan, self.emb_state, self._prep = None, None, None, None
        if embedding_optimizer is not None:
            taps = [m for m in model.modules()
                    if isinstance(m, StackedEmbedding) and m.perturb_out]
            if len(taps) != 1:
                raise ValueError(
                    "embedding_optimizer requires exactly one StackedEmbedding "
                    "perturbation tap; construct the model with "
                    f"sparse_embed_grads=True (found {len(taps)} taps)")
            self.embedding = taps[0]
            self.plan = sparse_embed.build_plan(self.embedding)
            for name in self.plan.table_names:
                getattr(self.embedding, name).requires_grad_(False)
            kind = FUSED[embedding_optimizer]
            self.emb_state = sparse_embed.init_state(
                self.tables(), "lazy_adam" if kind == "adam" else kind)
            self._prep = streaming_embed.make_host_prep(self.plan)
        params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = (
            torch.optim.AdamW(params, lr=learning_rate, weight_decay=weight_decay)
            if weight_decay > 0.0 else torch.optim.Adam(params, lr=learning_rate))

    def tables(self) -> dict:
        """{table name: tensor} of the tables the fused optimizer updates."""
        return {name: getattr(self.embedding, name).data for name in self.plan.table_names}

    # -- data plumbing ----------------------------------------------------
    def _batches(self, data: dict, batch_size: int, order: np.ndarray | None = None,
                 drop_remainder: bool = False, prep: Callable | None = None):
        """Yield (host batch, number of real rows), the rows taken in
        ``order`` (default: as stored); a short last batch is dropped or
        padded by repeating its last row."""
        n = _num_examples(data)
        end = n - n % batch_size if drop_remainder else n
        for s in range(0, end, batch_size):
            sel = slice(s, s + batch_size) if order is None else order[s:s + batch_size]
            batch = {k: v[sel] for k, v in data.items()}
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
            if prep is not None:
                batch.update(prep(batch["sparse"]))
            yield batch, valid

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items() if not k.startswith("_")}

    # -- training ---------------------------------------------------------
    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a host batch (numpy arrays; the fused
        embedding optimizers' host prep is added when missing).  Returns
        the loss as a device scalar, without waiting for it."""
        if self._prep is not None and "embaux0_ids" not in batch:
            batch = dict(batch, **self._prep(batch["sparse"]))
        db = self._to_device(batch)
        self.model.train()
        self.step += 1
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model(db), db)
        loss.backward()
        self.optimizer.step()
        if self.embedding is not None:
            streaming_embed.apply_updates_fused(
                self.tables(), self.emb_state, self.plan, db, self.embedding.tap.grad,
                lr=self.embedding_lr, step=self.step, weight_decay=self.weight_decay,
                kind=FUSED[self.embedding_optimizer], mm_bf16=self.embedding_fused_bf16)
            self.embedding.tap = None
        return loss.detach()

    def fit(self, train_data: dict, batch_size: int = 512, epochs: int = 10,
            val_data: dict | None = None, validation_split: float = 0.0,
            verbose: bool = True) -> dict:
        """Train on a dict of aligned numpy arrays (with the label key).

        Each epoch reshuffles (a numpy generator seeded by ``seed``) and
        drops the remainder; a batch larger than the data is clamped to it.
        ``validation_split`` holds out the dataset's tail when ``val_data``
        is not given.  The loss adds up on the device and is read once per
        epoch.  Returns ``{'loss': [...], 'val_loss': [...]}``."""
        if validation_split > 0.0 and val_data is None:
            cut = int(_num_examples(train_data) * (1.0 - validation_split))
            val_data = {k: v[cut:] for k, v in train_data.items()}
            train_data = {k: v[:cut] for k, v in train_data.items()}
        n = _num_examples(train_data)
        if n == 0:
            raise ValueError("empty training dataset")
        batch_size = min(batch_size, n)
        history = {"loss": [], "val_loss": []}
        for epoch in range(epochs):
            order = np.arange(n)
            self._shuffle_rng.shuffle(order)
            total, count = None, 0
            for batch, _ in prefetch(self._batches(train_data, batch_size, order, True,
                                                   self._prep)):
                loss = self.train_step(batch)
                total = loss if total is None else total + loss
                count += 1
            history["loss"].append(float(total) / count)
            msg = f"epoch {epoch + 1}/{epochs} loss={history['loss'][-1]:.5f}"
            if val_data is not None:
                history["val_loss"].append(self.evaluate_loss(val_data, batch_size))
                msg += f" val_loss={history['val_loss'][-1]:.5f}"
            if verbose:
                print(msg)
        return history

    def evaluate_loss(self, data: dict, batch_size: int = 4096) -> float:
        """Mean loss over the whole dataset, added up on the device.  The
        padded tail is corrected exactly for a loss that is a mean of
        per-example terms: ``sum_valid = L_pad·B - pad·L_tile``, with
        ``L_tile`` the loss of a batch holding only the repeated row."""
        self.model.eval()
        total, n = None, 0
        with torch.inference_mode():
            for batch, valid in prefetch(self._batches(data, batch_size)):
                db = self._to_device(batch)
                part = self.loss_fn(self.model(db), db) * batch_size
                if valid < batch_size:
                    tiled = {k: v[-1:].expand_as(v).contiguous() for k, v in db.items()}
                    part = part - self.loss_fn(self.model(tiled), tiled) * (batch_size - valid)
                total = part if total is None else total + part
                n += valid
        return float(total) / n if n else 0.0

    # -- serving ----------------------------------------------------------
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

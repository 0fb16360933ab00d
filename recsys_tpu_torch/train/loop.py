"""Trainer: training (``fit``, ``train_step``, ``evaluate_loss``) and serving
(``predict``, ``evaluate_auc``).

Batches are cut on the host at a fixed size, or come from a stream (a
re-iterable object such as ``data.streaming.CriteoStream``, or a
zero-argument callable returning an iterator).  Training shuffles every
epoch and drops the remainder; evaluation pads the last batch by repeating
its last row and drops the padding from its outputs.  Batch assembly, id
validation and the fused embedding optimizers' host prep run on the
prefetch thread, ahead of the device.  Serving runs under
``torch.inference_mode()``.

``train_step`` opens the program's spans (``train/profiling.py``), which
record only inside ``profiling.recording()`` or ``profiling.trace``: one
``train_step`` root a step, its ``step`` the optimizer step it takes, over
``train_step.prep`` (the fused optimizers' host prep, where it runs: inside
the call for a bare batch, on the prefetch thread under ``fit``),
``train_step.copy`` (``_to_device``, counting ``bytes_blocking``, the
numpy arrays' pageable copies, and ``bytes_async``, the prep's
``non_blocking`` ones), ``train_step.forward`` (the model and the loss;
``embedding.gather`` inside it), ``train_step.backward`` (with the
gradients' sum on a mesh), ``train_step.dense_adam`` (``zero_grad``, then
``optimizer.step()``) and ``train_step.embed_update`` (the embedding
optimizer).

On a (data, model) mesh (``parallel/mesh.py``) a Trainer runs in each
process of the group, one device each.  Tables whose rows the model axis
divides hold this rank's row shard; every other parameter is replicated
(made equal from rank 0 at the start).  Each rank computes the loss of its
data shard's rows; the gradients are the gradients of the mean loss over
the GLOBAL batch: a replicated parameter's and a table shard's are summed
over the data axis, and the embedding optimizers take the global batch's
cotangent.
"""
from __future__ import annotations

import json
import time
from typing import Callable

import numpy as np
import torch

from recsys_tpu_torch.data.prefetch import prefetch
from recsys_tpu_torch.kernels import default_device
from recsys_tpu_torch.ops.attention import Dropout
from recsys_tpu_torch.ops.embedding import StackedEmbedding
from recsys_tpu_torch.parallel import mesh as mesh_lib
from recsys_tpu_torch.parallel.sharding_rules import apply_param_shardings
from recsys_tpu_torch.train import losses as losses_lib
from recsys_tpu_torch.train import metrics as metrics_lib
from recsys_tpu_torch.train import profiling
from recsys_tpu_torch.train import sparse_embed, streaming_embed
from recsys_tpu_torch.train.checkpoint import BestCheckpointer

FUSED = {"fused_adam": "adam", "fused_rowwise_adagrad": "rowwise_adagrad"}
EMBEDDING_OPTIMIZERS = (*sparse_embed.KINDS, *FUSED)
AUC_BINS = 8192


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
    ``weight_decay`` > 0: decoupled decay, as ``optax.adamw``).  Dropout
    draws from ``self.generator``, seeded from ``seed`` on ``device``.
    ``embedding_optimizer`` takes the ``StackedEmbedding`` tables off that
    path (the model must be built with ``sparse_embed_grads=True``):

    * ``None`` -- the tables train through autograd and dense Adam;
    * ``'lazy_adam'``, ``'rowwise_adagrad'`` -- touched-rows updates in
      torch ops (``sparse_embed.apply_updates``);
    * ``'fused_adam'`` -- exact dense Adam through the fused
      embedding-update kernel, one launch a step over every table;
    * ``'fused_rowwise_adagrad'`` -- rowwise AdaGrad through the same
      kernel's sibling.

    ``embedding_lr`` defaults to ``learning_rate``;
    ``embedding_fused_bf16`` rounds the table cotangent to bf16 before it
    is summed (pairs with bf16 compute), else the sum is exact f32.

    ``mesh`` (``parallel.mesh.make_mesh``) trains on the (data, model)
    mesh of the process group; every rank calls the same methods with the
    same arguments, under ``data_contract``:

    * ``'global'`` -- every rank passes the global arrays (and the global
      ``batch_size``) and keeps its data shard's rows; the contract of
      ``predict``;
    * ``'local'`` -- each rank passes only the rows of its data shard (the
      ranks of one data row the same rows; ``batch_size`` stays global),
      and the fused optimizers' host prep sorts only those.  ``predict``
      refuses it on more than one process, as the JAX package's does.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable = default_loss,
                 learning_rate: float = 1e-3, weight_decay: float = 0.0, seed: int = 0,
                 embedding_optimizer: str | None = None,
                 embedding_lr: float | None = None,
                 embedding_fused_bf16: bool = True, device=None, mesh=None,
                 data_contract: str = "global"):
        if embedding_optimizer is not None and embedding_optimizer not in EMBEDDING_OPTIMIZERS:
            raise ValueError(f"embedding_optimizer={embedding_optimizer!r} not in "
                             f"{(None, *EMBEDDING_OPTIMIZERS)}")
        if data_contract not in ("global", "local"):
            raise ValueError(f"data_contract={data_contract!r} not in ('global', 'local')")
        self.device = default_device(device)
        self.model = model.to(self.device)
        self.mesh, self.data_contract = mesh, data_contract
        self._n_data = mesh.size(mesh_lib.DATA_AXIS) if mesh is not None else 1
        self.table_shards = {}  # {table parameter: its model shards} on a mesh
        if mesh is not None:
            self.table_shards = apply_param_shardings(self.model, mesh)
            with torch.no_grad():  # replicas start equal: rank 0's, a shard its column's
                for name, t in [*self.model.named_parameters(), *self.model.named_buffers()]:
                    sharded = self.table_shards.get(name, 1) > 1
                    mesh_lib.broadcast_(t.data, mesh, mesh_lib.DATA_AXIS if sharded else None)
        self._a2a = [m for m in self.model.modules() if isinstance(m, StackedEmbedding)
                     and m.engine.startswith("a2a")]
        self.last_dropped = None  # the a2a engines' dropped ids of the last step
        self.loss_fn = loss_fn
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.embedding_optimizer = embedding_optimizer
        self.embedding_lr = learning_rate if embedding_lr is None else embedding_lr
        self.embedding_fused_bf16 = embedding_fused_bf16
        self.step = 0  # optimizer steps taken; the next one is step + 1
        self._shuffle_rng = np.random.default_rng(seed)
        # {batch key: its fields' vocabularies}: a model's ``schema`` serves
        # ``sparse_key`` (default 'sparse'); a two-tower model names a schema
        # a key in ``sparse_schemas``
        schemas = getattr(model, "sparse_schemas", None)
        if schemas is None and getattr(model, "schema", None) is not None:
            schemas = {getattr(model, "sparse_key", "sparse"): model.schema}
        self._vocabs = {key: np.asarray([f.vocab_size for f in s.sparse])
                        for key, s in (schemas or {}).items() if s.sparse}
        # {batch key: vocabulary} of a model's other id inputs (SASRec's
        # items, NCF's users and items, DIN's history): each id must index
        # its table; the JAX package's gather clamps, a device gather faults
        self._id_vocabs = dict(getattr(model, "id_vocabs", {}))
        # dropout draws from one generator on the device, seeded here
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
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
            groups = self.embedding.groups()
            self._shards = {f"table_{g}": self.embedding.table_shards.get(g, 1) for g in groups}
            self._row_offsets = {f"table_{g}": self.embedding.row_offset[g] for g in groups
                                 if g in self.embedding.row_offset}
            for name in self.plan.table_names:
                getattr(self.embedding, name).requires_grad_(False)
            kind = FUSED.get(embedding_optimizer, embedding_optimizer)
            self.emb_state = sparse_embed.init_state(
                self.tables(), "lazy_adam" if kind == "adam" else kind)
            if embedding_optimizer in FUSED:
                # on the card the prep's arrays come from pinned memory
                self._prep = streaming_embed.make_host_prep(
                    self.plan, pin=self.device.type == "cuda", shards_by_name=self._shards)
        params = [p for p in self.model.parameters() if p.requires_grad]
        if weight_decay > 0.0:
            self.optimizer = torch.optim.AdamW(params, lr=learning_rate,
                                               weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.Adam(params, lr=learning_rate)

    def tables(self) -> dict:
        """{table name: tensor} of the tables the embedding optimizer updates."""
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
            yield self._checked(batch, s, valid, prep), valid

    def _checked(self, batch: dict, start: int, valid: int, prep: Callable | None) -> dict:
        """``batch`` after its id checks, with ``prep``'s arrays added."""
        for key, vocab in self._vocabs.items():
            # an id outside its table would fault the device gather
            ids = batch.get(key)
            if ids is not None and ((ids < 0).any() or (ids >= vocab).any()):
                raise ValueError(f"sparse ids outside their vocabularies "
                                 f"in rows {start}..{start + valid}")
        for key, vocab in self._id_vocabs.items():
            ids = batch.get(key)
            if ids is not None and ((ids < 0).any() or (ids >= vocab).any()):
                raise ValueError(f"{key} ids outside [0, {vocab}) in rows "
                                 f"{start}..{start + valid}")
        if prep is not None:
            with profiling.span("train_step.prep"):
                batch.update(prep(batch["sparse"]))
        return batch

    def _streamed(self, stream, prep: Callable | None = None):
        """One pass over ``stream`` (re-iterable, or a zero-argument callable
        returning an iterator): (checked batch, its rows)."""
        start = 0
        for b in (stream() if callable(stream) else iter(stream)):
            rows = _num_examples(b)
            yield self._checked(dict(b), start, rows, prep), rows
            start += rows

    def _to_device(self, batch: dict, sp=profiling.OFF) -> dict:
        """The batch on the device: numpy arrays copied, tensors (the fused
        prep's, pinned on the card) copied ``non_blocking``; the bytes of
        each kind are counted on ``sp``."""
        out, blocking, async_ = {}, 0, 0
        for k, v in batch.items():
            if k.startswith("_"):
                continue
            if isinstance(v, torch.Tensor):
                async_ += v.nbytes
                out[k] = v.to(self.device, non_blocking=True)
            else:
                v = np.ascontiguousarray(v)
                blocking += v.nbytes
                out[k] = torch.from_numpy(v).to(self.device)
        if sp is not profiling.OFF:
            sp.count(bytes_blocking=blocking, bytes_async=async_)
        return out

    # -- training ---------------------------------------------------------
    def train_step(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a host batch (numpy arrays; the fused
        embedding optimizers' host prep is added when missing).  Returns
        the loss as a device scalar, without waiting for it."""
        with profiling.span("train_step", step=self.step + 1):
            if self._prep is not None and "embaux0_ids" not in batch:
                with profiling.span("train_step.prep"):
                    batch = dict(batch, **self._prep(batch["sparse"]))
            with profiling.span("train_step.copy") as sp:
                db = self._to_device(self._local(batch), sp)
            self.model.train()
            self.step += 1
            with profiling.span("train_step.dense_adam"):
                self.optimizer.zero_grad(set_to_none=True)
            with profiling.span("train_step.forward"):
                loss = self.loss_fn(self.model(db), db)
            with profiling.span("train_step.backward"):
                if self.mesh is None:
                    loss.backward()
                else:  # the global batch's mean: this rank's share, its gradients summed
                    (loss / self._n_data).backward()
                    self._sum_gradients()
            with profiling.span("train_step.dense_adam"):
                self.optimizer.step()
            if self.embedding is not None:
                with profiling.span("train_step.embed_update"):
                    self._update_embeddings(db)
            drops = [m.dropped for m in self._a2a if m.dropped is not None]
            self.last_dropped = sum(drops) if drops else None
            loss = loss.detach()
            return loss if self.mesh is None else self._data_sum(loss) / self._n_data

    def _update_embeddings(self, db: dict) -> None:
        """The embedding optimizer's step on the tap's cotangent."""
        cot = self.embedding.tap.grad
        if self.embedding_optimizer in FUSED:
            streaming_embed.apply_updates_fused(
                self.tables(), self.emb_state, self.plan, db, cot,
                lr=self.embedding_lr, step=self.step, weight_decay=self.weight_decay,
                kind=FUSED[self.embedding_optimizer], mm_bf16=self.embedding_fused_bf16,
                mesh=self.mesh, shards_by_name=self._shards,
                data_contract=self.data_contract)
        else:
            ids = db["sparse"]
            if self.mesh is not None:  # the global batch's ids and cotangent
                ids, cot = (mesh_lib.all_gather(x, self.mesh, mesh_lib.DATA_AXIS)
                            for x in (ids, cot))
            sparse_embed.apply_updates(
                self.tables(), self.emb_state, self.plan, ids, cot,
                kind=self.embedding_optimizer, lr=self.embedding_lr, step=self.step,
                weight_decay=self.weight_decay, row_offsets=self._row_offsets)
        self.embedding.tap = None

    def _local(self, batch: dict) -> dict:
        """This rank's rows of a host batch, by the data contract."""
        if self.mesh is None or self.data_contract == "local":
            return batch
        return mesh_lib.shard_batch(batch, self.mesh)

    def _data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data axis (``x`` itself without a mesh)."""
        if self.mesh is None or self._n_data == 1:
            return x
        return mesh_lib.all_reduce(x, self.mesh, mesh_lib.DATA_AXIS)

    def _sum_gradients(self) -> None:
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.copy_(self._data_sum(p.grad))

    def fit(self, train_data, batch_size: int = 512, epochs: int = 10,
            val_data: dict | None = None, validation_split: float = 0.0,
            early_stopping_patience: int | None = None,
            checkpoint_path: str | None = None, checkpoint_sharded: bool | None = None,
            verbose: bool = True, log_jsonl: str | None = None,
            eval_fn: Callable | None = None, eval_every: int = 1) -> dict:
        """Train on a dict of aligned numpy arrays (with the label key), or
        on a stream of batch dicts (a re-iterable object, each ``iter()`` a
        fresh pass, or a zero-argument callable returning an iterator).

        Arrays: each epoch reshuffles (a numpy generator seeded by
        ``seed``) and drops the remainder; a batch larger than the data is
        clamped to it; ``validation_split`` holds out the dataset's tail
        when ``val_data`` is not given.  A stream: each epoch is one pass,
        its batches as they come (their size is the stream's), with the id
        checks and the fused host prep on the prefetch thread; it takes no
        ``validation_split``, and ``val_data`` must be an array dict.  The
        loss adds up on the device and is read once per epoch.  Returns
        ``{'loss': [...], 'val_loss': [...]}``.

        With validation data, an epoch whose validation loss falls below the
        best by more than 1e-6 keeps a copy of the model's parameters and
        buffers on the device; training stops once
        ``early_stopping_patience`` epochs in a row have not improved, and
        the best copy is loaded back at the end (also without early
        stopping), as in the JAX package.  The optimizer state and
        ``self.step`` go on from the last step.

        ``checkpoint_path`` keeps the best checkpoint there
        (``checkpoint.BestCheckpointer`` on the validation loss, or on the
        training loss without validation data), each rank writing its own
        shards (``checkpoint.save_sharded``) when ``checkpoint_sharded``,
        by default on a mesh with a model axis.  On a mesh, an epoch whose
        a2a engines dropped ids adds ``a2a_dropped`` to its line, and
        ``history['a2a_dropped']`` holds each epoch's count when the model
        has an a2a engine.  ``log_jsonl`` appends one
        JSON record an epoch: ``epoch``, ``step``, ``loss``,
        ``epoch_seconds`` and, with validation data, ``val_loss``.

        ``eval_fn(trainer)``, if given, runs after validation on every
        ``eval_every``-th epoch and returns {metric: float}; each value is
        appended to ``history[metric]`` and shown on the epoch's line."""
        streaming = not isinstance(train_data, dict)
        if streaming:
            if validation_split > 0.0:
                raise ValueError("validation_split needs a resident array dict; pass a "
                                 "val_data dict alongside the training stream instead")
            if val_data is not None and not isinstance(val_data, dict):
                raise ValueError("val_data must be a dict of arrays beside a training stream")
        else:
            if validation_split > 0.0 and val_data is None:
                cut = int(_num_examples(train_data) * (1.0 - validation_split))
                val_data = {k: v[cut:] for k, v in train_data.items()}
                train_data = {k: v[:cut] for k, v in train_data.items()}
            n = _num_examples(train_data)
            if n == 0:
                raise ValueError("empty training dataset")
            local = self.mesh is not None and self.data_contract == "local"
            batch_size = min(batch_size, n * (self._n_data if local else 1))
            if batch_size % self._n_data:
                raise ValueError(f"batch_size {batch_size} does not split over a data "
                                 f"axis of {self._n_data}")
            slice_bs = batch_size // self._n_data if local else batch_size
        if checkpoint_sharded is None:
            checkpoint_sharded = self.mesh is not None and \
                self.mesh.size(mesh_lib.MODEL_AXIS) > 1
        checkpointer = (BestCheckpointer(checkpoint_path, sharded=checkpoint_sharded)
                        if checkpoint_path else None)
        history = {"loss": [], "val_loss": []}
        best_val, best_state, bad_epochs = np.inf, None, 0
        for epoch in range(epochs):
            t0 = time.time()
            if streaming:
                batches = self._streamed(train_data, self._prep)
            else:
                order = np.arange(n)
                self._shuffle_rng.shuffle(order)
                batches = self._batches(train_data, slice_bs, order, True, self._prep)
            total, count, dropped = None, 0, 0
            for batch, _ in prefetch(batches):
                loss = self.train_step(batch)
                total = loss if total is None else total + loss
                if self.last_dropped is not None:
                    dropped = dropped + self.last_dropped
                count += 1
            train_loss = float(total) / count if count else 0.0
            history["loss"].append(train_loss)
            msg = f"epoch {epoch + 1}/{epochs} loss={train_loss:.5f}"
            if self._a2a:
                history.setdefault("a2a_dropped", []).append(int(dropped))
                if int(dropped):
                    msg += f" a2a_dropped={int(dropped)}"
            if val_data is not None:
                val_loss = self.evaluate_loss(val_data, batch_size)
                history["val_loss"].append(val_loss)
                msg += f" val_loss={val_loss:.5f}"
                if val_loss < best_val - 1e-6:
                    best_val, bad_epochs = val_loss, 0
                    # copies, not views: the optimizers go on updating the
                    # live tensors in place
                    best_state = {k: v.detach().clone()
                                  for k, v in self.model.state_dict().items()}
                else:
                    bad_epochs += 1
            if checkpointer is not None:
                checkpointer.update(val_loss if val_data is not None else train_loss, self)
            if eval_fn is not None and (epoch + 1) % eval_every == 0:
                for k, v in eval_fn(self).items():
                    history.setdefault(k, []).append(v)
                    msg += f" {k}={v:.4f}"
            if verbose:
                print(msg)
            if log_jsonl:
                rec = {"epoch": epoch + 1, "step": self.step, "loss": train_loss,
                       "epoch_seconds": round(time.time() - t0, 3)}
                if val_data is not None:
                    rec["val_loss"] = history["val_loss"][-1]
                with open(log_jsonl, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if early_stopping_patience is not None and bad_epochs >= early_stopping_patience:
                break
        if best_state is not None:
            self.model.load_state_dict(best_state)
        return history

    def evaluate_loss(self, data: dict, batch_size: int = 4096) -> float:
        """Mean loss over the whole dataset, added up on the device.  The
        padded tail is corrected exactly for a loss that is a mean of
        per-example terms: ``sum_valid = L_pad·B - pad·L_tile``, with
        ``L_tile`` the loss of a batch holding only the repeated row (on a
        mesh, each rank's share of it, summed over the data axis)."""
        self.model.eval()
        local = self.mesh is not None and self.data_contract == "local"
        bs = batch_size // self._n_data if local else batch_size
        share = self._n_data if local else 1  # examples of the global batch a valid row is
        total, n = None, 0
        with torch.inference_mode():
            for batch, valid in prefetch(self._batches(data, bs)):
                db = self._to_device(self._local(batch))
                rows = _num_examples(db)
                part = self.loss_fn(self.model(db), db) * rows
                if valid < bs:
                    last = self._to_device({k: v[-1:] for k, v in batch.items()})
                    tiled = {k: v.expand(rows, *v.shape[1:]).contiguous()
                             for k, v in last.items()}
                    pad = (bs - valid) * share / self._n_data
                    part = part - self.loss_fn(self.model(tiled), tiled) * pad
                total = part if total is None else total + part
                n += valid * share
        return float(self._data_sum(total)) / n if n else 0.0

    # -- serving ----------------------------------------------------------
    def predict(self, data: dict, batch_size: int = 4096,
                consumer: Callable | None = None):
        """Forward pass over a dataset; returns the stacked outputs with
        exactly one row per example: a numpy array, or a dict of them when
        the model returns a dict (as the JAX ``predict`` returns a pytree).

        ``consumer(outputs, start)`` -- if given, each batch's host outputs
        (padding rows dropped; ``start`` is the dataset offset) are handed
        over as they arrive and nothing is accumulated (returns None).
        On a mesh (global contract only) each rank runs its rows and every
        rank gets every output."""
        if self.data_contract == "local" and torch.distributed.is_initialized() and \
                torch.distributed.get_world_size() > 1:
            raise NotImplementedError(
                "predict returns every example's output and keeps the global contract: "
                "pass the same global arrays on every rank (fit, evaluate_loss and "
                "evaluate_auc take the local contract)")
        self.model.eval()
        outs, start = [], 0

        def whole(x):  # every data rank's rows, in order
            return x if self.mesh is None else mesh_lib.all_gather(x, self.mesh,
                                                                   mesh_lib.DATA_AXIS)

        with torch.inference_mode():
            for batch, valid in prefetch(self._batches(data, batch_size)):
                out = self.model(self._to_device(self._local(batch)))
                if isinstance(out, dict):
                    out = {k: whole(v)[:valid].cpu().numpy() for k, v in out.items()}
                else:
                    out = whole(out)[:valid].cpu().numpy()
                if consumer is not None:
                    consumer(out, start)
                else:
                    outs.append(out)
                start += valid
        if consumer is not None:
            return None
        if isinstance(outs[0], dict):
            return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}
        return np.concatenate(outs, axis=0)

    def evaluate_auc(self, data, batch_size: int = 4096, label_key: str = "label",
                     from_logits: bool = True) -> float:
        """Binned AUC (8192 bins) of the predictions against
        ``data[label_key]``, over a dict of arrays or a stream of batch
        dicts (as ``fit`` takes one).  Each batch's scores add to two
        histograms on the device (``metrics.AucAccumulator``), the padded
        rows weighted 0, so no per-example score reaches the host; on a
        mesh the histograms are summed over the data axis at the end."""
        local = self.mesh is not None and self.data_contract == "local"
        bs = batch_size // self._n_data if local else batch_size
        batches = (self._batches(data, bs) if isinstance(data, dict)
                   else self._streamed(data))
        acc = metrics_lib.AucAccumulator(AUC_BINS, device=self.device)
        self.model.eval()
        first = 0  # this rank's first row in the batch
        with torch.inference_mode():
            for batch, valid in prefetch(batches):
                db = self._to_device(self._local(batch))
                out = self.model(db).float()
                labels = db[label_key]
                if self.mesh is not None and not local:
                    first = self.mesh.index(mesh_lib.DATA_AXIS) * labels.shape[0]
                rows = first + torch.arange(labels.shape[0], device=self.device)
                weights = (rows < valid).float()
                acc.update(torch.sigmoid(out) if from_logits else out, labels, weights)
        acc.pos, acc.neg = self._data_sum(acc.pos), self._data_sum(acc.neg)
        return acc.result()

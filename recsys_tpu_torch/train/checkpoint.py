"""Checkpoints of a ``Trainer`` (the port of ``save``, ``restore`` and
``BestCheckpointer`` of ``recsys_tpu/train/checkpoint.py``, unsharded).

A checkpoint holds what the JAX package's ``TrainState`` holds: the step
count, the model's ``state_dict`` (parameters, the embedding tables among
them, and BatchNorm buffers), the dense optimizer's ``state_dict`` and the
embedding optimizer's state (``emb_state``: Adam's m and v, or rowwise
AdaGrad's acc).  The file is ``torch.save``'s, read back with
``torch.load(weights_only=True)`` onto the trainer's device.
"""
from __future__ import annotations

import os

import torch


def save(path: str, trainer) -> None:
    """Write ``trainer``'s state to ``path`` (its directory made as needed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": trainer.step, "model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "emb_state": trainer.emb_state or {}}, tmp)
    os.replace(tmp, path)  # a reader never sees half a checkpoint


def restore(path: str, trainer):
    """Load the checkpoint at ``path`` into ``trainer`` (built like the one
    saved: same model, optimizers and embedding optimizer) in place;
    returns ``trainer``."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    mine = trainer.emb_state or {}
    if ({n: sorted(st) for n, st in state["emb_state"].items()}
            != {n: sorted(st) for n, st in mine.items()}):
        raise ValueError(f"{path}: embedding optimizer state of tables "
                         f"{sorted(state['emb_state'])}, the trainer has {sorted(mine)}")
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    with torch.no_grad():
        for name, st in state["emb_state"].items():
            for k, v in st.items():
                mine[name][k].copy_(v)
    trainer.step = int(state["step"])
    return trainer


class BestCheckpointer:
    """Keeps the best checkpoint on disk: ``update(metric, trainer)`` saves
    when ``metric`` beats the best so far (lower is better with
    ``mode='min'``) and returns whether it did."""

    def __init__(self, path: str, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode={mode!r} not in ('min', 'max')")
        self.path = path
        self.mode = mode
        self.best: float | None = None

    def update(self, metric: float, trainer) -> bool:
        better = (self.best is None or (self.mode == "min" and metric < self.best)
                  or (self.mode == "max" and metric > self.best))
        if better:
            self.best = metric
            save(self.path, trainer)
        return better

"""Loss functions (the port's copy of recsys_tpu.train.losses, the part the
training slice needs)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, stable through ``logsigmoid``
    and computed in the logits' type."""
    labels = labels.to(logits.dtype)
    per_ex = -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    return per_ex.mean()

"""Published peaks of the cards the benchmark runs on (NVIDIA's H100 SXM
data sheet: dense rates without sparsity, at the 700 W power limit)."""
from __future__ import annotations

SPECS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bw": 3.35e12, "bf16_flops": 989e12, "f32_flops": 67e12},
}


def spec(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold."""
    return next((s for k, s in SPECS.items() if kind.startswith(k)), None)

"""Typed experiment configuration (the port's copy of
``recsys_tpu/core/config.py``): one dataclass an experiment, defaults in
code, overrides from a JSON file, then from keywords.  The fields and the
JSON layout are the JAX package's, so a file written by either package
loads in the other.

    cfg = ExperimentConfig(task="ctr", model="deepfm")
    cfg = load_config("exp.json", task="ctr")      # file, then keywords
    cfg.to_json("exp.json")
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class ExperimentConfig:
    # what to run
    task: str = "ctr"            # ctr | din | multitask | match | ncf | sasrec | youtube | mind
    model: str = "fm"
    # data
    data_path: str | None = None
    embed_dim: int = 8
    maxlen: int = 50
    sample_num: int = 0
    # training protocol (the reference's defaults: Adam 1e-3, batch 512, patience 1)
    batch_size: int = 512
    epochs: int = 10
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    validation_split: float = 0.1
    early_stopping_patience: int | None = 1
    seed: int = 0
    # the JAX package's device mesh (None: every device); kept for the file layout
    mesh_data: int | None = None
    mesh_model: int = 1
    checkpoint_path: str | None = None
    log_jsonl: str | None = None
    # optimizer and precision
    embedding_optimizer: str | None = None  # lazy_adam | rowwise_adagrad | fused_*
    bf16_compute: bool = False

    def override(self, **kwargs) -> "ExperimentConfig":
        """A new config with the keywords that are not None applied."""
        return dataclasses.replace(self, **{k: v for k, v in kwargs.items() if v is not None})

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)


def load_config(path: str | None = None, **overrides) -> ExperimentConfig:
    """Defaults, then the JSON file (if given), then the keyword overrides."""
    cfg = ExperimentConfig()
    if path is not None:
        with open(path) as f:
            cfg = ExperimentConfig.from_dict({**dataclasses.asdict(cfg), **json.load(f)})
    return cfg.override(**overrides)

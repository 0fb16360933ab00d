"""PyTorch + CUDA port of recsys_tpu for the NVIDIA H100.

The JAX package ``recsys_tpu`` stays the reference; this package imports
``torch`` and never JAX, flax, optax or anything under ``recsys_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

"""Kernel layer, the dot interaction #1 (``kernels/csrc/dot_interaction.cu``,
``dot_interaction_kernel``, the forward; its backward is torch ops): the
forward's bytes at the card's HBM bandwidth over the device time of the
kernels named here.  The bytes: the (B, F + 1, D) input in the compute
dtype read once and the (B, P) float32 pairs written once."""
import re

UNIT = "%"
KERNELS = re.compile(r"\bdot_interaction_kernel\b")
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def bytes_per_step(config: dict, batch: int) -> int:
    f = len(config["table_rows"]) + 1
    d = int(config["arch_sparse_feature_size"])
    pairs = f * (f - 1) // 2
    return batch * f * d * DTYPE_BYTES[config["port"]["compute_dtype"]] + batch * pairs * 4


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.config.get("family") != "dlrm":
        return None
    t = ctx.trace.kernel_s(KERNELS.search)
    if t <= 0:
        return None
    need = bytes_per_step(ctx.config, ctx.batch) * ctx.trace.steps / ctx.peaks["hbm_bw"]
    return 100.0 * need / t

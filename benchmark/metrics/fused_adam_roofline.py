"""Kernel layer, the fused embedding update #4
(``kernels/csrc/embedding_update.cu``, ``adam_kernel``): the bytes dense
Adam over every table needs a step, at the card's HBM bandwidth, over the
device time of the kernels named here.

The bytes come from the shapes, whatever implements the update: each
table's p, m and v read once and written once, the sorted cotangent (one
row per occurrence, in bf16 where the configuration rounds it so) and
its row ids read once, and each table's block pointers (one per
``BLOCK`` rows, plus one) read once."""
import re

UNIT = "%"
KERNELS = re.compile(r"\badam_kernel\b")
BLOCK = 512  # table rows per block of the update, the port's DEFAULT_BLOCK
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def bytes_per_step(config: dict, batch: int) -> int:
    rows = [int(v) for v in config["table_rows"]]
    d = int(config["arch_sparse_feature_size"])
    port = config["port"]
    p = DTYPE_BYTES[port["table_dtype"]]
    tables = sum(rows) * d * (2 * p + 2 * 4 + 2 * 4)
    cot = batch * len(rows) * d * (2 if port["embedding_fused_bf16"] else 4)
    ids = batch * len(rows) * 4
    ptrs = sum(-(-v // min(BLOCK, v)) + 1 for v in rows) * 4
    return tables + cot + ids + ptrs


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or ctx.config.get("family") != "dlrm":
        return None
    if ctx.config["port"]["embedding_optimizer"] != "fused_adam":
        return None
    t = ctx.trace.kernel_s(KERNELS.search)
    if t <= 0:
        return None
    need = bytes_per_step(ctx.config, ctx.batch) * ctx.trace.steps / ctx.peaks["hbm_bw"]
    return 100.0 * need / t

"""Step layer: the model FLOPs of a step over the untraced window's mean
step on the device's clock (CUDA events), against the card's bf16 peak.
A step's FLOPs are 3 × the forward's: two per multiply-add of every MLP
layer and of the interaction's B·P·D products (the backward counted as
twice the forward)."""
UNIT = "%"


def flops_per_example(config: dict) -> int:
    d = int(config["arch_sparse_feature_size"])
    f = len(config["table_rows"]) + 1
    pairs = f * (f - 1) // 2
    bottom = [int(x) for x in config["arch_mlp_bot"]]
    top = [d + pairs] + [int(x) for x in config["arch_mlp_top"]]
    macs = sum(a * b for a, b in zip(bottom, bottom[1:]))
    macs += sum(a * b for a, b in zip(top, top[1:]))
    macs += pairs * d
    return 3 * 2 * macs


def read(ctx):
    if ctx.peaks is None or ctx.config.get("family") != "dlrm":
        return None
    flops = flops_per_example(ctx.config) * ctx.batch
    return 100.0 * flops / ctx.step_s / ctx.peaks["bf16_flops"]

"""Entry layer (``Trainer.train_step``: the host prep, the copies to the
card, the launches): the mean host time of one ``train_step`` call over
the measured window, from the benchmark's own span around each call."""
UNIT = "ms"


def read(ctx):
    if not ctx.call_ms:
        return None
    return sum(ctx.call_ms) / len(ctx.call_ms)

"""Device layer: the share of a step in which no kernel, copy or set runs
on the card.  The busy time a step is the union of the profiler's device
intervals over the traced sub-window, per step; the step is the untraced
window's mean, both on the device's clock.  The profiler lengthens a traced
step (its launches cost the host more) but not the device's work, so the
share is the untraced step's (the traced step's own is ``1 - busy_s /
window_s`` in the result's ``device``)."""
UNIT = "%"


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.steps / ctx.step_s)

"""device.idle_pct (%): the share of the profiled stretch's wall in
which no operation runs on the device (the union of the intervals of
its kernels, copies and fills)."""


def read(ctx):
    window_s = ctx.trace.window_s
    if window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / window_s)

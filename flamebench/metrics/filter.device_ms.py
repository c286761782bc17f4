"""filter.device_ms (ms): device time of the operations launched in
the filter span (log density, DE, downsample, colorclip, u8), per
frame of the profiled stretch."""


def read(ctx):
    frames = ctx.trace.count("filter")
    device_s = ctx.trace.device_s("filter")
    if frames == 0 or device_s <= 0:
        return None
    return 1e3 * device_s / frames

"""flush_roofline (%): the least time of the function "plotted points
into the histogram" over the device time of every operation launched in
the accumulate span other than the chaos kernel: the sort, the flush,
the counts and the histogram's set-up, whichever kernels do them.

The least time is roofline.flush_bound_s of the frames the stretch
accumulated: each plotted point a 4-byte record read once, each bin
the frame touches read and written once (16 + 16 bytes), with the
plotted points and touched bins of the reference's frames."""

from flamebench import roofline

CHAOS_KERNEL = "chaos_iterate"


def read(ctx):
    frames = ctx.trace.count("accumulate")
    device_s = ctx.trace.device_s("accumulate", name_lacks=CHAOS_KERNEL)
    if frames == 0 or device_s <= 0 or ctx.ref_plotted <= 0:
        return None
    least_s, _by = roofline.flush_bound_s(frames * ctx.ref_plotted,
                                          frames * ctx.ref_touched_bins)
    return 100.0 * least_s / device_s

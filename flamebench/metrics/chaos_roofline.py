"""chaos_roofline (%): the chaos game's least time over the device time
of its kernel (`chaos_iterate_kernel`) in the profiled stretch.

The least time is roofline.chaos_bound_s of the frames the stretch
accumulated: the configuration's float operations a lane-step times the
samples the frames ask for, a 4-byte record a lane-step, and each
lane's 36-byte state in and out once a temporal sample."""

from flamebench import roofline

KERNEL = "chaos_iterate"


def read(ctx):
    frames = ctx.trace.count("accumulate")
    device_s = ctx.trace.device_s("accumulate", name_has=KERNEL)
    if frames == 0 or device_s <= 0:
        return None
    least_s, _by = roofline.chaos_bound_s(
        frames * ctx.samples_per_frame,
        ctx.cell.config["ops_per_lane_step"],
        frames * ctx.lanes_per_frame)
    return 100.0 * least_s / device_s

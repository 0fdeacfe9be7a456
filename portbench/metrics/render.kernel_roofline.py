"""render.kernel_roofline: the render's least time (each particle read once,
each voxel written once, at the HBM rate) over its kernels' time inside the
render span, copies and fills left out, in percent."""
from portbench.roofline import least_ms, render_bytes


def read(rec):
    per = rec.in_spans("render", ("kernel",))
    if not per or sum(per) <= 0:
        return None
    least = least_ms(render_bytes(rec.params["particles"],
                                  rec.params["voxels"]))
    return 100 * least / (1e3 * sum(per) / len(per))

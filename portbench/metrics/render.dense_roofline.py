"""render.dense_roofline: the dense pass's least time (each dense row read
once, each voxel its sphere covers written once, at the HBM rate:
``roofline_dense.dense_bytes``) over the device ms of the program's span
``nbodyhpc.render.dense`` per public call, in percent. Rows and sphere
voxels are the step's counters ``render.dense_rows`` and
``render.dense_voxels``, averaged over the traced steps; None in a program
without the voxel counter."""
from portbench.roofline import least_ms
from portbench.roofline_dense import dense_bytes
from portbench.spans import per_call_ms


def read(rec):
    steps = [s for s in rec.steps if "render.dense_voxels" in s]
    if not steps:
        return None
    ms = per_call_ms("nbodyhpc.render.dense", "nbodyhpc.render")
    if not ms:
        return None
    nbytes = sum(dense_bytes(s["render.dense_rows"], s["render.dense_voxels"],
                             rec.params["voxels"]) for s in steps) / len(steps)
    return 100 * least_ms(nbytes) / ms

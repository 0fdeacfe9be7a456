"""render.dense_ms: the dense pass over radii above 15 px. The device
milliseconds (CUDA events) of the program's span ``nbodyhpc.render.dense``
over the traced window, per public call (``nbodyhpc.render``)."""
from portbench.spans import per_call_ms


def read(rec):
    return per_call_ms("nbodyhpc.render.dense", "nbodyhpc.render")

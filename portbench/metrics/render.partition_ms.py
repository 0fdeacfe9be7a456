"""render.partition_ms: the fused partition (keys, the stable sort, the gather,
the offsets). The device milliseconds (CUDA events) of the program's span
``nbodyhpc.render.partition`` over the traced window, per public call
(``nbodyhpc.render``)."""
from portbench.spans import per_call_ms


def read(rec):
    return per_call_ms("nbodyhpc.render.partition", "nbodyhpc.render")

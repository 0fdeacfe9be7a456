"""render.deposit_ms: the bucket streams (channel prep, B1 align and the B2
deposits of every bucket). The device milliseconds (CUDA events) of the
program's span ``nbodyhpc.render.buckets`` over the traced window, per
public call (``nbodyhpc.render``)."""
from portbench.spans import per_call_ms


def read(rec):
    return per_call_ms("nbodyhpc.render.buckets", "nbodyhpc.render")

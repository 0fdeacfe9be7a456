"""knn.plan_ms: the tree's kernel plan (run tables and their two syncs, built
once per tree). The device milliseconds (CUDA events) of the program's span
``nbodyhpc.knn.plan`` over the traced window, per public call
(``nbodyhpc.knn.query``)."""
from portbench.spans import per_call_ms


def read(rec):
    return per_call_ms("nbodyhpc.knn.plan", "nbodyhpc.knn.query")

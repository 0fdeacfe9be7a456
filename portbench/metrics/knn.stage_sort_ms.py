"""knn.stage_sort_ms: the stage sort (queries by piece, the running max, the
pieces). The device milliseconds (CUDA events) of the program's span
``nbodyhpc.knn.stage_sort`` over the traced window, per public call
(``nbodyhpc.knn.query``)."""
from portbench.spans import per_call_ms


def read(rec):
    return per_call_ms("nbodyhpc.knn.stage_sort", "nbodyhpc.knn.query")

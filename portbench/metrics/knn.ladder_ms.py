"""knn.ladder_ms: the exact ladder over the queries the r = 1 bound leaves. The
device milliseconds (CUDA events) of the program's span
``nbodyhpc.knn.ladder`` over the traced window, per public call
(``nbodyhpc.knn.query``)."""
from portbench.spans import per_call_ms


def read(rec):
    return per_call_ms("nbodyhpc.knn.ladder", "nbodyhpc.knn.query")

"""knn.query_roofline: a query batch's least time (each tree point and query
read once, each result written once, at the HBM rate) over its kernels' time
inside the query span, copies and fills left out, in percent."""
from portbench.roofline import b3_bytes, least_ms


def read(rec):
    per = rec.in_spans("knn.query", ("kernel",))
    if not per or sum(per) <= 0:
        return None
    p = rec.params
    least = least_ms(b3_bytes(p["points"], p["queries"], p["k"]))
    return 100 * least / (1e3 * sum(per) / len(per))

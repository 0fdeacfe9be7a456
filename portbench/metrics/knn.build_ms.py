"""knn.build_ms: the mean span of the tree build (``KDTree(...)``, closed by
a synchronize) per step, on the host clock of the trace."""


def read(rec):
    spans = rec.spans.get("knn.build", [])
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6

"""knn_queries_per_s: queries answered over the whole window, divided by the
window (host clock); each step's tree build counts."""


def read(host: dict):
    if host["unit"] != "queries":
        return None
    return host["work"] / host["window_s"]

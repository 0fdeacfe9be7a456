"""knn.ladder_share: queries the exact ladder finished (the program's
counter ``query_blocks_device.ladder_queries``, read after each step) over
all queries of the window, in percent."""


def read(rec):
    steps = [s for s in rec.steps if "ladder_queries" in s]
    q = sum(s["queries"] for s in steps)
    return 100 * sum(s["ladder_queries"] for s in steps) / q if q else None

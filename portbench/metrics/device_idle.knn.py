"""device_idle.knn: the share of the traced window in which no kernel, copy
or fill ran on the device, in percent, in cells whose steps are k-NN calls."""


def read(rec):
    if not rec.device or not rec.spans.get("knn.query"):
        return None
    return 100 * (1 - rec.busy_s() / rec.window_s())

"""render.to_host_ms: device-to-host copy time per render, from the device
trace (the field's copy into host memory)."""


def read(rec):
    per = rec.in_spans("render", ("copy_d2h",))
    return 1e3 * sum(per) / len(per) if per and sum(per) > 0 else None

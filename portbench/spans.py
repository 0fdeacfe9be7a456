"""Per-call device milliseconds of the program's own spans.

The port opens ``nbodyhpc.*`` spans inside its public calls
(``nbodyhpc_tpu_torch.utils.profiling.span``) only while a profiler session
records, so in a traced run its store holds exactly the traced window: the
warm steps run before the profiler starts and the check after it stops. The
readers in ``metrics/`` that read a span take it from that store. A program
without the store reads None.
"""
from __future__ import annotations


def per_call_ms(span: str, call: str):
    """Device milliseconds of ``span`` over the window divided by the number
    of public calls ``call``; 0 where the call never opened the span, None
    without a public call or without device timing."""
    from nbodyhpc_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None:
        return None
    totals = totals()
    calls = totals.get(call)
    if calls is None or calls.device_ms is None:
        return None
    layer = totals.get(span)
    if layer is None:
        return 0.0
    if layer.device_ms is None:
        return None
    return layer.device_ms / calls.count

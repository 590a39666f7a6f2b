"""``serve_flush_idle_ms.read``: the device's idle ms per coalesced
lookup dispatch inside the program's ``queue.flush`` spans but outside
their ``queue.dispatch`` (the staging into the bucket, the scatter of
the answers to the tickets, the flush's own steps), over the traced
window.  None where the trace holds no ``queue.flush`` span."""

from portbench.queue_spans import queue_stages


def read(run):
    st = queue_stages(run)
    if st is None:
        return None
    us = st["idle_us"] - st["stage_idle_us"]["queue.dispatch"]
    return us / 1e3 / st["calls"]

"""``serve_dispatch_idle_ms.read``: the device's idle ms per coalesced
lookup dispatch inside the program's ``queue.dispatch`` spans (the
index call with its host stages), over the traced window.  None where
the trace holds no ``queue.flush`` span."""

from portbench.queue_spans import queue_stages


def read(run):
    st = queue_stages(run)
    if st is None:
        return None
    return st["stage_idle_us"]["queue.dispatch"] / 1e3 / st["calls"]

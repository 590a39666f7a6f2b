"""``lookup_call_p95_ms.read``: the 95th percentile of the client's clock
around each ``Index.lookup`` call that ended in the window."""

from portbench.harness import p95


def read(run):
    return p95(run.layer.get("call_ms", []))

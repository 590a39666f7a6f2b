"""``serve_queue_wait_ms.read``: the mean ms a lookup request waited in
the serving queue, from its submit to the start of the flush that
dispatched it, over the window's requests (the program's
``MicroBatchQueue.stats`` counters ``lookup_wait_ms_sum`` and
``coalesced_lookups``).  None where the program has no such counter."""


def read(run):
    q = run.layer.get("info", {}).get("queue")
    if not isinstance(q, dict) or "lookup_wait_ms_sum" not in q:
        return None
    if not q.get("coalesced_lookups"):
        return None
    return q["lookup_wait_ms_sum"] / q["coalesced_lookups"]

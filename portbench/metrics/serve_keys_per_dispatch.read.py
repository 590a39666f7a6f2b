"""``serve_keys_per_dispatch.read``: the keys the serving queue
dispatched per coalesced lookup dispatch over the window (the program's
``MicroBatchQueue.stats`` counters ``lookup_keys`` and
``lookup_dispatches``; padding left out).  None where the program has
no ``lookup_keys`` counter."""


def read(run):
    q = run.layer.get("info", {}).get("queue")
    if not isinstance(q, dict) or "lookup_keys" not in q:
        return None
    if not q.get("lookup_dispatches"):
        return None
    return q["lookup_keys"] / q["lookup_dispatches"]

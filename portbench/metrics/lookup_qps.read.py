"""``lookup_qps.read``: the queries answered by the calls that ended in
the window, over the window's seconds, on the client's clock (in a
``--trace 1`` run: under the profiler)."""


def read(run):
    return run.layer.get("lookup_qps")

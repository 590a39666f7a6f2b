"""``fused_lookup_roofline.read``: the least bytes of every lookup batch
of the window (``yardstick.lookup_least_bytes``, from the benchmark's
own inputs) at the card's 3.35 TB/s, over the device time of the
``fused_lookup`` kernel in the trace, in percent."""

from portbench.yardstick import H100_BYTES_PER_S, lookup_least_bytes


def read(run):
    ev = run.events
    if ev is None or "calls" not in run.layer:
        return None
    kernel_s = ev.device_us("fused_lookup_kernel") / 1e6
    if kernel_s <= 0:
        return None
    pool, calls = run.pool, run.layer["calls"]
    per = [lookup_least_bytes(q, run.keys) for q in pool]
    total = sum(per[i % len(pool)] for i in range(calls))
    return 100.0 * total / H100_BYTES_PER_S / kernel_s

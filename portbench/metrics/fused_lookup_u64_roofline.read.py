"""``fused_lookup_u64_roofline.read``: the least bytes of every read the
window's clients completed (``yardstick_u64.lookup_least_bytes_u64`` of
each request's keys, from the benchmark's own inputs) at the card's
3.35 TB/s, over the device time of the 64-bit lookup kernel
(``fused_lookup64_kernel``) in the trace, in percent.  None where the
trace holds no such kernel."""

from portbench.yardstick import H100_BYTES_PER_S
from portbench.yardstick_u64 import lookup_least_bytes_u64


def read(run):
    ev = run.events
    if ev is None or not getattr(run, "reads", None):
        return None
    kernel_s = ev.device_us("fused_lookup64_kernel") / 1e6
    if kernel_s <= 0:
        return None
    # the reads are listed client after client, each client's in order:
    # a client's k-th read sent its pool's entry k mod the pool's size
    cache = {}
    total, client, k = 0, 0, 0
    prev_t0 = None
    for rec in run.reads:
        if prev_t0 is not None and rec[1] < prev_t0:
            client, k = client + 1, 0
        prev_t0 = rec[1]
        pool = run.read_pools[client]
        i = (client, k % len(pool))
        if i not in cache:
            cache[i] = lookup_least_bytes_u64(pool[i[1]], run.keys)
        total += cache[i]
        k += 1
    return 100.0 * total / H100_BYTES_PER_S / kernel_s

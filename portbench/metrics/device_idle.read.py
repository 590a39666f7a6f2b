"""``device_idle.read``: 1 minus the union of the device ops' intervals
over the traced window."""


def read(run):
    ev = run.events
    if ev is None or ev.window_us <= 0:
        return None
    return 1.0 - ev.busy_us() / ev.window_us

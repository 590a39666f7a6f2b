"""``lookup_unstaged_idle.read``: the share of the device-idle time inside
the program's ``lookup`` spans that no ``lookup.<stage>`` span covers,
over the traced window (what the stage metrics cannot place)."""

from portbench.spans import unstaged_idle_share


def read(run):
    return unstaged_idle_share(run)

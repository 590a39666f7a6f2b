"""``lookup_idle_launch_ms.read``: device-idle ms per ``Index.lookup`` call
under the program's spans ``lookup.sort``, ``lookup.search`` and
``lookup.unsort`` (the sort, the search launch and the unsort), over the
traced window."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "launch")

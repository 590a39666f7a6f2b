"""``lookup_idle_out_ms.read``: device-idle ms per ``Index.lookup`` call
under the program's spans ``lookup.copy_out`` and ``lookup.finish`` (the
copy of the answers to the host and the result's assembly), over the
traced window."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "out")

"""``lookup_idle_fixup_ms.read``: device-idle ms per ``Index.lookup`` call
under the program's spans ``lookup.fixup`` and ``lookup.oracle`` (the
fixup of escaped queries and an overflowed batch's oracle re-dispatch),
over the traced window."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "fixup")

"""``lookup_idle_in_ms.read``: device-idle ms per ``Index.lookup`` call
under the program's spans ``lookup.route``, ``lookup.prepare`` and
``lookup.copy_in`` (routing, the host's split and padding of the
queries, and their copy to the card), over the traced window."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "in")

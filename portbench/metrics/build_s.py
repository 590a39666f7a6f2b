"""``build_s``: the host build of the index in set-up
(``Index.build_seconds``: ``core/gaps.py::build_gapped`` under
``core/handle.py::Index.build``)."""


def read(run):
    return run.setup.get("build_s")

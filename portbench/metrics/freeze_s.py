"""``freeze_s``: the freeze of the built index into its device arrays in
set-up (``Index.stats["freeze_seconds"]``, ``kernels/freeze.py``)."""


def read(run):
    return run.setup.get("freeze_s")

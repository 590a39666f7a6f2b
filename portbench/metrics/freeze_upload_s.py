"""``freeze_upload_s``: the padded images' upload to the card
(``freeze.to_device``), a stage of the set-up's freeze
(``Index.stats["freeze_stages"]["upload"]``,
``kernels/delta.py::freeze_state``)."""

from portbench.spans import freeze_seconds


def read(run):
    return freeze_seconds(run, "upload")

"""``freeze_images_s``: the padded host images
(``freeze.freeze_numpy_headroom``), a stage of the set-up's freeze
(``Index.stats["freeze_stages"]["images"]``,
``kernels/delta.py::freeze_state``)."""

from portbench.spans import freeze_seconds


def read(run):
    return freeze_seconds(run, "images")

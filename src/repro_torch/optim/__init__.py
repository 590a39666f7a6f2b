"""Optimizers + schedules: the counterpart of ``repro.optim``.

adamw.py      AdamW with decoupled weight decay and global-norm clipping
adafactor.py  factored second moment + bf16 momentum — the 1T-param path
schedules.py  cosine and WSD (warmup-stable-decay, MiniCPM) schedules
compress.py   error-feedback int8 gradient compression for DP all-reduce
"""

from .adamw import adamw_init, adamw_update
from .adafactor import adafactor_init, adafactor_update
from .schedules import cosine_schedule, wsd_schedule
from .compress import compress_decompress, ef_compress_update, residual_init

OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}

# The trees of each optimizer's state that mirror the params, and in a
# param's entry of such a tree the slots shaped like the param (None:
# the entry is itself that slot).  The rest of a state (the step count,
# Adafactor's factored moments) has shapes of its own.
PARAM_SLOTS = {
    "adamw": {"m": None, "v": None},
    "adafactor": {"slots": ("m", "v")},
}

# In a param's entry of a tree of ``PARAM_SLOTS``, the factored slots:
# each is the param with one dim averaged away, the dim named here
# (Adafactor's row moment ``vr`` drops the last, its column moment
# ``vc`` the second-to-last).  A sharded state places such a slot by its
# param's spec less that dim, as the reference's dry run does; its
# update takes the mean over that dim on every rank of the axes the
# dim is split over (``adafactor_update``'s ``mean``).
FACTORED_SLOTS = {
    "adamw": {},
    "adafactor": {"vr": -1, "vc": -2},
}

__all__ = [
    "OPTIMIZERS",
    "PARAM_SLOTS",
    "FACTORED_SLOTS",
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "cosine_schedule",
    "wsd_schedule",
    "compress_decompress",
    "ef_compress_update",
    "residual_init",
]

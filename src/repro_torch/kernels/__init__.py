"""Device half of the port: freeze, window bounds, the lookup engine
and the hand-written CUDA kernel.

freeze.py  — padded f32/i32 images (``IndexArrays``) on one device
bounds.py  — query-safe window bounds, radix router, tile sizing
ref.py     — the device oracle stage and the epilogue, plain torch
lookup.py  — ``fused_lookup`` (launches csrc/fused_lookup.cu) and
             ``fused_lookup_plain`` (the same function in torch ops)
ops.py     — sort, tile schedule, launch, escape fixup, unsort;
             ``batched_lookup`` and ``QueryEngine``
_build.py  — nvcc + ctypes build of csrc/*.cu at first use
"""

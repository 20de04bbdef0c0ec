"""K1 (`composite_fwd_kernel`): the bound of its counted work (the larger
of bytes over 3.35 TB/s and f32 operations over 67 TFLOP/s) over its
device time in the traced frames, in %."""


def read(tr):
    return tr.roofline(('composite_fwd_kernel',), 'k1_ops', 'k1_bytes')

"""The traced steps' counted f32 operations over their wall time and 67
TFLOP/s, in %."""


def read(tr):
    return tr.mfu()

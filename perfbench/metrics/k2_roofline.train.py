"""K2 (`composite_bwd_kernel` and its `composite_bwd_combine` pass, which
programmatic dependent launch lets overlap it): the bound of its counted
work over the device time in which either ran in the traced steps (the
union of their intervals), in %."""


def read(tr):
    return tr.roofline(('composite_bwd_kernel', 'composite_bwd_combine'),
                       'k2_ops', 'k2_bytes')

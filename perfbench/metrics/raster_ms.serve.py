"""The program's spans `rasterize/*` (project, pairs, composite, untile)
summed, host ms a frame."""

SPANS = ('rasterize/project', 'rasterize/pairs', 'rasterize/composite',
         'rasterize/untile')


def read(tr):
    return tr.per_unit_ms(*SPANS)

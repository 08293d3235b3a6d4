"""Device milliseconds per traced headset frame of the operations
launched inside the program's ``gs.binning`` spans within
``gs.binocular``: both eyes' binning (pair enumeration, the ellipse cull,
the sort, K1 and the chunk layout)."""

from gsbench import spans


def read(run):
    return spans.span_device_ms(run, "gs.binning", within="gs.binocular")

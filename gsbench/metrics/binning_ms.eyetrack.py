"""Device milliseconds per traced frame of the operations launched inside
the program's ``gs.binning`` span, within ``gs.fovea``: step 0's binning."""

from gsbench import spans


def read(run):
    return spans.span_device_ms(run, "gs.binning", within="gs.fovea")

"""Device milliseconds per traced headset frame of the operations
launched inside the program's two ``gs.fovea`` spans within
``gs.binocular``: each eye's preprocess, binning, levels, K5 and
assembly (the activations both eyes share are outside them)."""

from gsbench import spans


def read(run):
    return spans.span_device_ms(run, "gs.fovea", within="gs.binocular")

"""Device milliseconds per traced headset frame of the operations
launched inside the program's ``gs.activate`` and ``gs.preprocess``
spans within ``gs.binocular``: the activations over every slot, once a
frame, and each eye's ``ops/projection.preprocess``."""

from gsbench import spans


def read(run):
    return spans.span_device_ms(run, ("gs.activate", "gs.preprocess"), within="gs.binocular")

"""Device milliseconds per traced frame of the operations launched inside
the program's ``gs.activate`` and ``gs.preprocess`` spans, within
``gs.fovea``: the foveated view's step-0 preprocess over every slot."""

from gsbench import spans


def read(run):
    return spans.span_device_ms(run, ("gs.activate", "gs.preprocess"), within="gs.fovea")

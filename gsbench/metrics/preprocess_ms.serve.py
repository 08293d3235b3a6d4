"""Device milliseconds per traced view of the operations launched inside
the program's ``gs.activate`` and ``gs.preprocess`` spans, within
``gs.render``: the activations and ``ops/projection.preprocess`` over
every slot."""

from gsbench import spans


def read(run):
    return spans.span_device_ms(run, ("gs.activate", "gs.preprocess"), within="gs.render")

"""Mean host milliseconds per request from the call of
``track_render.foveated_view`` to the frame synchronised on the device."""

from gsbench import readers


def read(run):
    return readers.mean_span_ms(run, "fovea")

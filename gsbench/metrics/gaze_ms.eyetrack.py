"""Mean host milliseconds of ``track_render.estimate_gaze`` per request:
the eye image's host preprocessing, RITnet and the pupil centroid, which
returns after the class map reaches the host."""

from gsbench import readers


def read(run):
    return readers.mean_span_ms(run, "gaze")

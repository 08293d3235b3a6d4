"""Host milliseconds per traced headset frame of the program's
``gs.gaze.prep`` span: both eyes' gamma, CLAHE and normalisation in
NumPy and their one upload."""

from gsbench import spans


def read(run):
    return spans.span_host_ms(run, "gs.gaze.prep")

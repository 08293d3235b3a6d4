"""Host milliseconds per traced frame of the program's ``gs.gaze.prep``
span: ``ritnet.preprocess_eye_image`` (gamma, CLAHE and normalisation in
NumPy, the upload)."""

from gsbench import spans


def read(run):
    return spans.span_host_ms(run, "gs.gaze.prep")

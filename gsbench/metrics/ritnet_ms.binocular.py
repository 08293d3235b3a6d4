"""Device milliseconds per traced headset frame of the operations
launched inside the program's ``gs.gaze.net`` span: RITnet's DenseNet2D
on both eyes (cuDNN, fp32) and the argmax."""

from gsbench import spans


def read(run):
    return spans.span_device_ms(run, "gs.gaze.net")

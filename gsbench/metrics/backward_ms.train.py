"""Mean milliseconds per traced step between the program's "loss" and
"backward" CUDA events."""

from gsbench import readers


def read(run):
    return readers.mean_event_ms(run, "loss", "backward")

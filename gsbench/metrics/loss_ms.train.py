"""Mean milliseconds per traced step between the program's "forward" and
"loss" CUDA events (``train_lib.make_train_step(events=...)``)."""

from gsbench import readers


def read(run):
    return readers.mean_event_ms(run, "forward", "loss")

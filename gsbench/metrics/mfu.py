"""Per cent of the mean request (or step) time, off the profiler, that
the least time of a sampled request's counted work takes on the chip's
peaks. Read for every ``mfu.<mix>`` metric."""

from gsbench import readers


def read(run):
    return readers.request_share(run)

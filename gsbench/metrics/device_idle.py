"""Per cent of the traced window with no operation on the device. Read
for every ``device_idle.<mix>`` metric."""

from gsbench import readers


def read(run):
    return readers.device_idle(run)

"""Kernel launch calls per traced step inside the program's
``gs.backward`` span, the autograd engine's own thread included."""

from gsbench import spans


def read(run):
    return spans.span_launches(run, "gs.backward")

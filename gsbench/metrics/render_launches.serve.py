"""Kernel launch calls per traced view inside the program's ``gs.render``
span."""

from gsbench import spans


def read(run):
    return spans.span_launches(run, "gs.render")

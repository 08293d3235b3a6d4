"""Per cent of the rows given to ``ops/projection.preprocess`` during the
traced views that are active: the program's ``gs.preprocess.active``
counter over its ``gs.preprocess.rows``."""

from gsbench import spans


def read(run):
    return spans.counter_percent(run, "gs.preprocess.active", "gs.preprocess.rows")

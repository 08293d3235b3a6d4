"""Per cent of the rows given to ``ops/projection.preprocess`` during the
traced views that its hand-written kernel (K7) activated from the model's
raw parameters as it loaded them: the program's ``gs.preprocess.raw``
counter over its ``gs.preprocess.rows``. Left out (None) where no row was
counted as activated so: on the CPU, whose path is the plain one, and in
a program without that counter."""

from gsbench import spans

RAW = "gs.preprocess.raw"


def read(run):
    if not any(c.name == RAW for c in spans.program_counts(run)):
        return None
    return spans.counter_percent(run, RAW, "gs.preprocess.rows")

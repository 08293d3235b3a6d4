"""Per cent of the rows given to ``ops/projection.preprocess`` during the
traced views that went through its hand-written kernel (K7): the
program's ``gs.preprocess.kernel`` counter over its
``gs.preprocess.rows``. Left out (None) where no row was counted as
going through a kernel: on the CPU, whose path is the plain one, and in
a program without that counter."""

from gsbench import spans

KERNEL = "gs.preprocess.kernel"


def read(run):
    if not any(c.name == KERNEL for c in spans.program_counts(run)):
        return None
    return spans.counter_percent(run, KERNEL, "gs.preprocess.rows")

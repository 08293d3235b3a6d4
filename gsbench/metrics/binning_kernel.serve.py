"""Per cent of the pairs handed to ``ops/binning.build_sorted_instances``
during the traced views that went through its hand-written pipeline
(K8): the program's ``gs.binning.kernel`` counter over its
``gs.binning.pairs`` (each a view's enumerated pairs). Left out (None)
where no pair was counted as going through K8: on the CPU, whose path is
the plain one, and in a program without that counter."""

from gsbench import spans

KERNEL = "gs.binning.kernel"


def read(run):
    if not any(c.name == KERNEL for c in spans.program_counts(run)):
        return None
    return spans.counter_percent(run, KERNEL, "gs.binning.pairs")

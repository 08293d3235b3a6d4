"""Per cent of K5's (``blend_levels_kernel``) device time that the least
time of the sampled headset frames' foveated compositing work takes,
eye by eye: the kernel's launches in the trace, two per traced frame
(left, then right) in order, matched to each sampled frame's two eyes.
None unless the trace holds exactly two launches per traced frame."""

from gsbench import work


def read(run):
    if run.trace is None or not run.work:
        return None
    ops = run.trace.device_ops("blend_levels_kernel")
    if len(ops) != 2 * run.traced:
        return None
    bound = sum(work.least_seconds(**k5) for i in run.work for k5 in run.work[i]["k5_eyes"])
    spent = sum(ops[2 * i + e][2] - ops[2 * i + e][1] for i in run.work for e in (0, 1))
    return 100.0 * bound / spent if spent > 0 else None

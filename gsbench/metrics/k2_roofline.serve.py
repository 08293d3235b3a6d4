"""Per cent of K2's (``blend_fwd_kernel``) device time that the least
time of the sampled requests' compositing work takes."""

from gsbench import readers


def read(run):
    return readers.kernel_share(run, "blend_fwd_kernel", "k2")

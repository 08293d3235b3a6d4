"""Per cent of K3's (``blend_bwd_kernel``) device time that the least
time of the sampled steps' backward compositing work takes."""

from gsbench import readers


def read(run):
    return readers.kernel_share(run, "blend_bwd_kernel", "k3")

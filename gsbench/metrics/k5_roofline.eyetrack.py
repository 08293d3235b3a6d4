"""Per cent of K5's (``blend_levels_kernel``) device time that the least
time of the sampled requests' foveated compositing work takes."""

from gsbench import readers


def read(run):
    return readers.kernel_share(run, "blend_levels_kernel", "k5")

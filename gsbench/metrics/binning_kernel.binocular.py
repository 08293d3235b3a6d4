"""Per cent of the pairs binned during the traced headset frames (both
eyes) that went through the hand-written binning pipeline (K8): the
served view's reader, which counts over every traced request whatever
its spans."""

from gsbench.harness import load_metric

read = load_metric("binning_kernel.serve")

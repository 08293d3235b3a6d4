"""Per cent of the rows given to ``ops/projection.preprocess`` during the
traced headset frames (both eyes) that went through its hand-written
kernel (K7): the served view's reader, which counts over every traced
request whatever its spans."""

from gsbench.harness import load_metric

read = load_metric("preprocess_kernel.serve")

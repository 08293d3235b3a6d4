"""Per cent of the rows given to ``ops/projection.preprocess`` during the
traced headset frames (both eyes) that are active: the served view's
reader, which counts over every traced request whatever its spans."""

from gsbench.harness import load_metric

read = load_metric("active_rows.serve")

"""Spans and counters inside the program, for a profiler to read.

``span(name)`` marks a phase of a request and ``count(name, value)``
records how much work a phase was given. While tracing is off (the
default) each costs one flag test: ``span`` returns one shared no-op
context, ``spanned`` calls its function straight through, ``count``
returns at once; nothing is built, allocated, synchronised or recorded.

Tracing is on while a ``torch.profiler`` records (or ``emit_nvtx``,
anything that runs torch's profiler-start hook): the caller that owns the
profiler turns it on. Then a span enters
``torch.profiler.record_function(name)`` and lands in the profiler's
trace as a ``user_annotation``, on the clock of the device operations and
of the CUDA runtime calls that launched them: an operation belongs to the
span that was open when its launch call ran. Go by time, not by thread:
the autograd engine runs the backward on a thread of its own while the
caller waits inside ``gs.backward``. A count is kept as (name, value,
host ``time.perf_counter()``) without a sync; a device scalar stays a
tensor until ``counters()`` reads it, after the caller has synchronised.

On the card each span also leaves a device-side range over the work
launched inside it (a ``gpu_user_annotation``); ``device_ops`` leaves
those ranges out of a profiler's events, so that a sum of device time
reads the same with the spans as without them.

The spans, each inside its parent:

- ``gs.render`` (``renderer.render``): ``gs.activate``
  (``renderer.model_inputs``: ``renderer.activated``, or on the preprocess
  kernel's route the raw parameters packed, launching nothing),
  ``gs.preprocess`` (``ops/projection``),
  ``gs.binning`` (``build_sorted_instances`` and the chunk layout, in
  ``blend.Splat.forward``), ``gs.composite`` (``blend.blend_fwd``),
  ``gs.assemble`` (``blend.assemble_tiles``);
- ``gs.gaze`` (``track_render.estimate_gaze``): ``gs.gaze.prep``
  (``ritnet.preprocess_eye_images``: the upload, then gamma, CLAHE and
  normalisation on the device), ``gs.gaze.net`` (``DenseNet2D``, argmax),
  ``gs.gaze.centroid`` (``ritnet.pupil_centroids``: the class maps' copy
  to the host, where the host waits for RITnet, and the centroids);
- ``gs.fovea`` (``track_render.foveated_view``): ``gs.activate``,
  ``gs.preprocess`` and ``gs.binning`` (``amr.fovea_step0``),
  ``gs.levels`` (``assign_levels`` / ``gaze_levels``), ``gs.composite``
  (``blend.blend_levels``, ``blend.blend_round``), ``gs.assemble`` (the
  fused frame's stacking, interpolation and background);
- ``gs.binocular`` (``track_render.headset_frame``, a head-mounted
  display's frame): ``gs.gaze`` once (both eyes through one RITnet
  forward), ``gs.activate`` once (``track_render.binocular_frame``: the
  model inputs both eyes share), then ``gs.fovea`` for each eye;
- the train step (``train_lib.make_train_step``): ``gs.render``, then
  ``gs.loss``, ``gs.backward`` and ``gs.optimizer`` (Adam, the
  densification statistics, the step's aux).

The counters: ``gs.preprocess.rows`` (the rows ``preprocess`` was given),
``gs.preprocess.active`` (the active ones among them),
``gs.preprocess.kernel`` (the rows that went through its hand-written
kernel, K7; none on the CPU or where a gradient may be taken),
``gs.preprocess.raw`` (those of them that K7 activated from the model's
raw parameters, ``gaussian_model.RawGaussians``),
``gs.gaze.eyes`` (the eye images of one ``estimate_gaze`` forward: 1, or
2 for a headset's pair), ``gs.fovea.instances`` (the instances a
foveated view binned, ``num_instances``: a device scalar),
``gs.binning.pairs`` (the enumerated pairs handed to binning,
``num_enumerated``: a device scalar) and ``gs.binning.kernel`` (those
binned by its hand-written pipeline, K8; none on the CPU).
"""

from __future__ import annotations

import collections
import functools
import time
from typing import NamedTuple

import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as _profiler

# (name, value, host time); bounded, so a long profile keeps the newest
_records: collections.deque = collections.deque(maxlen=1 << 14)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Count(NamedTuple):
    name: str
    value: float
    t: float  # host time.perf_counter() when counted


def is_on() -> bool:
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context that marks ``name`` in the profiler's trace while tracing
    is on, and the shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: the whole call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value) -> None:
    """Record ``value`` (a number, or a device scalar read later) under
    ``name`` while tracing is on."""
    if _profiler._is_profiler_enabled:
        _records.append((name, value, time.perf_counter()))


def counters() -> list:
    """Every ``Count`` kept while tracing was on (the newest 16,384),
    device scalars read, which waits for them: call it once the work is
    synchronised. ``Count.t`` places each in its request."""
    return [Count(n, v.item() if isinstance(v, torch.Tensor) else v, t)
            for n, v, t in list(_records)]


def device_ops(events) -> list:
    """The device's own operations (kernels, copies, fills) among a torch
    profiler's ``events()``: CUDA events that are not a span's
    device-side range."""
    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]

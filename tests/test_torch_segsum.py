"""PyTorch port vs JAX package: the plain version of the segment sum
(kernel K4) against JAX ``segment_sum_bounds`` — its CPU branch, and the
TPU kernel ``_segsum_kernel`` itself run in interpret mode through the
same block layout as its wrapper. Cases: empty segments, repeated bounds,
bounds at S, N not a multiple of 128.

The tables hold multiples of 1/16 in [-4, 4]: every partial sum is exact
in float32 (and every value in bf16, which the TPU kernel splits its
products into), so all three must agree exactly; rtol 1e-6 would be the
stated tolerance, and the measured difference is 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gaussian_splatting_with_eye_tracking_tpu.ops import segsum as jseg
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import segsum as tseg
from tests.torch_helpers import assert_equal, to_torch


def _segsum_kernel_interpret(table, bounds, g_blk=128):
    """The non-interpret branch of JAX ``segment_sum_bounds``, run with
    ``interpret=True``: the TPU kernel's own block windows and DMAs."""
    rows, s = table.shape
    n = bounds.shape[0] - 1
    npad = -(-n // g_blk) * g_blk
    bpad = jnp.pad(bounds, (0, npad + 1 - bounds.shape[0]), constant_values=bounds[-1])
    starts = bpad[:-1].astype(jnp.float32).reshape(1, npad)
    ends = bpad[1:].astype(jnp.float32).reshape(1, npad)
    wc = jseg._ALIGN
    first, last = bpad[:npad:g_blk], bpad[g_blk::g_blk]
    w0 = (first // wc) * wc
    nchunks = jnp.maximum(-(-(last - w0) // wc), 0).astype(jnp.int32)
    table_p = jnp.concatenate([table, jnp.zeros((rows, wc + jseg._ALIGN), table.dtype)], axis=1)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(npad // g_blk,),
        in_specs=[pl.BlockSpec((1, g_blk), lambda b, *_: (0, b), memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, g_blk), lambda b, *_: (0, b), memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((rows, g_blk), lambda b, *_: (0, b), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, rows, wc), jnp.float32), pltpu.SemaphoreType.DMA((2,))],
    )
    out = pl.pallas_call(
        functools.partial(jseg._segsum_kernel, g_blk=g_blk, wc=wc, rows=rows),
        out_shape=jax.ShapeDtypeStruct((rows, npad), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(w0.astype(jnp.int32), nchunks, starts, ends, table_p)
    return np.asarray(out[:, :n])


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "empty_and_repeated":
        n, s = 300, 1500
        lengths = rng.integers(0, 12, n) * (rng.uniform(size=n) > 0.3)
    elif name == "bounds_at_s":
        n, s = 200, 700
        lengths = rng.integers(1, 6, n)
        lengths[-20:] = 0
    else:  # one long segment across several of the kernel's 512-wide windows
        n, s = 130, 3000
        lengths = rng.integers(0, 4, n)
        lengths[60] = 1400
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    bounds = np.minimum(bounds, s).astype(np.int32)
    if name == "bounds_at_s":
        s = int(bounds[-1])
    table = (rng.integers(-64, 65, (16, s)) / 16).astype(np.float32)
    return table, bounds


@pytest.mark.parametrize("name", ["empty_and_repeated", "bounds_at_s", "long_segment"])
def test_segment_sum_plain_matches_jax(name):
    table, bounds = _case(name)
    n = bounds.shape[0] - 1
    assert n % 128 and (np.diff(bounds) == 0).any()
    got = tseg.segment_sum_bounds_plain(to_torch(table), to_torch(bounds))
    assert got.shape == (16, n) and got.dtype == to_torch(table).dtype
    want_cpu = np.asarray(jseg.segment_sum_bounds(jnp.asarray(table), jnp.asarray(bounds),
                                                  interpret=True))
    want_kernel = _segsum_kernel_interpret(jnp.asarray(table), jnp.asarray(bounds))
    assert_equal(got, want_cpu)
    assert_equal(got, want_kernel)
    assert not got[:, np.diff(bounds) == 0].any()


def test_segment_sum_nine_rows_and_clamped_bounds():
    """The port takes any row count up to 16 (the backward passes 9) and
    clamps bounds to [0, S], as the JAX CPU branch does."""
    table, bounds = _case("empty_and_repeated")
    bounds = bounds.copy()
    bounds[-10:] = table.shape[1] + 50
    want = np.asarray(jseg.segment_sum_bounds(jnp.asarray(table), jnp.asarray(bounds),
                                              interpret=True))
    got = tseg.segment_sum_bounds(to_torch(table[:9]), to_torch(bounds))
    assert_equal(got, want[:9])


def test_segment_sum_wrapper_on_cpu_counts_nothing():
    table, bounds = _case("bounds_at_s")
    before = tseg.SEGSUM.launches
    got = tseg.segment_sum_bounds(to_torch(table), to_torch(bounds))
    assert_equal(got, tseg.segment_sum_bounds_plain(to_torch(table), to_torch(bounds)).numpy())
    assert tseg.SEGSUM.launches == before


def test_segment_sum_gather_plain_matches_jax():
    """The gather route: slot j reads column src[j] of the values (none
    where src[j] < 0), as JAX's segment sum of the gathered table; a
    record view of the same values gives the same bits."""
    table, bounds = _case("empty_and_repeated")
    rng = np.random.default_rng(5)
    s = int(bounds[-1])
    src = rng.permutation(table.shape[1])[:s].astype(np.int32)
    src[rng.uniform(size=s) < 0.1] = -1
    gathered = np.where(src >= 0, table[:, np.maximum(src, 0)], 0).astype(np.float32)
    want = np.asarray(jseg.segment_sum_bounds(jnp.asarray(gathered), jnp.asarray(bounds),
                                              interpret=True))
    values = to_torch(table[:9])
    got = tseg.segment_sum_gather(values, to_torch(src), to_torch(bounds))
    assert_equal(got, want[:9])
    storage = tseg.records(table.shape[1], "cpu")
    storage[:, :9] = values.T
    rec = tseg.record_rows(storage, 9)
    assert rec.stride() == (1, tseg.REC) and torch.equal(rec, values)
    assert_equal(tseg.segment_sum_gather(rec, to_torch(src), to_torch(bounds)), want[:9])

"""Tile binning: duplicate gaussians per overlapped tile, depth-sort, ranges.

Port of ``Binning``, ``SortedInstances``, ``_tile_ellipse_kept``,
``gaze_decimation_keep`` and ``build_sorted_instances`` from
``gaussian_splatting_with_eye_tracking_tpu/ops/binning.py``. On CUDA
tensors ``build_sorted_instances`` launches the hand-written pipeline K8
(``csrc/binning.cu``, ``build_sorted_instances_kernel``): the tile scan,
the cull of every enumerated pair into a bitmask, the kept pairs' keys
written at their kept-order index, one radix sort of the keys'
significant bits, and one layout launch that writes the compositors'
(FEAT, K') rows, the CSR offsets and the per-gaussian ranges: two launch
calls, 22 device operations, no synchronisation. On CPU tensors it runs
the plain version, ``build_sorted_instances_plain``:

  1. compact the live gaussians' 16 attribute columns, keeping their
     original order (a stable sort on the dead flag);
  2. run-length expand the compact table to the enumeration's K slots
     (``ops/expand.py``; kernel K1 on a CUDA tensor): slot k's gaussian
     attributes with no per-slot index vector;
  3. decode each slot's tile, cull it with the exact ellipse-vs-tile test,
     and sort the slots once on a packed int64 (tile, depth rank) key; the
     10 feature rows follow the sort permutation and form the blend
     kernel's SoA input (with ``gaze_decim``, the foveated decimation
     drops a gaze-dependent share of the slots before the sort);
  4. for the backward, each sorted instance's position in gaussian-id
     order (``id_pos``), from the same permutation.

Kept instances have unique keys, so ``gauss_id[:num_instances]`` and the
feature rows there are exactly the JAX package's, and K8's equal the
plain version's bit for bit on every field of the listed instances; dead
lanes (past the listed instances) may differ: K8 leaves zeros there.

``bin_gaussians`` is the port of the JAX function of that name, the
binning of the ``impl="jnp"`` oracle path: the same list by another route
(a gather per slot from a prefix sum of start marks, no expand, no
feature rows), for cross-checks of the routes above.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import expand as expand_ops

_P, _I = ctypes.c_void_p, ctypes.c_int
_GAUSSIANS = [_P] * 9  # means2d, conics, rgb, opacities, tiles, rect_min, rect_max, cull_thr, depths
BINNING_SORT = backend.CudaKernel(
    "binning", "binning", "binning_sort_launch",
    _GAUSSIANS + [_I] * 7 + [_P, _P] + [_I] * 4 + [_P, ctypes.c_longlong, _P, _P, _P,
                                                  ctypes.POINTER(ctypes.c_int), _P],
)
BINNING_LAYOUT = backend.CudaKernel(
    "binning_layout", "binning", "binning_layout_launch",
    _GAUSSIANS + [_I] * 7 + [_P, ctypes.c_longlong] + [_P] * 7 + [_P],
)


class Binning(NamedTuple):
    """Sorted duplicate-instance list."""

    gauss_id: torch.Tensor  # (K,) int32 gaussian index per instance (sorted)
    tile_id: torch.Tensor  # (K,) int32, sentinel num_tiles for padding
    offsets: torch.Tensor  # (num_tiles+1,) int32 CSR offsets into the K axis
    num_instances: torch.Tensor  # () int32 live (culled) duplicate count
    num_enumerated: torch.Tensor  # () int32 rect pairs before the ellipse cull
    overflow: torch.Tensor  # () bool, either capacity exceeded
    gauss_start: torch.Tensor  # (N,) int32 pre-sort start of gaussian's instances
    gauss_count: torch.Tensor  # (N,) int32 instances kept per gaussian


class SortedInstances(NamedTuple):
    binning: Binning
    # (10, max_live) f32 depth-sorted instance rows in the blend kernel's
    # SoA order: [x, y, conic_a, conic_b, conic_c, r, g, b, opacity, gauss_id]
    feat_rows: torch.Tensor
    # (max_live,) int64 position of each sorted instance in gaussian-id
    # order (gaussian g's instances fill [gauss_start[g], gauss_start[g] +
    # gauss_count[g])); max_instances past the live instances
    id_pos: torch.Tensor
    # (FEAT, K') f32 the compositors' input: ``lead`` empty lanes, then
    # feat_rows, zero-padded to a chunk multiple (``blend.feat_soa_from_rows``);
    # K8 writes it directly, feat_rows is then a view of it. Rows 10-15,
    # which no compositor reads, are zeros in the plain version's and
    # unwritten in K8's
    feat_soa: torch.Tensor
    lead: int


def _tile_ellipse_kept(tx, ty, cx, cy, ca, cb, cc, thr, tile_px):
    """True iff some pixel of tile (tx, ty) can pass the blend's
    alpha >= 1/255 gate: the minimum over the tile's pixel rect of
    q = 0.5(ca dx^2 + cc dy^2) + cb dx dy is <= thr = ln(255 op). q is
    convex, so its minimum is 0 (center inside) or on one of the 4 edges
    (clamped 1D minimizations); the conic is pre-divided by thr and the
    comparison keeps 1e-4 of slack. Formula for formula the JAX one."""
    inv_thr = 1.0 / torch.clamp_min(thr, 1e-20)
    ca = ca * inv_thr
    cb = cb * inv_thr
    cc = cc * inv_thr
    x0 = (tx * tile_px).to(torch.float32) - cx
    y0 = (ty * tile_px).to(torch.float32) - cy
    x1 = x0 + (tile_px - 1)
    y1 = y0 + (tile_px - 1)

    def q_at(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    cc_s = torch.where(cc > 1e-12, cc, torch.full_like(cc, 1e-12))
    ca_s = torch.where(ca > 1e-12, ca, torch.full_like(ca, 1e-12))
    dy_l = torch.minimum(torch.maximum(-cb * x0 / cc_s, y0), y1)
    dy_r = torch.minimum(torch.maximum(-cb * x1 / cc_s, y0), y1)
    dx_b = torch.minimum(torch.maximum(-cb * y0 / ca_s, x0), x1)
    dx_t = torch.minimum(torch.maximum(-cb * y1 / ca_s, x0), x1)
    q_edges = torch.minimum(
        torch.minimum(q_at(x0, dy_l), q_at(x1, dy_r)),
        torch.minimum(q_at(dx_b, y0), q_at(dx_t, y1)),
    )
    # corners cover a non-PSD conic, where an edge minimizer is a maximum
    q_corners = torch.minimum(
        torch.minimum(q_at(x0, y0), q_at(x1, y0)),
        torch.minimum(q_at(x0, y1), q_at(x1, y1)),
    )
    inside = (x0 <= 0.0) & (x1 >= 0.0) & (y0 <= 0.0) & (y1 >= 0.0)
    qmin = torch.where(inside, torch.zeros_like(q_edges),
                       torch.minimum(q_edges, q_corners))
    return qmin <= 1.0 + 1e-4


def gaze_decimation_keep(tx, ty, gid, gaze_xy, radii, steps, tile_px):
    """Binning-time foveated decimation: keep gaussian ``gid``'s instance
    in tile (tx, ty) iff gid % step == (ty*797 + tx) % step, where step is
    ``steps[L-1]`` for the tile's gaze-ring level L (4 inside radii[0], one
    less past each further ring, by squared tile-centre distance as
    ``ops/amr.gaze_levels`` computes it). Formula for formula the JAX
    one."""
    cx = tx.to(torch.float32) * tile_px + tile_px / 2.0 - gaze_xy[0]
    cy = ty.to(torch.float32) * tile_px + tile_px / 2.0 - gaze_xy[1]
    d2 = cx * cx + cy * cy
    lvl = 4 - ((d2 > radii[0] * radii[0]).to(torch.int64)
               + (d2 > radii[1] * radii[1]).to(torch.int64)
               + (d2 > radii[2] * radii[2]).to(torch.int64))
    st = torch.ones_like(lvl)
    for level in (1, 2, 3, 4):
        if steps[level - 1] > 1:
            st = torch.where(lvl == level, torch.full_like(st, steps[level - 1]), st)
    tile_hash = ty * 797 + tx  # odd multiplier decorrelates rows
    return (gid % st) == (tile_hash % st)


def bin_gaussians(prep, grid_x: int, grid_y: int, max_instances: int, tile_px: int = 32,
                  max_live: int | None = None) -> Binning:
    """The sorted instance list of a ``projection.Preprocessed``, by JAX's
    gather formulation. ``max_instances`` bounds the rect enumeration,
    ``max_live`` the ellipse-culled instances kept in the sorted list
    (culled and dropped slots sort past the live prefix, so truncating
    there is exact); ``overflow`` reports either.

    Slot k's gaussian comes from a +1 at every gaussian's first slot
    (those past the capacity dropped) and a prefix sum; its tile from the
    rect decode, then the exact ellipse cull and one sort of a (tile,
    depth rank) key, the id coming back through the depth order. JAX packs
    that key into int32 when tile and rank bits fit 32 (and every slot,
    dead ones too, then equals JAX's) and otherwise sorts on (tile,
    depth); the port's key is int64, so it always packs, and the kept
    instances come out the same either way. Grids under 1024 tiles a
    side, as JAX's packed rect assumes. ``gauss_start`` / ``gauss_count``:
    each gaussian's kept instances in its pre-sort range."""
    if max_live is None:
        max_live = max_instances
    max_live = min(max_live, max_instances)
    num_tiles = grid_x * grid_y
    dev = prep.means2d.device
    tiles = prep.tiles_touched.to(torch.int64)
    n = tiles.shape[0]
    cum = torch.cumsum(tiles, 0)
    total = cum[-1]
    overflow = total > max_instances
    excl = cum - tiles

    k = torch.arange(max_instances, dtype=torch.int64, device=dev)
    starts = excl[excl < max_instances]
    mark = torch.zeros(max_instances, dtype=torch.int64, device=dev).index_add_(
        0, starts, torch.ones_like(starts))
    valid = k < total
    g = torch.clamp(torch.where(valid, torch.cumsum(mark, 0) - 1, 0), 0, n - 1)

    rank_bits = max(1, (n - 1).bit_length())
    order = torch.argsort(prep.depths, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    width_r = torch.clamp_min(prep.rect_max[:, 0] - prep.rect_min[:, 0], 1).to(torch.int64)
    r = k - excl[g]
    w_r = width_r[g]
    tx = prep.rect_min[g, 0].to(torch.int64) + r % w_r
    ty = prep.rect_min[g, 1].to(torch.int64) + r // w_r
    kept = valid
    if prep.cull_thr is not None:
        kept = valid & _tile_ellipse_kept(
            tx, ty, prep.means2d[g, 0], prep.means2d[g, 1], prep.conics[g, 0],
            prep.conics[g, 1], prep.conics[g, 2], prep.cull_thr[g], tile_px)
    tile_id = torch.where(kept, ty * grid_x + tx, num_tiles)
    overflow = overflow | (kept.sum() > max_live)

    key = (tile_id << rank_bits) | torch.where(valid, rank[g], 0)
    key_sorted = torch.sort(key).values[:max_live]
    tile_sorted = (key_sorted >> rank_bits).to(torch.int32)
    gauss_sorted = order[key_sorted & ((1 << rank_bits) - 1)]

    offsets = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        right=False).to(torch.int32)

    # gaussian g's slots are [excl_g, cum_g) cut at the capacity, so its
    # kept count is a difference of the kept prefix sum at consecutive starts
    kc = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.cumsum(kept.to(torch.int64), 0)])
    live_start = kc[torch.clamp_max(excl, max_instances)]
    kc_end = kc[torch.clamp_max(total, max_instances)]
    live_count = torch.cat([live_start[1:], kc_end[None]]) - live_start
    return Binning(
        gauss_id=gauss_sorted.to(torch.int32),
        tile_id=tile_sorted,
        offsets=offsets,
        num_instances=kc[-1].to(torch.int32),
        num_enumerated=total.to(torch.int32),
        overflow=overflow,
        gauss_start=live_start.to(torch.int32),
        gauss_count=live_count.to(torch.int32),
    )


def compact_table(means2d, conics, rgb, opacities, tiles_touched, rect_min,
                  rect_max, cull_thr, depths):
    """The (16, N) compact attribute table that the expand step reads, live
    gaussians first in their original order. Row 0 is each gaussian's
    first enumeration slot (exclusive cumsum of tiles_touched) and doubles
    as the expand's segment-start row: +inf on dead gaussians. All int
    fields are exact float32 values (< 2^24). Also returns the inclusive
    cumsum of tiles_touched (int64)."""
    n = tiles_touched.shape[0]
    tiles = tiles_touched.to(torch.int64)
    cum = torch.cumsum(tiles, 0)
    excl = cum - tiles
    live = tiles > 0
    order = torch.argsort(depths, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    width_r = torch.clamp_min(rect_max[:, 0] - rect_min[:, 0], 1)
    f32 = torch.float32
    cols = [
        torch.where(live, excl.to(f32), torch.full_like(means2d[:, 0], float("inf"))),
        (rect_min[:, 0] * 1024 + width_r).to(f32),
        rect_min[:, 1].to(f32),
        rank.to(f32),
        means2d[:, 0], means2d[:, 1],
        conics[:, 0], conics[:, 1], conics[:, 2],
        torch.clamp_min(cull_thr, 0.0),
        rgb[:, 0], rgb[:, 1], rgb[:, 2],
        opacities,
        torch.arange(n, dtype=f32, device=means2d.device),  # gaussian id
        depths,
    ]
    perm = torch.argsort((~live).to(torch.int8), stable=True)
    table = torch.stack(cols, dim=0)[:, perm].contiguous()
    return table, cum


def build_sorted_instances(
    means2d, conics, rgb, opacities, tiles_touched, rect_min, rect_max,
    cull_thr, depths, grid_x: int, grid_y: int, max_instances: int,
    tile_px: int, max_live: int | None = None, gaze_decim=None, lane_offset=None,
) -> SortedInstances:
    """Depth-sorted CSR instance list and its feature rows.

    ``max_instances`` bounds the rect enumeration (every gaussian x
    tile-in-rect pair), ``max_live`` the instances that survive the
    ellipse cull into the sorted list; ``overflow`` reports either.
    ``gaze_decim`` = (gaze_xy (2,), radii (3,), four per-level steps) also
    drops the instances ``gaze_decimation_keep`` rejects. ``lane_offset``,
    if given, maps ``num_instances`` to the empty lanes put before the
    instances in ``feat_soa`` (``blend.Splat``'s bands).

    K8 (``build_sorted_instances_kernel``) on CUDA tensors, the plain
    version on CPU tensors. Counts ``gs.binning.pairs`` (the enumerated
    pairs, a device scalar) while tracing is on; K8 counts them again as
    ``gs.binning.kernel``."""
    route = (build_sorted_instances_plain if means2d.device.type == "cpu"
             else build_sorted_instances_kernel)
    si = route(means2d, conics, rgb, opacities, tiles_touched, rect_min, rect_max,
               cull_thr, depths, grid_x, grid_y, max_instances, tile_px, max_live=max_live,
               gaze_decim=gaze_decim, lane_offset=lane_offset)
    tracing.count("gs.binning.pairs", si.binning.num_enumerated)
    return si


@functools.lru_cache(maxsize=64)
def _workspace_bytes(n: int, k: int, end_bit: int) -> int:
    """Bytes of K8's workspace (its buffers and CUB's sort storage, whose
    size CUB's query gives once per shape here)."""
    query = backend.library_function("binning", "binning_workspace_bytes", [_I, _I, _I],
                                     ctypes.c_longlong)
    size = query(n, k, end_bit)
    if size < 0:
        raise RuntimeError(f"binning: workspace query failed with CUDA error {-size}")
    return size


def build_sorted_instances_kernel(
    means2d, conics, rgb, opacities, tiles_touched, rect_min, rect_max,
    cull_thr, depths, grid_x: int, grid_y: int, max_instances: int,
    tile_px: int, max_live: int | None = None, gaze_decim=None, lane_offset=None,
) -> SortedInstances:
    """``build_sorted_instances_plain`` by K8 (``csrc/binning.cu``): two
    launch calls, one workspace from the caching allocator, no
    synchronisation (but ``lane_offset``'s own). Every field is the plain
    version's on the listed instances; dead lanes hold zeros (``gauss_id``
    0, ``tile_id`` num_tiles, ``id_pos`` max_instances, as there)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend

    if max_live is None:
        max_live = max_instances
    max_live = min(max_live, max_instances)
    f32, i32 = torch.float32, torch.int32
    # the plain preprocess hands out views (depths is a column of p_view)
    gauss = tuple(t.contiguous() for t in (means2d, conics, rgb, opacities, tiles_touched,
                                           rect_min, rect_max, cull_thr, depths))
    for name, t, dtype in zip(("means2d", "conics", "rgb", "opacities", "tiles_touched",
                               "rect_min", "rect_max", "cull_thr", "depths"), gauss,
                              (f32, f32, f32, f32, i32, i32, i32, f32, f32)):
        backend.check_cuda_tensor(name, t, dtype)
    n = tiles_touched.shape[0]
    num_tiles = grid_x * grid_y
    if not 0 < n < 1 << 31 or not 0 < max_instances < 1 << 31:
        raise ValueError(f"binning: {n} gaussians, capacity {max_instances}")
    if not 0 < grid_x < 1024 or not 0 < grid_y < 1024:
        raise ValueError(f"binning: a {grid_x}x{grid_y} grid (under 1024 tiles a side)")
    dev = means2d.device
    end_bit = 32 + num_tiles.bit_length()  # depth bits below the tile (sentinel included)
    ws_bytes = _workspace_bytes(n, max_instances, end_bit)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    num_instances = torch.empty((), dtype=i32, device=dev)
    num_enumerated = torch.empty((), dtype=i32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    gaze_xy = gaze_radii = None
    steps = (1, 1, 1, 1)
    if gaze_decim is not None:
        gxy, g_radii, g_steps = gaze_decim
        gaze_xy = torch.as_tensor(gxy, dtype=f32, device=dev).contiguous()
        gaze_radii = torch.as_tensor(g_radii, dtype=f32, device=dev).contiguous()
        steps = tuple(int(x) for x in g_steps)
    stream = backend.stream_ptr(means2d)
    ptrs = [t.data_ptr() for t in gauss]
    selector = ctypes.c_int(-1)
    BINNING_SORT(*ptrs, n, max_instances, max_live, grid_x, num_tiles, tile_px, end_bit,
                 None if gaze_xy is None else gaze_xy.data_ptr(),
                 None if gaze_radii is None else gaze_radii.data_ptr(), *steps,
                 ws.data_ptr(), ws_bytes, num_instances.data_ptr(), num_enumerated.data_ptr(),
                 overflow.data_ptr(), ctypes.byref(selector), stream)
    lead = 0 if lane_offset is None else int(lane_offset(num_instances))
    kp = lead + max_live + (-(lead + max_live)) % blend.CHUNK
    feat_soa = torch.empty((blend.FEAT, kp), dtype=f32, device=dev)
    gauss_id = torch.empty(max_live, dtype=i32, device=dev)
    tile_id = torch.empty(max_live, dtype=i32, device=dev)
    id_pos = torch.empty(max_live, dtype=torch.int64, device=dev)
    offsets = torch.empty(num_tiles + 1, dtype=i32, device=dev)
    gauss_start = torch.empty(n, dtype=i32, device=dev)
    gauss_count = torch.empty(n, dtype=i32, device=dev)
    BINNING_LAYOUT(*ptrs, n, max_instances, max_live, num_tiles, selector.value,
                   lead, kp, ws.data_ptr(), ws_bytes, feat_soa.data_ptr(), gauss_id.data_ptr(),
                   tile_id.data_ptr(), id_pos.data_ptr(), offsets.data_ptr(),
                   gauss_start.data_ptr(), gauss_count.data_ptr(), stream)
    tracing.count("gs.binning.kernel", num_enumerated)
    b = Binning(gauss_id=gauss_id, tile_id=tile_id, offsets=offsets,
                num_instances=num_instances, num_enumerated=num_enumerated, overflow=overflow,
                gauss_start=gauss_start, gauss_count=gauss_count)
    return SortedInstances(binning=b, feat_rows=feat_soa[:10, lead:lead + max_live],
                           id_pos=id_pos, feat_soa=feat_soa, lead=lead)


def build_sorted_instances_plain(
    means2d, conics, rgb, opacities, tiles_touched, rect_min, rect_max,
    cull_thr, depths, grid_x: int, grid_y: int, max_instances: int,
    tile_px: int, max_live: int | None = None, gaze_decim=None, lane_offset=None,
) -> SortedInstances:
    """``build_sorted_instances`` as tensor operations (the module's
    docstring), on any device."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend

    if max_live is None:
        max_live = max_instances
    max_live = min(max_live, max_instances)
    num_tiles = grid_x * grid_y
    n = tiles_touched.shape[0]
    dev = means2d.device
    rank_bits = max(1, (n - 1).bit_length())

    table, cum = compact_table(
        means2d, conics, rgb, opacities, tiles_touched, rect_min, rect_max,
        cull_thr, depths)
    total = cum[-1]
    overflow = total > max_instances

    x16 = expand_ops.expand_rows_by_segments(table, seg_row=0, k=max_instances)

    k_iota = torch.arange(max_instances, dtype=torch.int64, device=dev)
    valid = k_iota < total
    # slots past the enumeration may carry the +inf segment marker: mask
    # before the int cast
    e = torch.where(valid, x16[0], torch.zeros_like(x16[0])).to(torch.int64)
    rectp = x16[1].to(torch.int64)
    miny = x16[2].to(torch.int64)
    rank_k = x16[3].to(torch.int64)
    r = k_iota - e
    w_r = torch.clamp_min(rectp & 1023, 1)
    tx = (rectp >> 10) + r % w_r
    ty = miny + r // w_r
    kept = valid & _tile_ellipse_kept(
        tx, ty, x16[4], x16[5], x16[6], x16[7], x16[8], x16[9], tile_px)
    if gaze_decim is not None:
        gxy, g_radii, g_steps = gaze_decim
        kept = kept & gaze_decimation_keep(
            tx, ty, x16[14].to(torch.int64), gxy, g_radii, tuple(g_steps), tile_px)
    tile_id = torch.where(kept, ty * grid_x + tx, torch.full_like(tx, num_tiles))

    n_live_total = kept.sum()
    overflow = overflow | (n_live_total > max_live)

    # (tile, depth rank) order; the rank is a stable argsort of depth, so
    # this is the JAX package's order for every kept instance
    key = (tile_id << rank_bits) | torch.where(valid, rank_k, torch.zeros_like(rank_k))
    key_sorted, perm = torch.sort(key, stable=True)
    perm = perm[:max_live]
    tile_sorted = (key_sorted[:max_live] >> rank_bits).to(torch.int32)
    feat_rows = torch.cat([x16[4:9], x16[10:15]])[:, perm]
    gauss_sorted = feat_rows[9].to(torch.int32)

    offsets = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        right=False).to(torch.int32)

    # per-gaussian live bounds: segments are contiguous, so
    # live_start[g] = kept slots before excl_g and the counts are the
    # differences of consecutive starts
    kc = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.cumsum(kept.to(torch.int64), 0)])
    excl = cum - tiles_touched.to(torch.int64)
    live_start = kc[torch.clamp_max(excl, max_instances)]
    kc_end = kc[torch.clamp_max(total, max_instances)]
    live_count = torch.cat([live_start[1:], kc_end[None]]) - live_start

    # kept slots are in gaussian-id order, so sorted instance i (pre-sort
    # slot perm[i]) sits at the count of kept slots before it
    id_pos = torch.where(torch.arange(max_live, device=dev) < offsets[-1], kc[perm],
                         torch.full_like(perm, max_instances))

    b = Binning(
        gauss_id=gauss_sorted,
        tile_id=tile_sorted,
        offsets=offsets,
        num_instances=kc[-1].to(torch.int32),
        num_enumerated=total.to(torch.int32),
        overflow=overflow,
        gauss_start=live_start.to(torch.int32),
        gauss_count=live_count.to(torch.int32),
    )
    lead = 0 if lane_offset is None else int(lane_offset(b.num_instances))
    return SortedInstances(binning=b, feat_rows=feat_rows, id_pos=id_pos,
                           feat_soa=blend.feat_soa_from_rows(feat_rows, blend.CHUNK, lead),
                           lead=lead)

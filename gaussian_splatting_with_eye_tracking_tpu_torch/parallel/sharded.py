"""Multi-device rendering and training: image rows in bands over the ranks.

Port of ``gaussian_splatting_with_eye_tracking_tpu/parallel/sharded.py``.
JAX runs one program per device inside ``shard_map``; here each rank (one
process on one device) runs the same function on its own part and the
ranks meet in the collectives of ``parallel/collectives.py``. A mesh axis
of n devices is a ``Mesh`` of n ranks (``make_mesh``).

- Tile bands (``sharded_render``, ``make_sharded_train_step``): the
  image's tile rows split into n bands of ``grid_y_local`` rows, band d on
  rank d; the parameters are replicated. Every rank preprocesses every
  gaussian, clips each tile rect to its band (gated by the original
  liveness) and composites its band. The training loss is the full
  image's (1-λ)·L1 + λ·(1-SSIM) computed band by band
  (``_band_local_loss``: a 5-row SSIM halo to each neighbour, one scalar
  sum over the ranks). The parameter gradients and the screen-space one
  are summed over the ranks after the backward, then Adam and the
  densification statistics run on every rank alike.
- Gaussian shards (``make_gauss_sharded_train_step``): the capacity's rows
  split over the same axis (``shard_model_state``). Each rank
  preprocesses its own rows, routes each row to every band its rect meets
  with one ``all_to_all`` of fixed blocks (``_band_exchange``), composites
  its band from what it received and computes the band-local loss; the
  backward routes the row gradients home by the reverse ``all_to_all``,
  and Adam and the statistics run on the local rows.

A band composites through ``ops/blend.render_tiles`` (``impl="kernels"``,
also ``"auto"``: the hand-written kernels K8, K2-K4 on CUDA tensors, their
plain versions on CPU tensors; JAX's ``render_tiles_pallas``) or
``binning.bin_gaussians`` + ``tile_blend.render_tiles_jnp``
(``impl="jnp"``, the oracles). The steps return ``(state, aux)`` with
JAX's ``loss``, ``l1``, ``psnr`` and ``overflow`` (any band or exchange
over its capacity, on every rank).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gaussian_splatting_with_eye_tracking_tpu_torch import renderer
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning as binning_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import tile_blend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import (
    CameraParams,
    Preprocessed,
    preprocess,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.rasterize import IMPLS
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import collectives as cc
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel.collectives import Mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "tiles", device=None) -> Mesh:
    """The mesh of the first ``n_devices`` ranks (all by default), as JAX's
    ``devs[:n]``. Fewer than the world size makes a subgroup, which every
    rank must call for; the ranks outside it get a mesh with rank -1.
    Without a process group, a one-rank mesh on ``device``."""
    mesh = multihost.make_global_mesh(axis, device)
    n = n_devices or mesh.size
    if n > mesh.size:
        raise ValueError(f"mesh of {n} devices asked for, {mesh.size} ranks run")
    if n == mesh.size:
        return mesh
    group = dist.new_group(ranks=list(range(n)))
    return mesh._replace(group=group, size=n, rank=mesh.rank if mesh.rank < n else -1)


def _grid(width, height, tile, n_bands):
    """(grid_x, grid_y_local): tile columns, and tile rows per band (the
    rows padded up to a multiple of the band count)."""
    grid_x = -(-width // tile)
    grid_y = -(-height // tile)
    return grid_x, -(-grid_y // n_bands)


def _check(mesh: Mesh, impl: str, tile: int):
    if not mesh.member:
        raise ValueError("this rank is not on the mesh")
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    if tile != blend.TILE:
        raise ValueError(f"tile {tile}: the port's tiles are {blend.TILE} pixels")


def _band_render(
    means3d, scales, quats, opacities, sh, active, means2d_offset,
    viewmatrix, projmatrix, campos, tan_fovx, tan_fovy,
    *, sh_degree, width, height, tile, max_instances_per_band, max_per_tile,
    grid_x, grid_y_local, n_bands, impl, mesh,
):
    """This rank's band: preprocess every gaussian, then bin and composite
    the band (``_band_composite_from_prep``). Returns (color (3, band_h,
    W'), final_t (band_h, W'), radii (N,), overflow (1,))."""
    cam = CameraParams(viewmatrix=viewmatrix, projmatrix=projmatrix, campos=campos,
                       tan_fovx=tan_fovx, tan_fovy=tan_fovy, width=width, height=height)
    prep = preprocess(means3d, scales, quats, opacities, sh, sh_degree, cam, tile=tile,
                      active_mask=active)
    color, final_t, overflow = _band_composite_from_prep(
        prep, means2d_offset, tile=tile, max_instances_per_band=max_instances_per_band,
        max_per_tile=max_per_tile, grid_x=grid_x, grid_y_local=grid_y_local, impl=impl,
        mesh=mesh)
    return color, final_t, prep.radii, overflow


def _band_composite_from_prep(
    prep: Preprocessed, means2d_offset,
    *, tile, max_instances_per_band, max_per_tile, grid_x, grid_y_local, impl, mesh,
):
    """Bin and composite this rank's band of tile rows from full-length
    preprocessed rows (``band_local``). Returns (color, final_t, overflow
    (1,))."""
    local = band_local(prep, means2d_offset, mesh.rank, tile, grid_y_local)
    means2d = local.means2d
    zeros = torch.zeros(3, device=means2d.device)
    if impl == "jnp":
        b = binning_ops.bin_gaussians(local, grid_x, grid_y_local, max_instances_per_band,
                                      tile_px=tile)
        color, final_t = tile_blend.render_tiles_jnp(
            means2d, local.conics, local.rgb, local.opacities, b.gauss_id, b.offsets,
            grid_x, grid_y_local, tile, zeros, max_per_tile=max_per_tile)
        overflow = b.overflow
    else:
        color, final_t, (_, _, overflow) = blend.render_tiles(
            local, means2d, grid_x, grid_y_local, zeros, max_instances_per_band,
            max_instances_per_band, lane_offset=functools.partial(_lane_offset, mesh))
    return color, final_t, overflow.reshape(1)


def _lane_offset(mesh: Mesh, num_instances: torch.Tensor) -> int:
    """Empty lanes before this band's sorted instances: the instances of the
    bands above it modulo the chunk. The whole image's list holds those
    first, so the band's chunks of 128 then align as there, and the tile
    exit (after a whole chunk) stops each tile where one device stops it.
    One gather of the live counts."""
    counts = cc.gather_stacked(num_instances.reshape(1).to(torch.int64), mesh)
    return int(counts[:mesh.rank].sum()) % blend.CHUNK


def band_local(prep: Preprocessed, means2d_offset, band: int, tile: int,
               grid_y_local: int) -> Preprocessed:
    """The rows as band ``band`` of ``grid_y_local`` tile rows bins them:
    each rect clipped to the band, ``means2d`` (plus the offset) shifted
    into the band's pixel frame."""
    y0 = band * grid_y_local
    shift = torch.tensor([0.0, float(y0 * tile)], device=prep.means2d.device)
    means2d = prep.means2d + means2d_offset - shift
    rmin_y = torch.clamp(prep.rect_min[:, 1] - y0, 0, grid_y_local)
    rmax_y = torch.clamp(prep.rect_max[:, 1] - y0, 0, grid_y_local)
    tiles = (prep.rect_max[:, 0] - prep.rect_min[:, 0]) * (rmax_y - rmin_y)
    # gate by the original liveness: culled or inactive rows keep their
    # rects (preprocess zeroes only tiles_touched and opacity), and would
    # come back here as zero-opacity instances that take list slots
    tiles = torch.where(prep.tiles_touched > 0, torch.clamp_min(tiles, 0),
                        torch.zeros_like(tiles))
    return prep._replace(
        means2d=means2d,
        rect_min=torch.stack([prep.rect_min[:, 0], rmin_y], -1),
        rect_max=torch.stack([prep.rect_max[:, 0], rmax_y], -1),
        tiles_touched=tiles.to(torch.int32),
    )


def sharded_render(
    mesh: Mesh,
    state: gm.GaussianModelState,
    cam: CameraParams,
    bg: torch.Tensor,
    *,
    max_sh_degree: int = 3,
    tile: int = 32,
    max_instances_per_band: int = 1 << 18,
    max_per_tile: int = 1024,
    impl: str = "auto",
):
    """Render with the tile rows in bands over the mesh (the state
    replicated). Returns (color (3, H, W), final_t (H, W), radii (N,),
    overflow (n_bands,)), the same on every rank."""
    _check(mesh, impl, tile)
    n_bands = mesh.size
    grid_x, grid_y_local = _grid(cam.width, cam.height, tile, n_bands)
    p = state.params
    color, final_t, radii, overflow = _band_render(
        *renderer.activated(state, max_sh_degree), state.active,
        torch.zeros((p.xyz.shape[0], 2), device=p.xyz.device),
        cam.viewmatrix, cam.projmatrix, cam.campos, cam.tan_fovx, cam.tan_fovy,
        sh_degree=max_sh_degree, width=cam.width, height=cam.height, tile=tile,
        max_instances_per_band=max_instances_per_band, max_per_tile=max_per_tile,
        grid_x=grid_x, grid_y_local=grid_y_local, n_bands=n_bands, impl=impl, mesh=mesh)
    full = cc.all_gather(torch.cat([color, final_t[None]]), mesh, dim=1)
    color = full[:3, :cam.height, :cam.width]
    final_t = full[3, :cam.height, :cam.width]
    color = color + final_t[None] * bg[:, None, None]
    overflow = cc.gather_stacked(overflow.to(torch.int32), mesh).reshape(-1) > 0
    return color, final_t, radii, overflow


_EXF = 16  # exchanged feature columns (15 used + valid flag)


def exchange_memory_bytes(n_local: int, n_bands: int, cap_exch: int,
                          multicast_bound: int = 0) -> int:
    """Per-device peak memory of one ``_band_exchange`` call, in bytes: the
    enumeration scratch (kmax slots of ~3 int32 columns) plus the fixed
    (n_bands*cap_exch, 16) f32 send and receive blocks; JAX's arithmetic."""
    mb = n_bands if multicast_bound <= 0 else min(multicast_bound, n_bands)
    kmax = n_local * mb if n_bands > 1 else n_local
    enum_bytes = kmax * 3 * 4
    block_bytes = 2 * n_bands * cap_exch * _EXF * 4
    return enum_bytes + block_bytes


_SSIM_HALO = 5  # 11x11 window: ssim_map row y depends on rows [y-5, y+5]


def _band_local_loss(color_band, final_t_band, gt_band, bg, mesh, n_bands,
                     width, height, band_h, lambda_dssim):
    """The full image's (1-λ)·L1 + λ·(1-SSIM), computed on this rank's band.

    The SSIM map at row y needs rows [y-5, y+5] only, so 5 rows from each
    neighbour suffice, and the zeros at the axis' ends are the
    convolution's zero padding at the image border. Rows and columns past
    the image are zeroed before the exchange and left out of every mean.
    One sum over the ranks (of the SSIM, |diff| and diff² sums) gives the
    terms, the same on every rank. Returns (loss, l1, mse, color band with
    the background)."""
    dev = color_band.device
    color = color_band + final_t_band[None] * bg[:, None, None]
    row = mesh.rank * band_h + torch.arange(band_h, device=dev)
    rmask = (row < height)[None, :, None]
    cmask = (torch.arange(color.shape[2], device=dev) < width)[None, None, :]
    mask = (rmask & cmask).to(color.dtype)
    color = color * mask
    gt_band = gt_band * mask
    both = torch.cat([color, gt_band], 0)  # (6, band_h, W')
    h = _SSIM_HALO
    up, down = cc.ppermute_halo(both[:, :h], both[:, band_h - h:], mesh)
    ext = torch.cat([up, both, down], 1)  # (6, band_h + 10, W')
    smap = ssim_ops.ssim_map(ext[None, :3], ext[None, 3:])[0][:, h:h + band_h]
    diff = color - gt_band
    sums = cc.psum(torch.stack([torch.sum(smap * mask), torch.sum(torch.abs(diff)),
                                torch.sum(diff * diff)]), mesh)
    npix = 3.0 * height * width
    l1, mse = sums[1] / npix, sums[2] / npix
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - sums[0] / npix)
    return loss, l1, mse, color


def _pad_gt_bands(gt, n_bands, band_h, width_padded):
    """(3, H, W) ground truth -> (3, n_bands*band_h, width_padded), zero
    padded so that it splits evenly into the bands."""
    return F.pad(gt, (0, width_padded - gt.shape[2], 0, n_bands * band_h - gt.shape[1]))


def shard_model_state(mesh: Mesh, state: gm.GaussianModelState) -> gm.GaussianModelState:
    """This rank's rows of every capacity-axis leaf (params, Adam moments,
    ``active``, the densification statistics); the SH degree and Adam's
    count as they are. Raises if the capacity does not divide by the mesh
    size (capacities are powers of two). Every rank passes the same
    state."""
    return multihost.shard_to_mesh(state, mesh, state.params.xyz.shape[0])


def _band_exchange(prep_local, mesh, n_bands, grid_y_local, cap_exch,
                   multicast_bound: int = 0):
    """Route each of this rank's preprocessed rows to every rank whose band
    of tile rows its rect meets, by one ``all_to_all`` of fixed (cap_exch,
    16) f32 blocks, one per (source, destination) pair.

    The (gaussian, band) pairs are enumerated as binning enumerates tiles
    (up to ``multicast_bound`` bands a gaussian, 0 for all) and ordered by
    one packed (band, gaussian) key; block b holds band b's rows in that
    order. Column 15 marks a valid row. Returns (recv (n_bands*cap_exch,
    16), overflow ()): overflow, on every rank, where a band's rows exceed
    ``cap_exch`` or a gaussian spans more bands than the bound. The
    backward sends the row gradients back by the reverse ``all_to_all``."""
    n_local = prep_local.means2d.shape[0]
    dev = prep_local.means2d.device
    i32 = torch.int32
    gbits = max(1, (n_local - 1).bit_length())
    if n_bands.bit_length() + gbits > 31:
        raise ValueError(
            f"band-exchange key overflow: {n_bands} bands x {n_local} local rows needs "
            f"{n_bands.bit_length() + gbits} bits > 31; shrink the per-device shard")
    with torch.no_grad():
        live = prep_local.tiles_touched > 0
        b_lo = torch.clamp(torch.div(prep_local.rect_min[:, 1], grid_y_local,
                                     rounding_mode="floor"), 0, n_bands - 1)
        b_hi = torch.clamp(torch.div(torch.clamp_min(prep_local.rect_max[:, 1], 1) - 1,
                                     grid_y_local, rounding_mode="floor"), 0, n_bands - 1)
        counts = torch.where(live, b_hi - b_lo + 1, 0).to(i32)  # bands touched

        mb = n_bands if multicast_bound <= 0 else min(multicast_bound, n_bands)
        kmax = n_local * mb if n_bands > 1 else n_local
        cum = torch.cumsum(counts, 0, dtype=i32)
        total = cum[-1]
        excl = cum - counts
        # slot k -> (gaussian g, band b_lo[g] + k - excl[g]): a +1 at every
        # gaussian's first slot, dead ones too, so that the prefix sum names
        # the last gaussian starting at or before k, the live one among
        # those that share a start (JAX marks only the live ones, which
        # names the wrong gaussian after a dead row; see ROADMAP). A first
        # slot past kmax falls into the trash slot.
        mark = torch.zeros(kmax + 1, dtype=i32, device=dev).index_add_(
            0, torch.clamp_max(excl, kmax), torch.ones_like(excl))[:kmax]
        g_of = torch.clamp(torch.cumsum(mark, 0, dtype=i32) - 1, 0, n_local - 1)
        del mark
        k = torch.arange(kmax, dtype=i32, device=dev)
        band = torch.where(k < total, b_lo[g_of] + (k - excl[g_of]), n_bands)
        del k
        key = (band << gbits) | g_of  # the sentinel band sorts last
        del band
        key, order = torch.sort(key, stable=True)
        slot_sorted = g_of[order]
        del g_of, order
        off = torch.searchsorted(
            key, (torch.arange(n_bands + 1, dtype=i32, device=dev) << gbits)).to(i32)
        del key
        per_band = off[1:] - off[:-1]
        overflow = torch.any(per_band > cap_exch) | (total > kmax)

        # destination slot s = b*cap_exch + j takes sorted slot off[b] + j
        s = torch.arange(n_bands * cap_exch, dtype=i32, device=dev)
        s_b = torch.div(s, cap_exch, rounding_mode="floor")
        s_j = s - s_b * cap_exch
        s_valid = s_j < per_band[s_b]
        g_src = slot_sorted[torch.clamp(torch.where(s_valid, off[s_b] + s_j, 0), 0, kmax - 1)]
        del s, s_b, s_j, slot_sorted

    cols = torch.cat([
        prep_local.means2d, prep_local.conics, prep_local.rgb,
        prep_local.opacities[:, None], prep_local.depths[:, None],
        prep_local.cull_thr[:, None], prep_local.rect_min.to(torch.float32),
        prep_local.rect_max.to(torch.float32),
        torch.ones((n_local, 1), device=dev),
    ], 1)  # (n_local, 16)
    # gathered, then masked in place: one block and the rows alive at once
    send = torch.index_select(cols, 0, g_src)
    del cols, g_src
    send = send.mul_(s_valid[:, None]).reshape(n_bands, cap_exch, _EXF)
    recv = cc.all_to_all(send, mesh).reshape(n_bands * cap_exch, _EXF)
    return recv, cc.pany(overflow, mesh)


def _prep_from_exchange(recv):
    """A band's ``Preprocessed`` from the rows it received. Invalid rows get
    an empty rect (no tiles) and zero opacity."""
    v = recv[:, 15] > 0.5
    rect_min = recv[:, 11:13].detach().to(torch.int32)
    rect_max = torch.where(v[:, None], recv[:, 13:15].detach().to(torch.int32), rect_min)
    tiles = torch.where(
        v, (rect_max[:, 0] - rect_min[:, 0]) * (rect_max[:, 1] - rect_min[:, 1]), 0,
    ).to(torch.int32)
    zero = torch.zeros((), device=recv.device)
    return Preprocessed(
        means2d=recv[:, 0:2],
        depths=torch.where(v, recv[:, 9], zero),
        conics=recv[:, 2:5],
        rgb=recv[:, 5:8],
        opacities=torch.where(v, recv[:, 8], zero),
        radii=tiles,  # placeholder; the statistics use the owner's radii
        tiles_touched=tiles,
        rect_min=rect_min,
        rect_max=rect_max,
        cull_thr=torch.where(v, recv[:, 10], zero).detach(),
    )


def _full_image_loss(color_band, final_t_band, gt, bg, mesh, width, height, lambda_dssim):
    """``loss_mode="full"``: the bands gathered on every rank and the
    full-image loss there (the parity path). Returns (loss, l1, mse)."""
    full = cc.all_gather(torch.cat([color_band, final_t_band[None]]), mesh, dim=1)
    color = full[:3, :height, :width] + full[3:4, :height, :width] * bg[:, None, None]
    l1 = torch.mean(torch.abs(color - gt))
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_ops.ssim(color, gt))
    return loss, l1, torch.mean((color - gt) ** 2)


def _make_step(mesh, tx, opt, max_sh_degree, width, height, tile, impl, loss_mode,
               band_loss, reduce_grads):
    """The train step around ``band_loss(params, offset, state, cam, gt, bg)
    -> (color_band, final_t_band, radii, overflow)``: the loss of
    ``loss_mode``, the backward, the gradient sum over the ranks when
    ``reduce_grads``, Adam and the densification statistics."""
    _check(mesh, impl, tile)
    if loss_mode not in ("band", "full"):
        raise ValueError(f"loss_mode {loss_mode!r} is not 'band' or 'full'")
    n_bands = mesh.size
    grid_x, grid_y_local = _grid(width, height, tile, n_bands)
    band_h = grid_y_local * tile

    def train_step(state, viewmatrix, projmatrix, campos, tan_fovx, tan_fovy, gt, bg,
                   accumulate_stats):
        cam = CameraParams(viewmatrix=viewmatrix, projmatrix=projmatrix, campos=campos,
                           tan_fovx=tan_fovx, tan_fovy=tan_fovy, width=width, height=height)
        params = gm.GaussianParams(*(v.detach().requires_grad_(True) for v in state.params))
        offset = torch.zeros((params.xyz.shape[0], 2), device=params.xyz.device,
                             requires_grad=True)
        color_band, final_t_band, radii, overflow = band_loss(
            state._replace(params=params), offset, cam, grid_x, grid_y_local)
        if loss_mode == "band":
            gt_band = _pad_gt_bands(gt, n_bands, band_h, grid_x * tile)[
                :, mesh.rank * band_h:(mesh.rank + 1) * band_h]
            loss, l1, mse, _ = _band_local_loss(
                color_band, final_t_band, gt_band, bg, mesh, n_bands, width, height,
                band_h, opt.lambda_dssim)
        else:
            loss, l1, mse = _full_image_loss(color_band, final_t_band, gt, bg, mesh,
                                             width, height, opt.lambda_dssim)
        grads = torch.autograd.grad(loss, [*params, offset])
        with torch.no_grad():
            if reduce_grads:  # one sum of every gradient, offset's included
                flat = cc.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh)
                grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]),
                                                       grads)]
            *g_params, g_offset = grads
            new_params, opt_state = tx.update(gm.GaussianParams(*g_params), state.opt_state,
                                              state.params)
            state = state._replace(params=new_params, opt_state=opt_state)
            if accumulate_stats:
                state = gm.add_densification_stats(state, g_offset, radii, width=width,
                                                   height=height)
            aux = {"loss": loss.detach(), "l1": l1.detach(),
                   "psnr": -10.0 * torch.log10(torch.clamp_min(mse.detach(), 1e-10)),
                   "overflow": cc.pany(overflow.any(), mesh)}
        return state, aux

    return train_step


def make_sharded_train_step(
    mesh: Mesh,
    tx: gm.Adam,
    opt,
    max_sh_degree: int,
    width: int,
    height: int,
    *,
    tile: int = 32,
    max_instances_per_band: int = 1 << 18,
    max_per_tile: int = 1024,
    impl: str = "auto",
    loss_mode: str = "band",
):
    """The tile-band train step (parameters replicated): this rank's band
    rendered, the band-local loss (``loss_mode="full"``: every rank
    gathers the image and takes the full-image loss, for parity), the
    backward, the gradients summed over the ranks, Adam. Returns
    ``train_step(state, viewmatrix, projmatrix, campos, tan_fovx,
    tan_fovy, gt, bg, accumulate_stats) -> (state, aux)``, ``gt`` the
    full (3, H, W) image on every rank."""

    def band_loss(state, offset, cam, grid_x, grid_y_local):
        return _band_render(
            *renderer.activated(state, max_sh_degree), state.active, offset,
            cam.viewmatrix, cam.projmatrix, cam.campos, cam.tan_fovx, cam.tan_fovy,
            sh_degree=max_sh_degree, width=width, height=height, tile=tile,
            max_instances_per_band=max_instances_per_band, max_per_tile=max_per_tile,
            grid_x=grid_x, grid_y_local=grid_y_local, n_bands=mesh.size, impl=impl,
            mesh=mesh)

    return _make_step(mesh, tx, opt, max_sh_degree, width, height, tile, impl, loss_mode,
                      band_loss, reduce_grads=True)


def make_gauss_sharded_train_step(
    mesh: Mesh,
    tx: gm.Adam,
    opt,
    max_sh_degree: int,
    width: int,
    height: int,
    *,
    tile: int = 32,
    max_instances_per_band: int = 1 << 18,
    max_per_tile: int = 1024,
    max_exchange_per_band: int = 1 << 16,
    exchange_multicast_bound: int = 0,
    impl: str = "auto",
    loss_mode: str = "band",
):
    """The gaussian-sharded train step for scenes one device cannot hold:
    the state is this rank's rows (``shard_model_state``). Each rank
    preprocesses its rows, exchanges them to the bands they meet
    (``_band_exchange``, ``max_exchange_per_band`` rows per source and
    band), composites its band and takes the band-local loss; the
    backward routes the row gradients home, and Adam and the statistics
    run on the local rows. Same call as ``make_sharded_train_step``'s
    step; the returned state stays sharded."""

    def band_loss(state, offset, cam, grid_x, grid_y_local):
        xyz, scales, quats, opacities, sh = renderer.activated(state, max_sh_degree)
        prep_local = preprocess(xyz, scales, quats, opacities, sh, max_sh_degree, cam,
                                tile=tile, active_mask=state.active)
        prep_local = prep_local._replace(means2d=prep_local.means2d + offset)
        recv, ex_overflow = _band_exchange(prep_local, mesh, mesh.size, grid_y_local,
                                           max_exchange_per_band, exchange_multicast_bound)
        prep = _prep_from_exchange(recv)
        color, final_t, overflow = _band_composite_from_prep(
            prep, torch.zeros_like(prep.means2d), tile=tile,
            max_instances_per_band=max_instances_per_band, max_per_tile=max_per_tile,
            grid_x=grid_x, grid_y_local=grid_y_local, impl=impl, mesh=mesh)
        return color, final_t, prep_local.radii, overflow | ex_overflow

    return _make_step(mesh, tx, opt, max_sh_degree, width, height, tile, impl, loss_mode,
                      band_loss, reduce_grads=False)

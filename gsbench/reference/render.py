"""Plain PyTorch reference of the renderer the benchmark holds the system to.

3D Gaussian Splatting's forward (Kerbl et al., SIGGRAPH 2023; the Inria
rasterizer's ``preprocessCUDA`` and ``renderCUDA``) with the system's tile
rule, written from the formulas and importing nothing of the system:

- preprocess: view-space depth > 0.2, projection to pixel centres, the EWA
  2D covariance with the 0.3 px low-pass, its conic, the 3-sigma radius
  and the opacity-aware tile rect (the ellipse on which alpha reaches
  1/255, capped at the radius); colour from degree-3 spherical harmonics;
- binning: every (gaussian, tile) pair of the rect whose tile holds a
  pixel at which the gaussian can reach alpha 1/255 (the minimum of the
  quadratic form over the tile's pixel rect), listed per tile in
  stable depth order;
- compositing, per pixel in that order: alpha = min(0.99, op exp(power)),
  skipped where power > 0 or alpha < 1/255; colour += alpha T c, T *=
  1 - alpha; in place of the Inria kernel's per-pixel stop at T < 1e-4,
  the system's tile rule (``_composite``), which decides which hidden
  gaussians get a gradient at all (a first Adam step moves every
  parameter with a gradient by its learning rate, however small).

The binning's per-tile counts are part of what the frame means (the tile
rule reads chunks at multiples of 128 of the tiles' concatenated lists,
and the foveated frame's levels are percentiles of the counts), so the
formulas that decide them are evaluated in the same float32 order as the system
states them. ``dtype`` runs everything in another precision (the
lower-precision control).

The work a frame needs is counted here, from these inputs: the pairs that
pass the alpha gate before their pixel's transmittance falls below 1e-4
("kept"), and the gaussians that contribute to at least one of them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

TILE = 32
NEAR = 0.2
LOW_PASS = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
LIST_CHUNK = 128  # the foveated decimation cuts the concatenated lists at multiples of it

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class Camera(NamedTuple):
    view: torch.Tensor  # (4, 4) world -> view, column vectors
    full: torch.Tensor  # (4, 4) projection @ view
    campos: torch.Tensor  # (3,)
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class Prep(NamedTuple):
    xy: torch.Tensor  # (N, 2) pixel centres
    depth: torch.Tensor  # (N,)
    conic: torch.Tensor  # (N, 3)
    rgb: torch.Tensor  # (N, 3)
    opacity: torch.Tensor  # (N,), 0 where not visible
    rect_min: torch.Tensor  # (N, 2) int64 tiles
    rect_max: torch.Tensor  # (N, 2) int64 tiles, exclusive
    ln_op: torch.Tensor  # (N,) ln(max(255 op, 1))
    visible: torch.Tensor  # (N,) bool


class Lists(NamedTuple):
    gid: torch.Tensor  # (K,) int64 gaussian of each listed pair, tile-major, depth order
    offsets: torch.Tensor  # (T + 1,) int64
    counts: torch.Tensor  # (T,) int64


def activate(raw: dict, dtype=torch.float32):
    """Raw parameters (xyz, f_dc, f_rest, scaling, rotation, opacity) ->
    (means, scales, quaternions, opacities, SH (N, 3, 16))."""
    r = {k: v.to(dtype) for k, v in raw.items()}
    return (r["xyz"], torch.exp(r["scaling"]), r["rotation"],
            torch.sigmoid(r["opacity"][:, 0]), torch.cat([r["f_dc"], r["f_rest"]], dim=-1))


def _sh_rgb(sh, means, campos):
    d = means - campos
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    c = SH_C0 * sh[..., 0]
    c = c - SH_C1 * y * sh[..., 1] + SH_C1 * z * sh[..., 2] - SH_C1 * x * sh[..., 3]
    c = (c + SH_C2[0] * xy * sh[..., 4] + SH_C2[1] * yz * sh[..., 5]
         + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6] + SH_C2[3] * xz * sh[..., 7]
         + SH_C2[4] * (xx - yy) * sh[..., 8])
    c = (c + SH_C3[0] * y * (3 * xx - yy) * sh[..., 9] + SH_C3[1] * xy * z * sh[..., 10]
         + SH_C3[2] * y * (4 * zz - xx - yy) * sh[..., 11]
         + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12]
         + SH_C3[4] * x * (4 * zz - xx - yy) * sh[..., 13]
         + SH_C3[5] * z * (xx - yy) * sh[..., 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[..., 15])
    return torch.clamp_min(c + 0.5, 0.0)


def _cov3d(scales, quats):
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
         2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
         2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))
    s = 1.0 * scales
    u0, u1, u2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    xx = R[0] * R[0] * u0 + R[1] * R[1] * u1 + R[2] * R[2] * u2
    xy = R[0] * R[3] * u0 + R[1] * R[4] * u1 + R[2] * R[5] * u2
    xz = R[0] * R[6] * u0 + R[1] * R[7] * u1 + R[2] * R[8] * u2
    yy = R[3] * R[3] * u0 + R[4] * R[4] * u1 + R[5] * R[5] * u2
    yz = R[3] * R[6] * u0 + R[4] * R[7] * u1 + R[5] * R[8] * u2
    zz = R[6] * R[6] * u0 + R[7] * R[7] * u1 + R[8] * R[8] * u2
    return xx, xy, xz, yy, yz, zz


def _cov2d(means, cov, view, focal_x, focal_y, tan_fovx, tan_fovy):
    t = means @ view[:3, :3].T + view[:3, 3]
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tz = t[..., 2]
    tz = torch.where(tz.abs() < 1e-4, torch.full_like(tz, 1e-4), tz)
    tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    v00, v01, v02, v11, v12, v22 = cov

    def wv_row(i):
        return (view[i, 0] * v00 + view[i, 1] * v01 + view[i, 2] * v02,
                view[i, 0] * v01 + view[i, 1] * v11 + view[i, 2] * v12,
                view[i, 0] * v02 + view[i, 1] * v12 + view[i, 2] * v22)

    a0, a1, a2 = wv_row(0), wv_row(1), wv_row(2)

    def m(ai, col):
        return ai[0] * view[col, 0] + ai[1] * view[col, 1] + ai[2] * view[col, 2]

    m00, m01, m02 = m(a0, 0), m(a0, 1), m(a0, 2)
    m11, m12, m22 = m(a1, 1), m(a1, 2), m(a2, 2)
    j00, j02 = focal_x * inv_z, -focal_x * tx * inv_z2
    j11, j12 = focal_y * inv_z, -focal_y * ty * inv_z2
    a = j00 * (j00 * m00 + j02 * m02) + j02 * (j00 * m02 + j02 * m22)
    b = j00 * (j11 * m01 + j12 * m02) + j02 * (j11 * m12 + j12 * m22)
    c = j11 * (j11 * m11 + j12 * m12) + j12 * (j11 * m12 + j12 * m22)
    return a + LOW_PASS, b, c + LOW_PASS


def _trunc_i64(x):
    return x.clamp(-float(1 << 30), float(1 << 30)).to(torch.int32).to(torch.int64)


def preprocess(means, scales, quats, opac, sh, cam: Camera) -> Prep:
    """Per-gaussian screen-space quantities of activated parameters."""
    dt = means.dtype
    dev = means.device
    view, full = cam.view.to(dt), cam.full.to(dt)
    gx, gy = -(-cam.width // TILE), -(-cam.height // TILE)
    tan_fovx = torch.tensor(cam.tan_fovx, dtype=dt, device=dev)
    tan_fovy = torch.tensor(cam.tan_fovy, dtype=dt, device=dev)
    depth = (means @ view[:3, :3].T + view[:3, 3])[:, 2]
    visible = depth > NEAR
    p_hom = means @ full[:3, :3].T + full[:3, 3]
    p_w = means @ full[3, :3] + full[3, 3]
    p_w = torch.where(visible, p_w + 1e-7, torch.ones_like(p_w))
    p = p_hom / p_w[:, None]
    mx = ((p[:, 0] + 1.0) * cam.width - 1.0) * 0.5
    my = ((p[:, 1] + 1.0) * cam.height - 1.0) * 0.5
    focal_x = cam.width / (2.0 * tan_fovx)
    focal_y = cam.height / (2.0 * tan_fovy)
    a, b, c = _cov2d(means, _cov3d(scales, quats), view, focal_x, focal_y, tan_fovx, tan_fovy)
    det = a * c - b * b
    visible = visible & (det != 0.0)
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(mid + disc, 0.0)))
    ln_op = torch.log(torch.clamp_min(255.0 * opac, 1.0))
    ext_x = torch.minimum(torch.ceil(torch.sqrt(torch.clamp_min(2.0 * a * ln_op, 1e-12))), radius)
    ext_y = torch.minimum(torch.ceil(torch.sqrt(torch.clamp_min(2.0 * c * ln_op, 1e-12))), radius)
    rmin = torch.stack([_trunc_i64((mx - ext_x) / TILE).clamp(0, gx),
                        _trunc_i64((my - ext_y) / TILE).clamp(0, gy)], -1)
    rmax = torch.stack([_trunc_i64((mx + ext_x + TILE - 1) / TILE).clamp(0, gx),
                        _trunc_i64((my + ext_y + TILE - 1) / TILE).clamp(0, gy)], -1)
    area = (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1])
    visible = visible & (area > 0)
    return Prep(xy=torch.stack([mx, my], -1), depth=depth, conic=conic,
                rgb=_sh_rgb(sh, means, cam.campos.to(dt)),
                opacity=torch.where(visible, opac, torch.zeros_like(opac)),
                rect_min=rmin, rect_max=rmax, ln_op=ln_op, visible=visible)


def _tile_reachable(tx, ty, cx, cy, ca, cb, cc, thr):
    """True where some pixel of tile (tx, ty) has 0.5 (a dx^2 + c dy^2) +
    b dx dy <= thr, with 1e-4 of slack: the quadratic form is convex, so
    its minimum over the pixel rect is 0 (centre inside) or on an edge;
    the corners cover a form that is not positive definite."""
    inv = 1.0 / torch.clamp_min(thr, 1e-20)
    ca, cb, cc = ca * inv, cb * inv, cc * inv
    x0 = (tx * TILE).to(ca.dtype) - cx
    y0 = (ty * TILE).to(ca.dtype) - cy
    x1, y1 = x0 + (TILE - 1), y0 + (TILE - 1)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    cc_s = torch.where(cc > 1e-12, cc, torch.full_like(cc, 1e-12))
    ca_s = torch.where(ca > 1e-12, ca, torch.full_like(ca, 1e-12))
    e = torch.minimum(
        torch.minimum(q(x0, torch.minimum(torch.maximum(-cb * x0 / cc_s, y0), y1)),
                      q(x1, torch.minimum(torch.maximum(-cb * x1 / cc_s, y0), y1))),
        torch.minimum(q(torch.minimum(torch.maximum(-cb * y0 / ca_s, x0), x1), y0),
                      q(torch.minimum(torch.maximum(-cb * y1 / ca_s, x0), x1), y1)))
    corners = torch.minimum(torch.minimum(q(x0, y0), q(x1, y0)),
                            torch.minimum(q(x0, y1), q(x1, y1)))
    inside = (x0 <= 0.0) & (x1 >= 0.0) & (y0 <= 0.0) & (y1 >= 0.0)
    return torch.where(inside, torch.zeros_like(e), torch.minimum(e, corners)) <= 1.0 + 1e-4


def tile_lists(prep: Prep, width: int, height: int, pair_block: int = 1 << 23) -> Lists:
    """Each tile's gaussians in stable depth order."""
    dev = prep.xy.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    n = prep.xy.shape[0]
    w = (prep.rect_max[:, 0] - prep.rect_min[:, 0]).clamp_min(0)
    area = torch.where(prep.visible, w * (prep.rect_max[:, 1] - prep.rect_min[:, 1]), 0)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(prep.depth.float(), stable=True)] = torch.arange(n, device=dev)
    gids = torch.nonzero(area > 0).flatten()
    keys = []
    # enumerate the rect pairs a block of gaussians at a time
    cum = torch.cumsum(area[gids], 0)
    lo = 0
    while lo < gids.shape[0]:
        base = int(cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(cum, base + pair_block, right=True))
        hi = max(hi, lo + 1)
        g = gids[lo:hi]
        cnt = area[g]
        gg = torch.repeat_interleave(g, cnt)
        start = torch.cumsum(cnt, 0) - cnt
        r = torch.arange(gg.shape[0], device=dev) - torch.repeat_interleave(start, cnt)
        wr = w[gg]
        tx = prep.rect_min[gg, 0] + r % wr
        ty = prep.rect_min[gg, 1] + r // wr
        f32 = torch.float32
        keep = _tile_reachable(tx, ty, prep.xy[gg, 0].to(f32), prep.xy[gg, 1].to(f32),
                               prep.conic[gg, 0].to(f32), prep.conic[gg, 1].to(f32),
                               prep.conic[gg, 2].to(f32),
                               torch.clamp_min(prep.ln_op[gg].to(f32), 0.0))
        keys.append((ty * gx + tx)[keep] * n + rank[gg[keep]])
        lo = hi
    key = torch.sort(torch.cat(keys) if keys else torch.zeros(0, dtype=torch.int64,
                                                              device=dev)).values
    order = torch.empty(n, dtype=torch.int64, device=dev)
    order[rank] = torch.arange(n, device=dev)
    counts = torch.bincount(key // n, minlength=gx * gy)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)])
    return Lists(gid=order[key % n], offsets=offsets, counts=counts)


def _composite(feat, gid, o, cnt, step, px, py, count_work):
    """Composite B tiles: their lists [o, o + cnt) of ``gid`` (positions in
    the tiles' concatenated lists) at pixels px, py (B, P), in the
    system's tile rule: a tile's list is read in chunks of 128 aligned to
    global multiples of 128, and after each chunk the tile stops once every
    one of its pixels has T < 1e-4. A tile whose ``step`` s > 1 reads
    every s-th chunk, each standing for min(s, its chunks left) chunks:
    alpha = 1 - (1 - alpha)^rep. ``feat`` (N, 9): x, y, conic a b c, r g b,
    opacity. Returns (rgb (B, P, 3), T (B, P), kept (the pairs kept before
    their pixel's T < 1e-4), (N,) bool of the gaussians with such a pair or
    None)."""
    dt, dev = feat.dtype, feat.device
    b, p = px.shape
    T = torch.ones((b, p), dtype=dt, device=dev)
    rgb = torch.zeros((b, p, 3), dtype=dt, device=dev)
    lane = torch.arange(LIST_CHUNK, device=dev)
    kept_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    used = torch.zeros(feat.shape[0], dtype=torch.bool, device=dev) if count_work else None
    first = o // LIST_CHUNK * LIST_CHUNK
    n_full = torch.where(cnt > 0, (o + cnt - first + LIST_CHUNK - 1) // LIST_CHUNK, 0)
    n_read = (n_full + step - 1) // step
    alive = n_read > 0
    for ci in range(int(n_read.max()) if b else 0):
        run = alive & (ci < n_read)
        if not bool(run.any()):
            break
        pos = first[:, None] + (ci * step * LIST_CHUNK)[:, None] + lane[None, :]
        valid = run[:, None] & (pos >= o[:, None]) & (pos < (o + cnt)[:, None])
        g = gid[pos.clamp(0, gid.shape[0] - 1)]
        f = feat[g]  # (B, C, 9)
        dx = f[:, None, :, 0] - px[:, :, None]
        dy = f[:, None, :, 1] - py[:, :, None]
        power = (-0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy)
                 - f[:, None, :, 3] * dx * dy)
        alpha = torch.clamp_max(f[:, None, :, 8] * torch.exp(power), ALPHA_MAX)
        keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[:, None, :]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        rep = torch.clamp_max(n_full - ci * step, step)
        if bool((rep > 1).any()):
            r = rep.to(dt)[:, None, None]
            alpha = torch.where(r > 1, 1.0 - (1.0 - alpha) ** r, alpha)
        cp = torch.cumprod(1.0 - alpha, dim=-1)
        t_before = T[..., None] * torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], -1)
        rgb = rgb + torch.bmm(alpha * t_before, f[..., 5:8])
        T = T * cp[..., -1]
        alive = run & ~(T.max(dim=1).values < T_MIN)
        if count_work:
            need = keep & (t_before >= T_MIN)
            kept_pairs = kept_pairs + need.sum()
            used[g[need.any(dim=1)]] = True
    return rgb, T, kept_pairs, used


def _features(prep: Prep):
    return torch.cat([prep.xy, prep.conic, prep.rgb, prep.opacity[:, None]], dim=1)


def _tile_pixels(t, gx, offs):
    """(B, P) pixel coordinates of tiles t: for each (offx, offy) in offs
    the tile's 16x16 subgrid at that offset in its 2x2 cells, or the whole
    tile for offs None."""
    if offs is None:
        i = torch.arange(TILE * TILE, device=t.device)
        px = (t % gx * TILE)[:, None] + (i % TILE)[None]
        py = (t // gx * TILE)[:, None] + (i // TILE)[None]
    else:
        i = torch.arange((TILE // 2) ** 2, device=t.device)
        px = torch.cat([(t % gx * TILE)[:, None] + (2 * (i % 16) + ox)[None] for ox, _ in offs], 1)
        py = torch.cat([(t // gx * TILE)[:, None] + (2 * (i // 16) + oy)[None] for _, oy in offs], 1)
    return px, py


class Frame(NamedTuple):
    color: torch.Tensor  # (3, H, W) with the background
    lists: Lists
    kept: int  # pairs kept before their pixel's T < 1e-4
    contributing: int  # gaussians with at least one such pair
    pixels: int  # pixels composited (the others of a foveated frame are copies)


def render(prep: Prep, cam: Camera, bg: torch.Tensor, *, tile_batch: int = 128,
           count_work: bool = False) -> Frame:
    """The full-resolution image of ``prep``, without autograd."""
    lists = tile_lists(prep, cam.width, cam.height)
    gx, gy = -(-cam.width // TILE), -(-cam.height // TILE)
    feat = _features(prep)
    ones = torch.ones_like(lists.counts)
    img = torch.zeros((gy * TILE, gx * TILE, 3), dtype=feat.dtype, device=feat.device)
    tmap = torch.ones((gy * TILE, gx * TILE), dtype=feat.dtype, device=feat.device)
    kept, used = 0, None
    order = torch.argsort(lists.counts, descending=True)
    with torch.no_grad():
        for s in range(0, gx * gy, tile_batch):
            t = order[s:s + tile_batch]
            px, py = _tile_pixels(t, gx, None)
            rgb, T, k, u = _composite(feat, lists.gid, lists.offsets[t], lists.counts[t], ones[t],
                                      px.to(feat.dtype), py.to(feat.dtype), count_work)
            img[py, px] = rgb
            tmap[py, px] = T
            if count_work:
                kept += int(k)
                used = u if used is None else used | u
    color = (img + tmap[..., None] * bg.to(img.dtype)).permute(2, 0, 1)
    return Frame(color=color[:, :cam.height, :cam.width], lists=lists, kept=kept,
                 contributing=int(used.sum()) if used is not None else 0,
                 pixels=gx * gy * TILE * TILE)


def render_differentiable(prep: Prep, cam: Camera, bg: torch.Tensor, *,
                          tile_batch: int = 32) -> torch.Tensor:
    """The image as ``render`` makes it, differentiable with respect to
    ``prep``'s floats by autograd; each batch of tiles is recomputed in the
    backward (activation checkpointing) so that 1080p fits."""
    from torch.utils.checkpoint import checkpoint

    with torch.no_grad():
        lists = tile_lists(prep, cam.width, cam.height)
    gx, gy = -(-cam.width // TILE), -(-cam.height // TILE)
    feat = _features(prep)
    order = torch.argsort(lists.counts, descending=True)
    parts, where = [], []

    def batch(feat, o, cnt, px, py):
        rgb, T, _, _ = _composite(feat, lists.gid, o, cnt, torch.ones_like(cnt), px, py, False)
        return rgb + T[..., None] * bg.to(rgb.dtype)

    for s in range(0, gx * gy, tile_batch):
        t = order[s:s + tile_batch]
        px, py = _tile_pixels(t, gx, None)
        parts.append(checkpoint(batch, feat, lists.offsets[t], lists.counts[t],
                                px.to(feat.dtype), py.to(feat.dtype), use_reentrant=False))
        where.append((py, px))
    img = torch.zeros((gy * TILE, gx * TILE, 3), dtype=feat.dtype, device=feat.device)
    py = torch.cat([w[0] for w in where])
    px = torch.cat([w[1] for w in where])
    img = img.index_put((py, px), torch.cat(parts))
    return img.permute(2, 0, 1)[:, :cam.height, :cam.width]


# ---------------------------------------------------------------------------
# The foveated (AMR) frame
# ---------------------------------------------------------------------------

# subgrid ("round") r = 1..4 of each 2x2 cell: its pixel offset (x, y)
ROUND_OFFSETS = ((0, 0), (1, 1), (1, 0), (0, 1))


def percentile_levels(counts: torch.Tensor, percentiles=(0.25, 0.5, 0.9)) -> torch.Tensor:
    """Level 1..4 per tile: 1 plus the number of thresholds its count
    exceeds, a threshold being the sorted counts at index int(p n) (p and n
    multiplied in float32)."""
    srt = torch.sort(counts).values
    n = counts.shape[0]
    level = torch.ones_like(counts)
    for p in percentiles:
        level = level + (counts > srt[min(int(np.float32(p) * np.float32(n)), n - 1)]).long()
    return level.clamp_max(4)


def gaze_override(levels, gx, gy, gaze_xy, rings):
    """Tiles whose centre lies within rings[0] px of the gaze take level 4;
    past rings[i] the level is capped at 3 - i (squared distances in
    float32)."""
    t = torch.arange(gx * gy, device=levels.device)
    cx = (t % gx * TILE).float() + TILE / 2.0
    cy = (t // gx * TILE).float() + TILE / 2.0
    dx, dy = cx - gaze_xy[0], cy - gaze_xy[1]
    d2 = dx * dx + dy * dy
    r2 = rings * rings
    cap = torch.where(d2 <= r2[0], 4, torch.where(d2 <= r2[1], 3, torch.where(d2 <= r2[2], 2, 1)))
    return torch.where(d2 <= r2[0], 4, torch.minimum(levels, cap))


def render_foveated(prep: Prep, cam: Camera, bg: torch.Tensor, gaze_xy, rings, decimation, *,
                    tile_batch: int = 128, count_work: bool = False) -> Frame:
    """The gaze-driven frame: levels from the tiles' counts and the gaze
    rings; a level-L tile composites rounds 1..L of its pixels over its
    decimated list; the other pixels of each 2x2 cell copy the cell's
    pixel (0, 0) at levels 1-2 and (1, 1) at levels 3-4."""
    lists = tile_lists(prep, cam.width, cam.height)
    gx, gy = -(-cam.width // TILE), -(-cam.height // TILE)
    dev = prep.xy.device
    levels = gaze_override(percentile_levels(lists.counts), gx, gy,
                           torch.as_tensor(gaze_xy, dtype=torch.float32, device=dev),
                           torch.as_tensor(rings, dtype=torch.float32, device=dev))
    steps = torch.tensor([int(d) for d in decimation], device=dev)[levels - 1]
    feat = _features(prep)
    img = torch.zeros((gy * TILE, gx * TILE, 3), dtype=feat.dtype, device=dev)
    tmap = torch.ones((gy * TILE, gx * TILE), dtype=feat.dtype, device=dev)
    kept, used = 0, None
    with torch.no_grad():
        for lvl in range(1, 5):
            tiles = torch.nonzero(levels == lvl).flatten()
            tiles = tiles[torch.argsort(lists.counts[tiles], descending=True)]
            for s in range(0, tiles.shape[0], tile_batch):
                t = tiles[s:s + tile_batch]
                px, py = _tile_pixels(t, gx, ROUND_OFFSETS[:lvl])
                rgb, T, k, u = _composite(feat, lists.gid, lists.offsets[t], lists.counts[t],
                                          steps[t], px.to(feat.dtype), py.to(feat.dtype),
                                          count_work)
                img[py, px] = rgb
                tmap[py, px] = T
                if count_work:
                    kept += int(k)
                    used = u if used is None else used | u
    hh, ww = tmap.shape
    yy = torch.arange(hh, device=dev)[:, None].expand(hh, ww)
    xx = torch.arange(ww, device=dev)[None, :].expand(hh, ww)
    lvl_px = levels.reshape(gy, gx)[yy // TILE, xx // TILE]
    rnd = torch.where((xx % 2 == 0) & (yy % 2 == 0), 1, torch.where(
        (xx % 2 == 1) & (yy % 2 == 1), 2, torch.where(yy % 2 == 0, 3, 4)))
    src = (lvl_px >= 3).long()
    sy, sx = yy // 2 * 2 + src, xx // 2 * 2 + src
    need = rnd > lvl_px
    img = torch.where(need[..., None], img[sy, sx], img)
    tmap = torch.where(need, tmap[sy, sx], tmap)
    color = (img + tmap[..., None] * bg.to(img.dtype)).permute(2, 0, 1)
    return Frame(color=color[:, :cam.height, :cam.width], lists=lists, kept=kept,
                 contributing=int(used.sum()) if used is not None else 0,
                 pixels=int(levels.sum()) * (TILE // 2) ** 2)

"""Hard triangle rasterizer (port of ``avi_talking_tpu/viz/rasterizer.py``).

Conventions as in the JAX package: vertices in NDC, x right / y up in
[-1, 1], pixel centres at ``(2i + 1) / n`` from the edge with y up; z is
DEPTH (smaller = closer). Attributes are per-vertex (V, C) or per-corner
(F, 3, C) and interpolated with the barycentrics of the one face that wins
each pixel. Exact-z ties go to the lowest face id (dense) or the first
table slot (binned, whose tables are sorted by face id).

Three routes, picked by ``rasterize_auto``:

- ``dense``: every face against every pixel, in face chunks (plain torch);
- ``binned``: faces binned to pixel tiles by bounding box (depth-keyed,
  farthest dropped first past ``cap``), then every tile's faces against its
  pixels (plain torch, true divides); the CPU route for big meshes;
- ``kernel``: the same binning, with visibility from the hand-written
  kernel K2 (``ops/kernels/rasterize.py``) and the winner's attributes
  interpolated afterwards from one packed gather; the CUDA route for big
  meshes. Visibility is a stop-gradient decision, as in JAX; gradients
  reach the vertices and attributes through the interpolation alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.kernels.rasterize import BIG, rasterize_tiles_visibility

# (tiles x cap x pixels) elements per step of the plain binned route, which
# bounds its temporaries to a few hundred MB whatever the image size
_BINNED_STEP_ELEMS = 1 << 24


def _pixel_grid(h: int, w: int, dtype=torch.float32,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(px, py), each (h, w): pixel-centre x and y, y up. The divisor is a
    tensor on the device: CUDA divides a tensor by a Python number as a
    product with its reciprocal, which is not correctly rounded, and would
    put the card's pixel centres an ulp off the CPU's (and JAX's)."""

    def centres(n):
        return ((2.0 * torch.arange(n, dtype=dtype, device=device) + 1.0)
                / torch.full((), n, dtype=dtype, device=device))

    ys = 1.0 - centres(h)
    xs = -1.0 + centres(w)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px, py


def _edge_weights(x0, y0, x1, y1, x2, y2, px, py):
    """Barycentric weights with true divides, op for op as the JAX package
    (``_bary_weights``); -> (w0, w1, w2, nondegenerate)."""
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    ok = denom.abs() > 1e-12
    safe = torch.where(ok, denom, torch.ones_like(denom))
    w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / safe
    w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / safe
    return w0, w1, 1.0 - w0 - w1, ok


def _interpolate(b0, b1, b2, corner_attrs):
    """sum_k b_k * attr_k over the three corners; corner_attrs (..., 3, C)."""
    return (b0[..., None] * corner_attrs[..., 0, :] + b1[..., None] * corner_attrs[..., 1, :]
            + b2[..., None] * corner_attrs[..., 2, :])


def rasterize(
    vertices: torch.Tensor,  # (V, 3) NDC, z = depth
    faces: torch.Tensor,  # (F, 3) int
    attributes: torch.Tensor,  # (V, C) per-vertex OR (F, 3, C) per-corner
    height: int,
    width: int,
    chunk: int = 2048,
    per_corner: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard-rasterize one mesh -> ((H, W, C) image, (H, W) mask). Faces go
    in chunks of ``chunk`` (a (chunk, H*W) temporary each); inside a chunk
    the first face of the smallest z wins, across chunks a strictly closer
    one."""
    faces = faces.long()
    F = faces.shape[0]
    C = attributes.shape[-1]
    px, py = _pixel_grid(height, width, vertices.dtype, vertices.device)
    px, py = px.reshape(1, -1), py.reshape(1, -1)
    P = px.shape[1]
    zbuf = torch.full((P,), BIG, dtype=vertices.dtype, device=vertices.device)
    img = torch.zeros((P, C), dtype=vertices.dtype, device=vertices.device)
    mask = torch.zeros((P,), dtype=torch.bool, device=vertices.device)
    for c0 in range(0, F, chunk):
        fc = faces[c0:c0 + chunk]
        tri = vertices[fc]  # (ch, 3 corners, 3 xyz)
        attr = attributes[c0:c0 + chunk] if per_corner else attributes[fc]  # (ch, 3, C)
        c = [tri[:, k, i, None] for k in range(3) for i in range(3)]  # x0 y0 z0 x1 ..
        w0, w1, w2, ok = _edge_weights(c[0], c[1], c[3], c[4], c[6], c[7], px, py)
        inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & ok
        z = torch.where(inside, w0 * c[2] + w1 * c[5] + w2 * c[8], BIG)  # (ch, P)
        best = z.argmin(dim=0, keepdim=True)  # first index on ties
        best_z = z.gather(0, best)[0]
        closer = (best_z < BIG) & (best_z < zbuf)
        pix = _interpolate(w0.gather(0, best)[0], w1.gather(0, best)[0],
                           w2.gather(0, best)[0], attr[best[0]])  # (P, C)
        zbuf = torch.where(closer, best_z, zbuf)
        img = torch.where(closer[:, None], pix, img)
        mask = mask | closer
    return img.reshape(height, width, C), mask.reshape(height, width)


def rasterize_batch(vertices, faces, attributes, height, width, chunk=2048):
    """Frame by frame: (B, V, 3), (B, V, C) -> (B, H, W, C), (B, H, W)."""
    outs = [rasterize(v, faces, a, height, width, chunk) for v, a in zip(vertices, attributes)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _auto_tile(height: int, width: int, n_faces: int) -> int:
    """Tile-size pick for ``rasterize_auto(tile=None)``: 56 where it divides
    both sides (224^2, the neural-loss size) on meshes up to 20k faces,
    else 32."""
    return 56 if (height % 56 == 0 and width % 56 == 0 and n_faces <= 20000) else 32


def rasterize_auto(vertices, faces, attributes, height, width,
                   tile=None, cap=1024, chunk=2048, backend=None,
                   per_corner=False):
    """Batch rasterization: (B, V, 3) vertices -> (B, H, W, C), (B, H, W).

    ``backend``: None (auto) | "kernel" | "binned" | "dense". None picks
    the binned routes for meshes of at least 4096 faces whose tile divides
    the image ("kernel" on CUDA, "binned" on the CPU), else "dense".
    ``tile``: None picks by ``_auto_tile``. ``per_corner``: attributes are
    (F, 3, C) corner values instead of (V, C). Attributes with a leading
    batch dim ((B, V, C) / (B, F, 3, C)) pair with the vertex batch; without
    it they are shared by every frame.
    """
    if tile is None:
        tile = _auto_tile(height, width, faces.shape[0])
    can_bin = faces.shape[0] >= 4096 and height % tile == 0 and width % tile == 0
    if backend is None:
        backend = ("kernel" if vertices.device.type == "cuda" else "binned") if can_bin else "dense"
    if attributes.dim() != (4 if per_corner else 3):  # shared by every frame
        attributes = attributes.expand(vertices.shape[0], *attributes.shape)
    if backend == "kernel":
        return rasterize_binned_kernel(vertices, faces, attributes, height, width,
                                       tile=tile, cap=cap, per_corner=per_corner)
    if backend == "binned":
        outs = [rasterize_binned(v, faces, a, height, width, tile, cap, per_corner)
                for v, a in zip(vertices, attributes)]
    elif backend == "dense":
        outs = [rasterize(v, faces, a, height, width, chunk, per_corner)
                for v, a in zip(vertices, attributes)]
    else:
        raise ValueError(f"unknown rasterizer backend {backend!r}")
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def safe_unit(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise along the last axis, clamping the SQUARED norm before the
    rsqrt (NaN-free at x == 0, in value and in gradient)."""
    n2 = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(n2, eps * eps))


def _corner_table(faces: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """(V, max valence) indices ``k * F + f`` of the face corners at each
    vertex, in ascending (k, f) order; ``3F`` (a zero row) pads."""
    F = faces.shape[0]
    flat = faces.t().reshape(-1)  # vertex of corner (k, f) at k * F + f
    order = torch.sort(flat, stable=True).indices  # by vertex, then (k, f)
    counts = torch.bincount(flat, minlength=n_vertices)
    starts = torch.cumsum(counts, 0) - counts
    vert = flat[order]
    rank = torch.arange(3 * F, device=faces.device) - starts[vert]
    table = torch.full((n_vertices, int(counts.max()) if F else 0), 3 * F,
                       dtype=torch.long, device=faces.device)
    table[vert, rank] = order
    return table


def compute_vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals, (B, V, 3) or (V, 3) input.

    The face normals are summed at each vertex in the order of the JAX
    package's scatter-add (corner 0 of every face, then corner 1, then 2),
    through a gather and a fixed sequence of adds rather than an atomic
    ``index_add_``: the sum, and so the render, is the same on every run
    and every device."""
    squeeze = vertices.dim() == 2
    if squeeze:
        vertices = vertices[None]
    faces = faces.long()
    B, V = vertices.shape[:2]
    tri = vertices[:, faces]  # (B, F, 3, 3)
    fn = torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0], tri[:, :, 2] - tri[:, :, 0], dim=-1)
    corners = torch.cat([fn, fn, fn, fn.new_zeros(B, 1, 3)], dim=1)  # (B, 3F + 1, 3)
    gathered = corners[:, _corner_table(faces, V)]  # (B, V, max valence, 3)
    normals = vertices.new_zeros(B, V, 3)
    for j in range(gathered.shape[2]):
        normals = normals + gathered[:, :, j]
    normals = safe_unit(normals, 1e-12)
    return normals[0] if squeeze else normals


def render_normal_maps(
    vertices: torch.Tensor,  # (B, V, 3) NDC (z = depth)
    faces: torch.Tensor,
    height: int = 256,
    width: int = 256,
    chunk: int = 2048,
    background: float = 0.0,
) -> torch.Tensor:
    """Per-pixel normals mapped to [0, 1], ``background`` where no face
    covers: the normal-map video frames."""
    normals = compute_vertex_normals(vertices, faces)
    img, mask = rasterize_auto(vertices, faces, normals, height, width, chunk=chunk)
    return torch.where(mask[..., None], img * 0.5 + 0.5, background)


def _face_tile_overlap(vertices, faces, height, width, tile):
    """(..., n_tiles, F) bool: face bbox overlaps tile rect (x left to
    right; tile rows top to bottom, y down from 1)."""
    ty, tx = height // tile, width // tile
    tri = vertices[..., faces.long(), :]  # (..., F, 3, 3)
    fx_min, fx_max = tri[..., 0].amin(-1), tri[..., 0].amax(-1)
    fy_min, fy_max = tri[..., 1].amin(-1), tri[..., 1].amax(-1)
    tile_w, tile_h = 2.0 / tx, 2.0 / ty
    tx0 = -1.0 + torch.arange(tx, dtype=vertices.dtype, device=vertices.device) * tile_w
    ty1 = 1.0 - torch.arange(ty, dtype=vertices.dtype, device=vertices.device) * tile_h
    ox = ((fx_min[..., None, :] <= (tx0 + tile_w)[:, None])
          & (fx_max[..., None, :] >= tx0[:, None]))  # (..., tx, F)
    oy = ((fy_max[..., None, :] >= (ty1 - tile_h)[:, None])
          & (fy_min[..., None, :] <= ty1[:, None]))  # (..., ty, F)
    both = oy[..., :, None, :] & ox[..., None, :, :]  # (..., ty, tx, F)
    return both.reshape(*both.shape[:-3], ty * tx, faces.shape[0])


def _bin_faces(vertices, faces, height, width, tile, cap):
    """Stage 1 of the tiled rasterizers: bbox face -> tile binning.

    vertices (..., V, 3) -> (face_ids (..., n_tiles, cap) int64 with F as
    the empty sentinel, sorted ascending; tri_p (..., F+1, 3, 3) corner
    table with a zero row; per-tile pixel grids pxg / pyg (n_tiles,
    tile*tile); (ty, tx)). A tile whose faces exceed ``cap`` keeps its
    ``cap`` nearest by min corner z; faces of equal z keep the lower id
    (a stable descending sort, as ``lax.top_k``)."""
    if height % tile or width % tile:
        raise ValueError(f"tile {tile} does not divide {height} x {width}")
    faces = faces.long()
    F = faces.shape[0]
    ty, tx = height // tile, width // tile
    n_tiles = ty * tx
    tri = vertices[..., faces, :]  # (..., F, 3, 3)
    overlap = _face_tile_overlap(vertices, faces, height, width, tile)
    zmin = tri[..., 2].amin(-1).detach()  # (..., F)
    zref = zmin.amax(-1, keepdim=True) + 1.0
    scores = torch.where(overlap, (zref - zmin)[..., None, :], 0.0)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = min(cap, F)
    face_ids = torch.where(vals[..., :k] > 0, idx[..., :k], F)
    face_ids = torch.sort(face_ids, dim=-1).values  # ascending id: ties go to the lowest
    if cap > F:
        face_ids = torch.cat([face_ids, face_ids.new_full((*face_ids.shape[:-1], cap - F), F)],
                             dim=-1)
    tri_p = torch.cat([tri, tri.new_zeros(*tri.shape[:-3], 1, 3, 3)], dim=-3)
    pxg, pyg = _pixel_grid(height, width, vertices.dtype, vertices.device)
    pxg = pxg.reshape(ty, tile, tx, tile).permute(0, 2, 1, 3).reshape(n_tiles, -1)
    pyg = pyg.reshape(ty, tile, tx, tile).permute(0, 2, 1, 3).reshape(n_tiles, -1)
    return face_ids, tri_p, pxg, pyg, (ty, tx)


def bin_overflow(vertices, faces, height, width, tile=32, cap=1024):
    """Diagnostic of the binned routes' face-drop hazard: (max bbox-overlap
    face count over tiles, fraction of tiles whose count exceeds ``cap``),
    over one mesh (V, 3) or a batch (B, V, 3)."""
    counts = _face_tile_overlap(vertices, faces, height, width, tile).sum(dim=-1)
    return counts.max(), (counts > cap).float().mean()


def _untile(x: torch.Tensor, ty: int, tx: int, tile: int) -> torch.Tensor:
    """(..., n_tiles, tile*tile, C) -> (..., H, W, C)."""
    lead, C = x.shape[:-2], x.shape[-1]
    x = x.reshape(*lead[:-1], ty, tx, tile, tile, C).transpose(-4, -3)
    return x.reshape(*lead[:-1], ty * tile, tx * tile, C)


def rasterize_binned(
    vertices: torch.Tensor,  # (V, 3) NDC, z = depth
    faces: torch.Tensor,  # (F, 3)
    attributes: torch.Tensor,  # (V, C) or (F, 3, C) with per_corner
    height: int,
    width: int,
    tile: int = 32,
    cap: int = 1024,
    per_corner: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage tiled rasterizer, plain torch: ``_bin_faces``, then each
    tile's (at most ``cap``) faces against its pixels, the first face of the
    smallest z winning (true divides, like the dense route)."""
    faces = faces.long()
    F = faces.shape[0]
    C = attributes.shape[-1]
    face_ids, tri_p, pxg, pyg, (ty, tx) = _bin_faces(vertices, faces, height, width, tile, cap)
    corner_attrs = attributes if per_corner else attributes[faces]
    attr_tri = torch.cat([corner_attrs, corner_attrs.new_zeros(1, 3, C)], dim=0)
    n_tiles, tp = pxg.shape
    step = max(1, _BINNED_STEP_ELEMS // (cap * tp))
    pix_parts, mask_parts = [], []
    for g0 in range(0, n_tiles, step):
        ids = face_ids[g0:g0 + step]  # (g, cap)
        t = tri_p[ids]  # (g, cap, 3, 3)
        c = [t[:, :, k, i, None] for k in range(3) for i in range(3)]  # (g, cap, 1) each
        w0, w1, w2, ok = _edge_weights(c[0], c[1], c[3], c[4], c[6], c[7],
                                       pxg[g0:g0 + step, None], pyg[g0:g0 + step, None])
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok & (ids < F)[..., None]
        z = torch.where(inside, w0 * c[2] + w1 * c[5] + w2 * c[8], BIG)  # (g, cap, tp)
        best = z.argmin(dim=1, keepdim=True)  # (g, 1, tp), first index on ties
        mask = z.gather(1, best)[:, 0] < BIG
        a = attr_tri[ids.gather(1, best[:, 0])]  # (g, tp, 3, C)
        pix = _interpolate(w0.gather(1, best)[:, 0], w1.gather(1, best)[:, 0],
                           w2.gather(1, best)[:, 0], a)
        pix_parts.append(torch.where(mask[..., None], pix, 0.0))
        mask_parts.append(mask)
    img = _untile(torch.cat(pix_parts), ty, tx, tile)
    m = _untile(torch.cat(mask_parts)[..., None], ty, tx, tile)[..., 0]
    return img, m


def _visibility_inputs(vertices, faces, height, width, tile, cap):
    """The kernel route's binning, batched: vertices (B, V, 3) -> (face_ids
    (B, n_tiles, cap), K2's inputs tri (B*n_tiles, cap, 9), valid
    (B*n_tiles, cap, 1), px / py (B*n_tiles, px_n), the per-tile pixel
    grids pxg / pyg (n_tiles, px_n), (ty, tx))."""
    B, F = vertices.shape[0], faces.shape[0]
    with torch.no_grad():
        face_ids, tri_p, pxg, pyg, (ty, tx) = _bin_faces(vertices, faces, height, width, tile, cap)
        n_tiles, px_n = pxg.shape
        flat_ids = face_ids.reshape(B, n_tiles * cap, 1)
        tri = tri_p.reshape(B, F + 1, 9).gather(1, flat_ids.expand(-1, -1, 9))
        tri = tri.reshape(B * n_tiles, cap, 9)
        valid = (face_ids < F).to(torch.float32).reshape(B * n_tiles, cap, 1)
        px = pxg.expand(B, n_tiles, px_n).reshape(B * n_tiles, px_n)
        py = pyg.expand(B, n_tiles, px_n).reshape(B * n_tiles, px_n)
    return face_ids, tri, valid, px, py, pxg, pyg, (ty, tx)


def rasterize_binned_kernel(
    vertices: torch.Tensor,  # (B, V, 3) NDC, z = depth
    faces: torch.Tensor,  # (F, 3)
    attributes: torch.Tensor,  # (B, V, C) or (B, F, 3, C) with per_corner
    height: int,
    width: int,
    tile: int = 32,
    cap: int = 1024,
    chunk: int = 256,
    per_corner: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binned rasterizer with visibility from K2, the JAX
    ``rasterize_binned_pallas``, for a whole batch of frames in one K2
    launch (n = frames x tiles): (B, H, W, C) image, (B, H, W) mask.

    K2 resolves (depth, winning slot) per pixel under ``no_grad``; the
    winner's attributes come from ONE gather of a channel-leading
    (6 + 3C, F+1) table of corner xy and corner attributes, interpolated
    with true-divide barycentrics. Autograd through that gather is the
    shape of JAX's hand-composed ``_interp_bwd``: one packed scatter-add of
    the (6 + 3C)-channel pixel gradients into (B, 6 + 3C, F+1), then the
    face-to-vertex scatters; no (tiles, cap, pixels) temporary is kept for
    the backward. Gradients reach ``vertices`` (x, y) and ``attributes``,
    per-vertex or ``per_corner``."""
    faces = faces.long()
    B, F, C = vertices.shape[0], faces.shape[0], attributes.shape[-1]
    face_ids, tri, valid, px, py, pxg, pyg, (ty, tx) = _visibility_inputs(
        vertices, faces, height, width, tile, cap)
    n_tiles, px_n = pxg.shape
    with torch.no_grad():
        zbuf, slot = rasterize_tiles_visibility(tri, valid, px, py, chunk=chunk)
    zbuf, slot = zbuf.reshape(B, n_tiles, px_n), slot.reshape(B, n_tiles, px_n)
    covered = (slot >= 0) & (zbuf < BIG)
    gid = torch.where(covered, face_ids.gather(2, slot.clamp_min(0).long()), F)

    K = 6 + 3 * C
    flat = faces.reshape(-1)
    corner_a = attributes if per_corner else attributes[:, flat].reshape(B, F, 3, C)
    tab = torch.cat([vertices[:, flat, :2].reshape(B, F, 6), corner_a.reshape(B, F, 3 * C)],
                    dim=2)  # (B, F, K): [x0 y0 x1 y1 x2 y2 | a0(C) a1(C) a2(C)]
    tab = torch.cat([tab, tab.new_zeros(B, 1, K)], dim=1).transpose(1, 2)  # (B, K, F+1)
    g = tab.gather(2, gid.reshape(B, 1, -1).expand(B, K, -1)).reshape(B, K, n_tiles, px_n)
    w0, w1, w2, _ = _edge_weights(g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 4], g[:, 5], pxg, pyg)
    pix = (w0[:, None] * g[:, 6:6 + C] + w1[:, None] * g[:, 6 + C:6 + 2 * C]
           + w2[:, None] * g[:, 6 + 2 * C:])  # (B, C, n_tiles, px_n)
    pix = torch.where(covered[:, None], pix, 0.0)
    img = _untile(pix.permute(0, 2, 3, 1), ty, tx, tile)
    mask = _untile(covered[..., None], ty, tx, tile)[..., 0]
    return img, mask

"""Collision-shape cooking (counterpart of
``lumixengine_tpu/physics/cooking.py``; host numpy, a copy, so that the
port imports nothing of the JAX package). The hulls and SDF grids it makes
are the reference's, bit for bit.

Two cooked products:

- ``CookedHull``: a convex hull as a padded vertex set and padded unique
  face axes. The narrowphase takes fixed shapes; padding repeats real
  entries, so support functions stay exact without masks.
- ``CookedMeshSDF``: a triangle mesh baked to a signed-distance grid,
  sampled trilinearly at candidate points (``ops/convex_ops.sdf_contacts``).

``cook_mesh_sdf_cached`` keeps a disk cache in ``.cook_cache/`` at the root
of the checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class CookedHull:
    verts: np.ndarray        # f32 [K, 3] local-space, padded by repeating
    axes: np.ndarray         # f32 [F, 3] unit face normals, deduped ±, padded
    n_verts: int
    n_faces: int
    bound_radius: float      # max |vert| — broadphase bounding sphere
    volume: float
    # inertia tensor diagonal of the solid hull at unit density, about the
    # center of mass (off-diagonals dropped: the solver is diagonal-inertia)
    inertia_diag: np.ndarray  # f32 [3]
    com: np.ndarray          # f32 [3] center of mass (verts are NOT re-centered)


def _fibonacci_directions(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1)


def _hull_mass_properties(verts: np.ndarray, simplices: np.ndarray,
                          normals: np.ndarray = None):
    """Volume, COM, inertia diagonal of a closed triangulated convex hull via
    signed tetrahedra against the origin (standard divergence-theorem sums).
    qhull simplices are not consistently wound — orient each against its
    outward face normal when given."""
    a = verts[simplices[:, 0]]
    b = verts[simplices[:, 1]]
    c = verts[simplices[:, 2]]
    if normals is not None:
        flip = np.einsum("ij,ij->i", np.cross(b - a, c - a), normals) < 0.0
        b, c = np.where(flip[:, None], c, b), np.where(flip[:, None], b, c)
    vols = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0  # signed tet volumes
    vol = float(vols.sum())
    if abs(vol) < 1e-12:
        return 0.0, np.zeros(3), np.ones(3, np.float32)
    com = (vols[:, None] * (a + b + c) / 4.0).sum(0) / vol
    # inertia of each tet about origin (canonical covariance form), diagonal only
    diag = np.zeros(3)
    for v0, v1, v2 in ((a, b, c),):
        # squared-coordinate integrals over tets: ∫x_i² dV =
        # vol/10 · Σ_{p≤q} x_i(p)·x_i(q) over the 4 verts (origin is zero)
        for i in range(3):
            xi = np.stack([v0[:, i], v1[:, i], v2[:, i]], axis=1)
            s = (xi.sum(1) ** 2 + (xi**2).sum(1)) / 20.0
            diag[i] += float((vols * s).sum())
    # I_xx = ∫(y²+z²); shift to COM via parallel axis
    sq = diag  # ∫x², ∫y², ∫z² about origin
    I = np.array([sq[1] + sq[2], sq[0] + sq[2], sq[0] + sq[1]])
    I -= vol * np.array([com[1] ** 2 + com[2] ** 2,
                         com[0] ** 2 + com[2] ** 2,
                         com[0] ** 2 + com[1] ** 2])
    return vol, com, np.abs(I).astype(np.float32)


_hull_memo: dict = {}


def cook_convex_cached(points, max_verts: int = 16,
                       max_faces: int = 12) -> CookedHull:
    """cook_convex behind a content-hash memo (stress maps instantiate the
    same model's hull thousands of times)."""
    import hashlib

    p = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    key = (hashlib.sha1(p.tobytes()).hexdigest(), max_verts, max_faces)
    if key not in _hull_memo:
        _hull_memo[key] = cook_convex(p, max_verts, max_faces)
    return _hull_memo[key]


def cook_convex(points, max_verts: int = 16, max_faces: int = 12) -> CookedHull:
    """Cook a convex hull from a point cloud (PhysX's createConvexMesh caps
    hulls at 255 vertices; here the cap is `max_verts`, for fixed shapes).
    Vertex reduction picks support points along Fibonacci-sphere
    directions, the usual hull simplification of GPU physics."""
    from scipy.spatial import ConvexHull  # qhull

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if pts.shape[0] < 4:
        raise ValueError("convex cooking needs >= 4 points")
    hull = ConvexHull(pts)
    vidx = hull.vertices
    if len(vidx) > max_verts:
        # support-point reduction: extreme points along well-spread directions
        dirs = _fibonacci_directions(max_verts * 4)
        sup = np.unique(np.argmax(pts[vidx] @ dirs.T, axis=0))
        keep = vidx[sup][:max_verts]
        hull = ConvexHull(pts[keep])
        pts = pts[keep]
        vidx = hull.vertices
    verts = pts[vidx].astype(np.float32)

    # unique face axes: normals deduped up to sign (SAT axes are unsigned)
    eqs = hull.equations[:, :3]
    eqs = eqs / np.linalg.norm(eqs, axis=1, keepdims=True)
    axes = []
    for n in eqs:
        if not any(abs(float(n @ m)) > 0.999 for m in axes):
            axes.append(n)
        if len(axes) >= max_faces:
            break
    axes = np.asarray(axes, np.float32)

    vol, com, inertia = _hull_mass_properties(
        np.asarray(hull.points, np.float64), hull.simplices,
        hull.equations[:, :3])

    nv, nf = len(verts), len(axes)
    verts_p = np.concatenate(
        [verts, np.repeat(verts[:1], max_verts - nv, axis=0)]) \
        if nv < max_verts else verts[:max_verts]
    axes_p = np.concatenate(
        [axes, np.repeat(axes[:1], max_faces - nf, axis=0)]) \
        if nf < max_faces else axes[:max_faces]
    return CookedHull(
        verts=np.ascontiguousarray(verts_p, np.float32),
        axes=np.ascontiguousarray(axes_p, np.float32),
        n_verts=min(nv, max_verts), n_faces=min(nf, max_faces),
        bound_radius=float(np.linalg.norm(verts, axis=1).max()),
        volume=float(abs(vol)),
        inertia_diag=inertia, com=com.astype(np.float32),
    )


@dataclass
class CookedMeshSDF:
    grid: np.ndarray     # f32 [NX, NY, NZ] signed distance (negative inside)
    origin: np.ndarray   # f32 [3] world position of grid[0,0,0] (mesh-local)
    cell: float          # uniform cell size
    bound_min: np.ndarray
    bound_max: np.ndarray


def _point_triangle_distance(p, a, b, c):
    """Unsigned distance from points p [N,3] to triangles (a,b,c) [M,3] →
    [N, M]. Fully vectorized Ericson closest-point-on-triangle."""
    ab = b - a            # [M,3]
    ac = c - a
    ap = p[:, None, :] - a[None, :, :]   # [N,M,3]
    d1 = np.einsum("nmk,mk->nm", ap, ab)
    d2 = np.einsum("nmk,mk->nm", ap, ac)
    bp = p[:, None, :] - b[None, :, :]
    d3 = np.einsum("nmk,mk->nm", bp, ab)
    d4 = np.einsum("nmk,mk->nm", bp, ac)
    cp = p[:, None, :] - c[None, :, :]
    d5 = np.einsum("nmk,mk->nm", cp, ab)
    d6 = np.einsum("nmk,mk->nm", cp, ac)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-30)
    v = np.clip(vb / denom, 0.0, 1.0)
    w = np.clip(vc / denom, 0.0, 1.0)
    # interior projection
    closest = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]
    # vertex regions
    closest = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a[None], closest)
    closest = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b[None], closest)
    closest = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c[None], closest)
    # edge AB
    v_ab = np.clip(np.where(d1 - d3 != 0, d1 / np.where(d1 - d3 == 0, 1.0, d1 - d3), 0.0), 0.0, 1.0)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    closest = np.where(on_ab[..., None], a[None] + v_ab[..., None] * ab[None], closest)
    # edge AC
    w_ac = np.clip(np.where(d2 - d6 != 0, d2 / np.where(d2 - d6 == 0, 1.0, d2 - d6), 0.0), 0.0, 1.0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    closest = np.where(on_ac[..., None], a[None] + w_ac[..., None] * ac[None], closest)
    # edge BC
    num = d4 - d3
    den = (d4 - d3) + (d5 - d6)
    w_bc = np.clip(np.where(den != 0, num / np.where(den == 0, 1.0, den), 0.0), 0.0, 1.0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    closest = np.where(on_bc[..., None], b[None] + w_bc[..., None] * (c - b)[None], closest)
    return np.linalg.norm(p[:, None, :] - closest, axis=-1)


def _winding_number(p, a, b, c):
    """Generalized winding number of points p [N,3] w.r.t. triangles → [N].
    ~0 outside, ~1 inside (robust to imperfect meshes; Jacobson et al. 2013)."""
    ra = a[None] - p[:, None]    # [N,M,3]
    rb = b[None] - p[:, None]
    rc = c[None] - p[:, None]
    la = np.linalg.norm(ra, axis=-1)
    lb = np.linalg.norm(rb, axis=-1)
    lc = np.linalg.norm(rc, axis=-1)
    num = np.einsum("nmk,nmk->nm", ra, np.cross(rb, rc))
    den = (la * lb * lc + np.einsum("nmk,nmk->nm", ra, rb) * lc
           + np.einsum("nmk,nmk->nm", rb, rc) * la
           + np.einsum("nmk,nmk->nm", rc, ra) * lb)
    return np.arctan2(num, den).sum(axis=1) / (2.0 * np.pi)


_SDF_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cook_cache")
_sdf_memo: dict = {}


def cook_mesh_sdf_cached(vertices, triangles, resolution: int = 32,
                         pad_cells: int = 2) -> CookedMeshSDF:
    """cook_mesh_sdf behind a content-hash memo + disk cache (cooking the
    same mesh once per machine, like the reference's .phy compiled assets)."""
    import hashlib

    v = np.ascontiguousarray(np.asarray(vertices, np.float32).reshape(-1, 3))
    t = np.ascontiguousarray(np.asarray(triangles, np.int32).reshape(-1, 3))
    key = hashlib.sha1(v.tobytes() + t.tobytes()
                       + bytes([resolution & 0xFF, pad_cells])).hexdigest()
    if key in _sdf_memo:
        return _sdf_memo[key]
    path = os.path.join(_SDF_CACHE_DIR, key + ".npz")
    if os.path.exists(path):
        z = np.load(path)
        out = CookedMeshSDF(grid=z["grid"], origin=z["origin"],
                            cell=float(z["cell"]), bound_min=z["bmin"],
                            bound_max=z["bmax"])
    else:
        out = cook_mesh_sdf(v, t, resolution=resolution, pad_cells=pad_cells)
        try:
            os.makedirs(_SDF_CACHE_DIR, exist_ok=True)
            np.savez_compressed(path, grid=out.grid, origin=out.origin,
                                cell=out.cell, bmin=out.bound_min,
                                bmax=out.bound_max)
        except OSError:
            pass
    _sdf_memo[key] = out
    return out


def cook_mesh_sdf(vertices, triangles, resolution: int = 32,
                  pad_cells: int = 2) -> CookedMeshSDF:
    """Bake a triangle mesh into a signed-distance grid
    (PhysX's createTriangleMesh; the representation is a PhysX-5-style SDF).
    `resolution` is the cell count along the longest AABB axis."""
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    t = np.asarray(triangles, np.int64).reshape(-1, 3)
    bmin, bmax = v.min(0), v.max(0)
    extent = bmax - bmin
    cell = float(extent.max() / max(resolution, 2))
    cell = max(cell, 1e-4)
    dims = np.maximum((extent / cell).astype(int) + 1 + 2 * pad_cells, 3)
    origin = bmin - pad_cells * cell

    xs = origin[0] + np.arange(dims[0]) * cell
    ys = origin[1] + np.arange(dims[1]) * cell
    zs = origin[2] + np.arange(dims[2]) * cell
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    # narrowband: exact point-triangle distance only near the surface —
    # far cells use the distance to the nearest triangle centroid (error ≤
    # that triangle's circumradius, irrelevant beyond the contact band)
    cent = (a + b + c) / 3.0
    tri_r = np.maximum.reduce([np.linalg.norm(x - cent, axis=1)
                               for x in (a, b, c)])
    band = 2.0 * cell + float(tri_r.max())
    n_pts = pts.shape[0]
    sdf = np.empty(n_pts, np.float32)
    chunk = max(1, int(8e6 / max(len(t), 1)))
    for s in range(0, n_pts, chunk):
        ps = pts[s:s + chunk]
        d_cent = np.linalg.norm(ps[:, None, :] - cent[None, :, :], axis=-1)
        d = d_cent.min(axis=1)
        near = (d - tri_r.max()) < band
        if near.any():
            d_ex = _point_triangle_distance(ps[near], a, b, c).min(axis=1)
            d[near] = d_ex
        wn = _winding_number(ps, a, b, c)
        sdf[s:s + chunk] = np.where(wn > 0.5, -d, d).astype(np.float32)
    return CookedMeshSDF(
        grid=sdf.reshape(tuple(dims)),
        origin=origin.astype(np.float32),
        cell=cell,
        bound_min=bmin.astype(np.float32),
        bound_max=bmax.astype(np.float32),
    )

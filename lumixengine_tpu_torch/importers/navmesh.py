"""Reference `.nav` navzone importer (counterpart of
``lumixengine_tpu/importers/navmesh.py``; ≙ NavigationModule::loadZone,
LumixEngine src/navigation/navigation_module.cpp:640-735).

File layout (clean-room from the reference's save/load code):
  u32 magic 'NAVM' | u32 version | u32 num_tiles_x | u32 num_tiles_z |
  dtNavMeshParams { f32 orig[3]; f32 tileWidth, tileHeight; i32 maxTiles,
  maxPolys } | per tile: i32 data_size, u32 compressed_size,
  LZ4-block-compressed Detour tile data.

The tile payload is the PUBLIC Detour dtMeshTile binary (dtMeshHeader
magic 'DNAV' version 7, then 4-byte-aligned sections: verts, polys, links,
detail meshes, detail verts, detail tris, BV tree, off-mesh connections).
We decode the two sections the engine needs — world-space vertices and the
walkable polygon set — and rasterize them into the zone's walkable grid
(our navigation re-design is grid-based; see navigation/module.py).
Off-mesh connection polys (type 1) are skipped like dtCrowd does for
steering geometry.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

NAV_MAGIC = 0x4E41564D       # 'NAVM' (little-endian bytes b'MVAN')
DT_MAGIC = 0x444E4156        # 'DNAV'
DT_VERTS_PER_POLYGON = 6
_HEADER_FMT = "<15i10f"      # dtMeshHeader: 15 ints + 10 floats = 100 bytes
_POLY_SIZE = 32              # dtPoly: u32 + 6*u16 + 6*u16 + u16 + u8 + u8


@dataclass
class NavPoly:
    verts: np.ndarray        # f32 [n, 3] world-space ring (CCW)
    area: int
    flags: int


@dataclass
class NavMeshData:
    origin: Tuple[float, float, float]
    tile_size: Tuple[float, float]
    polys: List[NavPoly] = field(default_factory=list)

    @property
    def bounds_xz(self):
        if not self.polys:
            return (0.0, 0.0, 0.0, 0.0)
        allv = np.concatenate([p.verts for p in self.polys], axis=0)
        return (float(allv[:, 0].min()), float(allv[:, 2].min()),
                float(allv[:, 0].max()), float(allv[:, 2].max()))


def _align4(n: int) -> int:
    return (n + 3) & ~3


def parse_tile(data: bytes) -> List[NavPoly]:
    """One Detour tile blob → its walkable polygons (world-space)."""
    if len(data) < struct.calcsize(_HEADER_FMT):
        return []
    h = struct.unpack_from(_HEADER_FMT, data, 0)
    (magic, version, _x, _y, _layer, _user, poly_count, vert_count,
     _max_links, _dmesh, _dverts, _dtris, _bv, _offcon, _offbase) = h[:15]
    if magic != DT_MAGIC:
        raise ValueError(f"bad Detour tile magic {magic:#x}")
    off = _align4(struct.calcsize(_HEADER_FMT))
    verts = np.frombuffer(data, np.float32, vert_count * 3, off)
    verts = verts.reshape(vert_count, 3)
    off = _align4(off + vert_count * 12)
    polys: List[NavPoly] = []
    for i in range(poly_count):
        base = off + i * _POLY_SIZE
        vidx = struct.unpack_from("<6H", data, base + 4)
        flags, = struct.unpack_from("<H", data, base + 28)
        nv = data[base + 30]
        area_and_type = data[base + 31]
        area, ptype = area_and_type & 0x3F, area_and_type >> 6
        if ptype == 1 or nv < 3:     # off-mesh connection / degenerate
            continue
        polys.append(NavPoly(verts=verts[list(vidx[:nv])].copy(),
                             area=area, flags=flags))
    return polys


def parse_nav(blob: bytes) -> NavMeshData:
    """A whole `.nav` zone file → its polygon set."""
    from lumixengine_tpu_torch.utils import native

    magic, = struct.unpack_from("<I", blob, 0)
    off = 4
    if magic == NAV_MAGIC:
        _version, tiles_x = struct.unpack_from("<II", blob, off)
        off += 8
    else:                            # headerless legacy: magic IS tiles_x
        tiles_x = magic
    tiles_z, = struct.unpack_from("<I", blob, off)
    off += 4
    ox, oy, oz, tw, th, _max_tiles, _max_polys = struct.unpack_from(
        "<5f2i", blob, off)
    off += 28
    out = NavMeshData(origin=(ox, oy, oz), tile_size=(tw, th))
    for _ in range(tiles_x * tiles_z):
        if off + 4 > len(blob):
            break
        if magic == NAV_MAGIC:
            dsize, csize = struct.unpack_from("<iI", blob, off)
            off += 8
            if dsize > 0:
                # reference tiles are LZ4 block data (engine.cpp:254-268);
                # needs the native codec (csrc/lz4_codec.cpp)
                tile = native.lz4_decompress(blob[off:off + csize], dsize)
                off += csize
                out.polys.extend(parse_tile(tile))
        else:                        # legacy: i32 size then RAW tile bytes
            dsize, = struct.unpack_from("<i", blob, off)
            off += 4
            if dsize > 0:
                out.polys.extend(parse_tile(blob[off:off + dsize]))
                off += dsize
    return out


def load_nav_zone(guid: int, search_dirs) -> Optional[NavMeshData]:
    """Locate navzones/<guid>.nav under any of `search_dirs` and parse it."""
    for d in search_dirs:
        path = os.path.join(d, "navzones", f"{guid}.nav")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return parse_nav(f.read())
    return None


def rasterize_walkable(nav: NavMeshData, origin_xz, size_xz, cell: float
                       ) -> np.ndarray:
    """Polygon set → bool walkable grid [H, W] on the zone's cell lattice
    (cell centers covered by any walkable poly, xz projection)."""
    w = max(1, int(np.ceil(size_xz[0] / cell)))
    h = max(1, int(np.ceil(size_xz[1] / cell)))
    grid = np.zeros((h, w), bool)
    if not nav.polys:
        return grid
    xs = origin_xz[0] + (np.arange(w) + 0.5) * cell
    zs = origin_xz[1] + (np.arange(h) + 0.5) * cell
    cx = np.broadcast_to(xs[None, :], (h, w))
    cz = np.broadcast_to(zs[:, None], (h, w))
    for poly in nav.polys:
        px, pz = poly.verts[:, 0], poly.verts[:, 2]
        lo_x, hi_x = px.min() - cell, px.max() + cell
        lo_z, hi_z = pz.min() - cell, pz.max() + cell
        box = (cx >= lo_x) & (cx <= hi_x) & (cz >= lo_z) & (cz <= hi_z)
        if not box.any():
            continue
        # point-in-polygon: winding-consistent half-plane test per edge
        # (Detour polys are convex); accept either orientation
        inside_ccw = np.ones_like(box)
        inside_cw = np.ones_like(box)
        n = len(px)
        for i in range(n):
            j = (i + 1) % n
            crossv = ((px[j] - px[i]) * (cz - pz[i])
                      - (pz[j] - pz[i]) * (cx - px[i]))
            inside_ccw &= crossv >= -1e-6
            inside_cw &= crossv <= 1e-6
        grid |= box & (inside_ccw | inside_cw)
    return grid

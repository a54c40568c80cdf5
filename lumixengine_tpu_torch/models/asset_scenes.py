"""Assets built in code for the asset tier (``importers/fbx.py``,
``model_meta``, ``anm``, ``mat``, ``composite_texture``): the repository
ships no asset files, so the tests and ``chip_smoke.py`` write their own.
It makes content with numpy and the standard library, like
``models/host_scenes.py``; the one codec it calls is the port's ``.anm``
encoder, for the take's ``.anm``.

* ``fbx_bytes(nodes, version, compress)`` writes the binary FBX container
  (the 27-byte header, node records with 32-bit offsets below version 7500
  and 64-bit ones from 7500, each list of children closed by a null record,
  arrays raw or zlib-deflated). A node is ``(name, props, children)``; a
  property's type follows its Python or numpy type (see ``_prop_bytes``).
* ``FbxDocument`` emits the objects and connections the importer reads:
  ``GlobalSettings`` with ``UnitScaleFactor``; ``Model`` (LimbNode, Mesh)
  with ``Properties70``; ``Geometry`` (``Vertices``, ``PolygonVertexIndex``,
  ``LayerElementUV``); ``Deformer`` Skin and Cluster; ``AnimationStack``,
  ``AnimationLayer``, ``AnimationCurveNode`` and ``AnimationCurve``; and the
  ``OO`` and ``OP`` connections.
* ``character_fbx(seed)``: a skinned character at the size of the mixamo
  "Y bot" the reference demo ships (52 bones from ``mixamorig:Hips``,
  22,568 control points, about 1.8 m tall, 4-bone weights, a 1 s take of
  every bone); ``skinned_fbx(seed)``: a small skinned document with pre-
  and post-rotations, pivots, every rotation order, a bone without a
  cluster and a take that moves, turns and scales; ``box_fbx``,
  ``sphere_fbx`` (482 vertices), ``rock_fbx`` (962 vertices).
* ``write_assets(data_dir, seed)`` writes the character, the three props
  with their ``.fbx.meta`` sidecars, a ``.mat``, an ``.ltc`` graph that
  reaches every node type the reader knows and the character's take
  encoded as an ``.anm``; ``asset_stress_scene(seed)`` is
  ``host_scenes.stress_scene`` with its model paths on these files.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

FBX_MAGIC = b"Kaydara FBX Binary  \x00"
FBX_TICKS_PER_SECOND = 46_186_158_000

Node = Tuple[str, List[Any], List["Node"]]

# array properties by numpy dtype, scalars by numpy scalar type
_ARRAY_CODE = {np.float32: b"f", np.float64: b"d", np.int64: b"l", np.int32: b"i",
               np.bool_: b"b"}
_SCALAR = {np.int16: (b"Y", "<h"), np.int32: (b"I", "<i"), np.float32: (b"F", "<f"),
           np.float64: (b"D", "<d"), np.int64: (b"L", "<q")}


def _prop_bytes(v, compress: bool) -> bytes:
    """One property record: bool C, int L, float D, str S, bytes R, numpy
    scalars int16 Y, int32 I, float32 F, float64 D, int64 L, numpy arrays
    float32 f, float64 d, int64 l, int32 i, bool b (zlib when `compress`)."""
    if isinstance(v, (bool, np.bool_)):
        return b"C" + bytes([1 if v else 0])
    for t, (code, fmt) in _SCALAR.items():
        if isinstance(v, t):
            return code + struct.pack(fmt, v)
    if isinstance(v, int):
        return b"L" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode("utf-8")
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(v, (bytes, bytearray)):
        return b"R" + struct.pack("<I", len(v)) + bytes(v)
    a = np.ascontiguousarray(v)
    code = _ARRAY_CODE[a.dtype.type]
    raw = a.astype(a.dtype.newbyteorder("<")).tobytes()
    enc = 0
    if compress:
        raw, enc = zlib.compress(raw), 1
    return code + struct.pack("<III", a.size, enc, len(raw)) + raw


def _node_bytes(node: Node, offset: int, big: bool, compress: bool) -> bytes:
    name, props, children = node
    nb = name.encode("ascii")
    pb = b"".join(_prop_bytes(p, compress) for p in props)
    head = 25 if big else 13
    o = offset + head + len(nb) + len(pb)
    body = b""
    for c in children:
        cb = _node_bytes(c, o, big, compress)
        body += cb
        o += len(cb)
    if children:
        body += b"\0" * head
        o += head
    word = "<QQQ" if big else "<III"
    return struct.pack(word, o, len(props), len(pb)) + bytes([len(nb)]) + nb + pb + body


def fbx_bytes(nodes: Sequence[Node], version: int = 7400, compress: bool = False) -> bytes:
    """A binary FBX file of the top-level `nodes`: the header, the records
    (64-bit offsets from version 7500) and the null record that ends them."""
    big = version >= 7500
    out = bytearray(FBX_MAGIC + b"\x1a\x00" + struct.pack("<I", version))
    for n in nodes:
        out += _node_bytes(n, len(out), big, compress)
    out += b"\0" * (25 if big else 13)
    return bytes(out)


# -- the document --------------------------------------------------------------------------

def p70(name: str, *values, kind: str = "", label: str = "", flags: str = "A") -> Node:
    """A Properties70 entry: name, type, label, flags, then the values."""
    return ("P", [name, kind, label, flags, *values], [])


class FbxDocument:
    """The objects and connections of an FBX 7.x document, in the order
    they are added; ``nodes()`` gives the top-level records."""

    def __init__(self, unit_scale: float = 1.0):
        self.unit_scale = float(unit_scale)
        self.objects: List[Node] = []
        self.connections: List[Node] = []
        self._next = 1000

    def new_id(self) -> int:
        self._next += 1
        return self._next * 7919

    def _obj(self, cls: str, name: str, sub: str, children: List[Node]) -> int:
        oid = self.new_id()
        self.objects.append((cls, [oid, f"{name}\x00\x01{cls}", sub], children))
        return oid

    def oo(self, child: int, parent: int) -> None:
        self.connections.append(("C", ["OO", child, parent], []))

    def op(self, child: int, parent: int, prop: str) -> None:
        self.connections.append(("C", ["OP", child, parent, prop], []))

    def model(self, name: str, kind: str = "LimbNode", parent: int = 0,
              props: Sequence[Node] = ()) -> int:
        mid = self._obj("Model", name, kind, [("Properties70", [], list(props))])
        self.oo(mid, parent)
        return mid

    def geometry(self, model: int, verts, polygon_index, uv=None, uv_index=None,
                 mapping: str = "ByPolygonVertex") -> int:
        """A mesh under `model`: control points [N, 3], PolygonVertexIndex
        (the last index of each polygon stored as ~i), and UVs (Direct, or
        IndexToDirect with `uv_index`)."""
        kids: List[Node] = [("Vertices", [np.asarray(verts, np.float64).reshape(-1)], []),
                            ("PolygonVertexIndex", [np.asarray(polygon_index, np.int32)], [])]
        if uv is not None:
            layer: List[Node] = [
                ("MappingInformationType", [mapping], []),
                ("ReferenceInformationType",
                 ["IndexToDirect" if uv_index is not None else "Direct"], []),
                ("UV", [np.asarray(uv, np.float64).reshape(-1)], [])]
            if uv_index is not None:
                layer.append(("UVIndex", [np.asarray(uv_index, np.int32)], []))
            kids.append(("LayerElementUV", [np.int32(0)], layer))
        gid = self._obj("Geometry", "", "Mesh", kids)
        self.oo(gid, model)
        return gid

    def skin(self, geometry: int) -> int:
        sid = self._obj("Deformer", "", "Skin", [])
        self.oo(sid, geometry)
        return sid

    def cluster(self, skin: int, bone: int, indexes, weights, link: np.ndarray) -> int:
        """A skin cluster of `bone`: control point indexes, weights and the
        bone's global bind matrix (column vectors, stored column-major)."""
        cid = self._obj("Deformer", "", "Cluster", [
            ("Indexes", [np.asarray(indexes, np.int32)], []),
            ("Weights", [np.asarray(weights, np.float64)], []),
            ("TransformLink", [np.asarray(link, np.float64).T.reshape(-1)], [])])
        self.oo(cid, skin)
        self.oo(bone, cid)
        return cid

    def take(self, name: str, stop_seconds: float) -> int:
        """An animation stack with its base layer; returns the layer."""
        stop = int(round(stop_seconds * FBX_TICKS_PER_SECOND))
        sid = self._obj("AnimationStack", name, "", [
            ("Properties70", [], [p70("LocalStop", stop, kind="KTime", label="Time", flags="")])])
        lid = self._obj("AnimationLayer", "BaseLayer", "", [])
        self.oo(lid, sid)
        return lid

    def curves(self, layer: int, model: int, prop: str, times, values: Dict[str, Any]) -> None:
        """A curve node on `layer` driving `model`'s `prop` (``Lcl
        Translation``, ``Lcl Rotation`` or ``Lcl Scaling``), one curve per
        axis of `values` ({"d|X": [K]}), keyed at `times` seconds."""
        cn = self._obj("AnimationCurveNode", prop.split()[-1][0], "", [
            ("Properties70", [], [p70(ax, 0.0, kind="Number") for ax in values])])
        self.oo(cn, layer)
        self.op(cn, model, prop)
        ticks = np.round(np.asarray(times, np.float64) * FBX_TICKS_PER_SECOND).astype(np.int64)
        for ax, v in values.items():
            cv = self._obj("AnimationCurve", "", "", [
                ("KeyTime", [ticks], []),
                ("KeyValueFloat", [np.asarray(v, np.float32)], [])])
            self.op(cv, cn, ax)

    def nodes(self) -> List[Node]:
        gs = ("GlobalSettings", [], [("Properties70", [], [
            p70("UnitScaleFactor", self.unit_scale, kind="double", label="Number", flags="")])])
        return [gs, ("Objects", [], self.objects), ("Connections", [], self.connections)]

    def bytes(self, version: int = 7400, compress: bool = False) -> bytes:
        return fbx_bytes(self.nodes(), version, compress)


def translation(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _vec(name: str, v) -> Node:
    return p70(name, *(float(x) for x in v), kind=name, flags="A")


def polygon_index(polys: Sequence[Sequence[int]]) -> np.ndarray:
    """PolygonVertexIndex of polygons: each one's last index stored as ~i."""
    out: List[int] = []
    for p in polys:
        out += [int(i) for i in p[:-1]] + [~int(p[-1])]
    return np.asarray(out, np.int32)


# -- meshes --------------------------------------------------------------------------------

def box_mesh(half: float = 50.0):
    """A cube: 8 control points, 6 quads."""
    s = half
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)], np.float64)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    return v, quads


def sphere_mesh(rings: int = 20, segments: int = 24, radius: float = 50.0):
    """A UV sphere: `rings` rings of `segments` control points and two
    poles; quads between rings and triangle fans at the poles."""
    v = [(0.0, radius, 0.0)]
    for r in range(1, rings + 1):
        th = np.pi * r / (rings + 1)
        for s in range(segments):
            ph = 2 * np.pi * s / segments
            v.append((radius * np.sin(th) * np.cos(ph), radius * np.cos(th),
                      radius * np.sin(th) * np.sin(ph)))
    v.append((0.0, -radius, 0.0))
    polys: List[Tuple[int, ...]] = []
    ring = lambda r, s: 1 + r * segments + s % segments   # noqa: E731
    for s in range(segments):
        polys.append((0, ring(0, s + 1), ring(0, s)))
    for r in range(rings - 1):
        for s in range(segments):
            polys.append((ring(r, s), ring(r, s + 1), ring(r + 1, s + 1), ring(r + 1, s)))
    last = len(v) - 1
    for s in range(segments):
        polys.append((ring(rings - 1, s), ring(rings - 1, s + 1), last))
    return np.asarray(v, np.float64), polys


def _sphere_uv(v: np.ndarray) -> np.ndarray:
    d = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    return np.stack([0.5 + np.arctan2(d[:, 2], d[:, 0]) / (2 * np.pi),
                     0.5 - np.arcsin(np.clip(d[:, 1], -1, 1)) / np.pi], 1)


def _static_prop(doc: FbxDocument, name: str, verts, polys, uv_mode: str, props=()) -> int:
    m = doc.model(name, "Mesh", props=props)
    pvi = polygon_index(polys)
    corners = np.asarray([i for p in polys for i in p], np.int64)
    if uv_mode == "control_point":
        doc.geometry(m, verts, pvi, uv=_sphere_uv(verts), mapping="ByControlPoint")
    elif uv_mode == "polygon_vertex":
        doc.geometry(m, verts, pvi, uv=_sphere_uv(verts)[corners])
    else:                                   # indexed: one UV per control point, by index
        doc.geometry(m, verts, pvi, uv=_sphere_uv(verts), uv_index=corners)
    return m


def box_fbx(seed: int = 0, version: int = 7400, compress: bool = False) -> bytes:
    """A 1 m cube (centimetres), UVs by polygon vertex, Direct."""
    doc = FbxDocument()
    v, q = box_mesh(50.0)
    _static_prop(doc, "Box", v, q, "polygon_vertex")
    return doc.bytes(version, compress)


def sphere_fbx(seed: int = 0, version: int = 7500, compress: bool = True) -> bytes:
    """A UV sphere of 482 control points, 1 m across (centimetres), UVs by
    control point, its mesh model turned and offset."""
    doc = FbxDocument()
    v, p = sphere_mesh(20, 24, 50.0)
    _static_prop(doc, "Sphere", v, p, "control_point",
                 props=[_vec("Lcl Translation", (0, 20, 0)), _vec("Lcl Rotation", (0, 30, 0))])
    return doc.bytes(version, compress)


def rock_fbx(seed: int = 0, version: int = 7500, compress: bool = True) -> bytes:
    """A rock: a sphere of 962 control points (metres: UnitScaleFactor 100)
    pushed in and out by seeded noise, UVs by polygon vertex through an
    index, a geometric offset, rotation and scale on its mesh model."""
    rng = np.random.default_rng(seed + 17)
    doc = FbxDocument(unit_scale=100.0)
    v, p = sphere_mesh(30, 32, 0.6)
    lobes = rng.normal(size=(6, 3))
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    bump = 1.0 + 0.25 * np.tanh(d @ lobes.T).sum(1) / 6 + 0.04 * rng.standard_normal(len(v))
    v = v * bump[:, None] * np.array([1.2, 0.7, 1.0])
    _static_prop(doc, "Rock", v, p, "indexed", props=[
        _vec("Lcl Rotation", (0, 0, 8)), _vec("GeometricTranslation", (0.1, 0.0, -0.05)),
        _vec("GeometricRotation", (0, 25, 0)), _vec("GeometricScaling", (1.0, 1.1, 1.0))])
    return doc.bytes(version, compress)


# -- skinned documents --------------------------------------------------------------------

def _frame(d: np.ndarray):
    d = d / np.linalg.norm(d)
    a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 0.0, 1.0])
    u = np.cross(d, a)
    u /= np.linalg.norm(u)
    return u, np.cross(d, u)


def _tubes(gpos, tips, radii, parents, rings: int, around: int, rng):
    """A skinned tube along each bone (from its position to its tip) with a
    triangle fan closing each end: control points [N, 3], polygons (quads
    and triangles) and per-vertex bone weights [{bone: weight}] over the
    bone, its parent, its grandparent, its first child and the root."""
    first_child = {}
    for b, p in enumerate(parents):
        if p >= 0:
            first_child.setdefault(p, b)
    verts, polys, weights = [], [], []
    for b in range(len(gpos)):
        a, tip = np.asarray(gpos[b], np.float64), np.asarray(tips[b], np.float64)
        u, w = _frame(tip - a)
        base = len(verts)
        for r in range(rings):
            s = r / (rings - 1)
            for k in range(around):
                ang = 2 * np.pi * k / around
                jitter = 1.0 + 0.02 * rng.standard_normal()
                verts.append(a + (tip - a) * s
                             + radii[b] * jitter * (np.cos(ang) * u + np.sin(ang) * w))
                wt = {b: 0.55 + 0.35 * s}
                p = parents[b]
                if p >= 0:
                    wt[p] = wt.get(p, 0.0) + 0.05 + 0.35 * (1 - s)
                    if parents[p] >= 0:
                        wt[parents[p]] = wt.get(parents[p], 0.0) + 0.04 + 0.02 * rng.random()
                if b in first_child:
                    c = first_child[b]
                    wt[c] = wt.get(c, 0.0) + 0.03 * s + 0.01
                wt[0] = wt.get(0, 0.0) + 0.015
                weights.append(wt)
        for r in range(rings - 1):
            for k in range(around):
                i0, i1 = base + r * around + k, base + r * around + (k + 1) % around
                polys.append((i0, i1, i1 + around, i0 + around))
        for end, ring0, wt_s in ((a, 0, 0.0), (tip, rings - 1, 1.0)):
            c = len(verts)
            verts.append(end)
            weights.append(dict(weights[base + ring0 * around]))
            for k in range(around):
                i0 = base + ring0 * around + k
                i1 = base + ring0 * around + (k + 1) % around
                polys.append((c, i1, i0) if ring0 == 0 else (c, i0, i1))
    return np.asarray(verts), polys, weights


def _skin(doc: FbxDocument, geo: int, bone_ids: Sequence[int], weights, links) -> None:
    sk = doc.skin(geo)
    per: Dict[int, Tuple[List[int], List[float]]] = {b: ([], []) for b in range(len(bone_ids))}
    for v, wt in enumerate(weights):
        for b, x in wt.items():
            per[b][0].append(v)
            per[b][1].append(x)
    for b, oid in enumerate(bone_ids):
        doc.cluster(sk, oid, per[b][0], per[b][1], links[b])


def _uv_layer_args(verts, polys, uv_mode):
    corners = np.asarray([i for p in polys for i in p], np.int64)
    uv = _sphere_uv(verts - verts.mean(0))
    if uv_mode == "control_point":
        return dict(uv=uv, mapping="ByControlPoint")
    if uv_mode == "polygon_vertex":
        return dict(uv=uv[corners])
    return dict(uv=uv, uv_index=corners)


_FINGERS = ("Thumb", "Index", "Middle", "Ring", "Pinky")
_FINGER_ROOT = {"Thumb": (3.0, -1.0, 3.0), "Index": (9.0, 0.0, 2.0),
                "Middle": (9.5, 0.0, 0.0), "Ring": (9.0, 0.0, -2.0), "Pinky": (8.0, 0.0, -3.5)}


def character_skeleton():
    """The character's 52 bones: (name, parent index, local translation in
    cm, tube radius in cm), parents before children, ``mixamorig:Hips``
    first."""
    bones: List[Tuple[str, int, Tuple[float, float, float], float]] = []

    def add(name, parent, t, r):
        bones.append((f"mixamorig:{name}", parent, t, r))
        return len(bones) - 1

    hips = add("Hips", -1, (0.0, 100.0, 0.0), 13.0)
    s0 = add("Spine", hips, (0.0, 10.0, 0.0), 12.5)
    s1 = add("Spine1", s0, (0.0, 12.0, 0.0), 12.5)
    s2 = add("Spine2", s1, (0.0, 13.0, 0.0), 13.5)
    neck = add("Neck", s2, (0.0, 15.0, 0.0), 5.0)
    add("Head", neck, (0.0, 10.0, 0.0), 9.0)
    for side, sx in (("Left", 1.0), ("Right", -1.0)):
        sh = add(f"{side}Shoulder", s2, (6.0 * sx, 10.0, 0.0), 5.0)
        arm = add(f"{side}Arm", sh, (12.0 * sx, 0.0, 0.0), 5.0)
        fore = add(f"{side}ForeArm", arm, (27.0 * sx, 0.0, 0.0), 4.0)
        hand = add(f"{side}Hand", fore, (25.0 * sx, 0.0, 0.0), 3.5)
        for f in _FINGERS:
            rx, ry, rz = _FINGER_ROOT[f]
            j = add(f"{side}Hand{f}1", hand, (rx * sx, ry, rz), 0.9)
            for k in (2, 3):
                j = add(f"{side}Hand{f}{k}", j, (3.0 * sx, 0.0, 0.0), 0.8)
    for side, sx in (("Left", 1.0), ("Right", -1.0)):
        up = add(f"{side}UpLeg", hips, (9.0 * sx, -6.0, 0.0), 8.0)
        leg = add(f"{side}Leg", up, (0.0, -42.0, 0.0), 6.0)
        foot = add(f"{side}Foot", leg, (0.0, -40.0, 0.0), 5.0)
        add(f"{side}ToeBase", foot, (0.0, -8.0, 12.0), 4.0)
    return bones


def _tips(gpos, parents, bones):
    tips = []
    for b in range(len(gpos)):
        kids = [c for c in range(len(gpos)) if parents[c] == b]
        if kids:
            tips.append(gpos[kids[0]])
        elif bones[b][0].endswith("Head"):
            tips.append(gpos[b] + np.array([0.0, 20.0, 0.0]))
        else:
            d = gpos[b] - gpos[parents[b]]
            tips.append(gpos[b] + d / np.linalg.norm(d) * max(2.5, 0.5 * np.linalg.norm(d)))
    return tips


def character_fbx(seed: int = 0, version: int = 7400, compress: bool = True,
                  rings: int = 18, around: int = 24) -> bytes:
    """The skinned character (see the module's docstring), in centimetres:
    each bone a LimbNode with pre- and post-rotation (equal, so the bind
    pose is its translation), a rotation pivot and a rotation order from
    `seed`; one mesh of a tube per bone (quads, triangle fans at the ends,
    UVs by polygon vertex through an index); a cluster per bone; and the
    take "Take 001", 1 s: every bone turning on three axes and the hips
    moving, keyed at 10 per second."""
    rng = np.random.default_rng(seed)
    bones = character_skeleton()
    parents = [p for _, p, _, _ in bones]
    gpos = []
    for name, p, t, _ in bones:
        gpos.append(np.asarray(t, np.float64) + (gpos[p] if p >= 0 else 0.0))
    doc = FbxDocument(unit_scale=1.0)
    ids: List[int] = []
    for b, (name, p, t, _) in enumerate(bones):
        pre = rng.uniform(-40, 40, 3)
        ids.append(doc.model(name, "LimbNode", ids[p] if p >= 0 else 0, props=[
            _vec("Lcl Translation", t), _vec("PreRotation", pre), _vec("PostRotation", pre),
            _vec("RotationPivot", rng.uniform(-1, 1, 3)),
            p70("RotationOrder", np.int32(b % 6), kind="enum", flags="")]))
    mesh = doc.model("Beta_Surface", "Mesh")
    verts, polys, weights = _tubes(gpos, _tips(gpos, parents, bones),
                                   [r for *_, r in bones], parents, rings, around, rng)
    geo = doc.geometry(mesh, verts, polygon_index(polys),
                       **_uv_layer_args(verts, polys, "indexed"))
    _skin(doc, geo, ids, weights, [translation(g) for g in gpos])
    layer = doc.take("Take 001", 1.0)
    times = np.arange(11) / 10.0
    for b, oid in enumerate(ids):
        amp, ph = rng.uniform(5, 25, 3), rng.uniform(0, 2 * np.pi, 3)
        doc.curves(layer, oid, "Lcl Rotation", times, {
            ax: amp[k] * np.sin(2 * np.pi * times + ph[k]) for k, ax in enumerate(("d|X", "d|Y",
                                                                                 "d|Z"))})
    t0 = bones[0][2]
    doc.curves(layer, ids[0], "Lcl Translation", times, {
        "d|X": np.full(11, t0[0]), "d|Y": t0[1] + 3.0 * np.sin(4 * np.pi * times),
        "d|Z": t0[2] + 40.0 * times})
    return doc.bytes(version, compress)


def skinned_fbx(seed: int = 0, version: int = 7400, compress: bool = False,
                uv_mode: str = "indexed") -> bytes:
    """A small skinned document: a root ("Armature", no cluster: its bind
    pose comes from its transform chain) over 6 bones in a chain and a fork,
    each bone's pre- and post-rotation unequal, pivots, offsets and a
    rotation order from `seed`; a mesh model turned and offset with a
    geometric transform; UVs by `uv_mode` ("control_point",
    "polygon_vertex" or "indexed"); and a take keyed at uneven times that
    moves, turns and scales the bones."""
    rng = np.random.default_rng(seed)
    doc = FbxDocument(unit_scale=float(rng.choice([1.0, 2.54, 100.0])))
    arm = doc.model("Armature", "LimbNode", props=[
        _vec("Lcl Translation", rng.uniform(-5, 5, 3)), _vec("Lcl Rotation", rng.uniform(-30, 30, 3)),
        _vec("Lcl Scaling", (1.0, 1.0, 1.0))])
    parents = [-1, 0, 1, 2, 1, 4]
    ids, props = [], []
    for b, p in enumerate(parents):
        pr = {"Lcl Translation": (rng.uniform(-2, 2), rng.uniform(5, 15), rng.uniform(-2, 2)),
              "Lcl Rotation": rng.uniform(-45, 45, 3), "PreRotation": rng.uniform(-60, 60, 3),
              "PostRotation": rng.uniform(-60, 60, 3), "RotationPivot": rng.uniform(-2, 2, 3),
              "RotationOffset": rng.uniform(-1, 1, 3), "ScalingPivot": rng.uniform(-1, 1, 3),
              "ScalingOffset": rng.uniform(-1, 1, 3), "Lcl Scaling": rng.uniform(0.8, 1.25, 3)}
        props.append(pr)
        ids.append(doc.model(f"bone{b}", "LimbNode", ids[p] if p >= 0 else arm, props=[
            *(_vec(k, v) for k, v in pr.items()),
            p70("RotationOrder", np.int32(b % 6), kind="enum", flags="")]))
    mesh = doc.model("Body", "Mesh", props=[
        _vec("Lcl Translation", rng.uniform(-3, 3, 3)), _vec("Lcl Rotation", rng.uniform(-20, 20, 3)),
        _vec("GeometricTranslation", rng.uniform(-1, 1, 3)),
        _vec("GeometricRotation", rng.uniform(-15, 15, 3)),
        _vec("GeometricScaling", rng.uniform(0.9, 1.1, 3))])
    gpos = [np.zeros(3)]
    for b in range(1, len(parents)):
        gpos.append(gpos[parents[b]] + np.asarray(props[b]["Lcl Translation"]))
    verts, polys, weights = _tubes(gpos, _tips(gpos, parents, [(f"bone{b}",) for b in parents]),
                                   [1.5] * len(parents), parents, 5, 8, rng)
    geo = doc.geometry(mesh, verts, polygon_index(polys), **_uv_layer_args(verts, polys, uv_mode))
    links = [translation(g) @ _rot_y(rng.uniform(-30, 30)) for g in gpos]
    _skin(doc, geo, ids, weights, links)
    layer = doc.take("Take 001", 0.5)
    times = np.sort(np.concatenate([[0.0, 0.5], rng.uniform(0.02, 0.48, 5)]))
    for b, oid in enumerate(ids):
        t, r = props[b]["Lcl Translation"], props[b]["Lcl Rotation"]
        doc.curves(layer, oid, "Lcl Rotation", times, {
            "d|X": r[0] + rng.uniform(-30, 30, len(times)), "d|Z": r[2] + 20 * times})
        if b % 2 == 0:
            doc.curves(layer, oid, "Lcl Translation", times, {
                "d|Y": t[1] + rng.uniform(-1, 1, len(times))})
        if b == 3:
            doc.curves(layer, oid, "Lcl Scaling", times, {"d|X": 1.0 + times, "d|Y": 1.0 - 0.5 * times})
    return doc.bytes(version, compress)


def _rot_y(deg: float) -> np.ndarray:
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


# -- the other asset files ----------------------------------------------------------------

MAT_TEXT = """shader "/engine/shaders/standard.hlsl"
backface_culling false
layer "transparent"
define "ALPHA_CUTOUT"
define "HAS_NORMALMAP"
texture "textures/rock_albedo.tga"
texture ""
texture "textures/rock_normal.tga"
custom_flag "require8bit"
int_uniform "Frames cols", 2
uniform "Material color", { 0.8, 0.55, 0.3, 1 }
uniform "Roughness", 0.75
uniform "Metallic", 0.125
uniform "Emission", 0
uniform "Alpha ref", 0.3
"""

# node type numbers of the .ltc format (composite_texture.cpp's node list)
LTC_TYPES = {"OUTPUT": 0, "INPUT": 1, "INVERT": 2, "COLOR": 3, "SPLIT": 4, "MERGE": 5, "FLIP": 6,
             "GAMMA": 7, "CONTRAST": 8, "BRIGHTNESS": 9, "GRAYSCALE": 10, "MULTIPLY": 11,
             "MIX": 12, "CONSTANT": 15, "RESIZE": 16, "CIRCLE": 17, "GRADIENT_NOISE": 20,
             "SET_ALPHA": 23, "STEP": 27, "DIVIDE": 38, "MIN": 39, "MAX": 40}


def _ltc_payload(kind: str, p: dict) -> bytes:
    f = lambda *v: struct.pack(f"<{len(v)}f", *v)    # noqa: E731
    u = lambda *v: struct.pack(f"<{len(v)}I", *v)    # noqa: E731
    if kind == "OUTPUT":
        return u(p["output_type"], p["layers"], p["channels"])
    if kind == "INPUT":
        return p["texture"].encode() + b"\0"
    if kind == "COLOR":
        return f(*p["color"])
    if kind == "FLIP":
        return bytes([1 if p["horizontal"] else 0])
    if kind in ("GAMMA", "CONTRAST", "BRIGHTNESS", "MIX", "CONSTANT", "STEP"):
        return f(p[{"GAMMA": "gamma", "CONTRAST": "contrast", "BRIGHTNESS": "brightness",
                    "MIX": "alpha", "CONSTANT": "value", "STEP": "value"}[kind]])
    if kind in ("CIRCLE", "GRADIENT_NOISE"):
        return u(p["w"], p["h"]) + f(p["power"] if kind == "CIRCLE" else p["scale"])
    if kind == "RESIZE":
        return struct.pack("<i", p["rtype"]) + u(*p["size"]) + f(*p["scale"])
    return b""


def ltc_bytes(nodes: Sequence[Tuple[str, int, dict]],
              links: Sequence[Tuple[int, int, int, int]]) -> bytes:
    """An ``.ltc`` blob: the '_LTC' magic, version 0, the id generator, the
    nodes (type, u16 id, position, payload) and the links (from id | pin <<
    16, to id | pin << 16)."""
    out = bytearray(struct.pack("<III", 0x5F4C5443, 0, max(n[1] for n in nodes) + 1))
    out += struct.pack("<i", len(nodes))
    for k, (kind, nid, p) in enumerate(nodes):
        out += struct.pack("<IHff", LTC_TYPES[kind], nid, 40.0 * k, 20.0 * (k % 3))
        out += _ltc_payload(kind, p)
    out += struct.pack("<i", len(links))
    for f_id, f_pin, t_id, t_pin in links:
        out += struct.pack("<II", f_id | f_pin << 16, t_id | t_pin << 16)
    return bytes(out)


LTC_TEXTURE = "textures/detail.tga"


def composite_graph():
    """The nodes and links of a two-layer graph through every node type the
    reader knows: layer 0 from gradient noise and a circle through step,
    multiply, divide, min, max, gamma, contrast, brightness, invert, flip,
    a split into a merge, grayscale, a resize by percent and set-alpha;
    layer 1 an input texture mixed with a colour and resized in pixels."""
    nodes = [
        ("OUTPUT", 1, {"output_type": 1, "layers": 2, "channels": 4}),
        ("GRADIENT_NOISE", 2, {"w": 64, "h": 64, "scale": 4.0}),
        ("CIRCLE", 3, {"w": 64, "h": 64, "power": 1.5}),
        ("STEP", 4, {"value": 0.5}),
        ("MULTIPLY", 5, {}), ("DIVIDE", 6, {}), ("MIN", 7, {}),
        ("CONSTANT", 8, {"value": 0.1}), ("MAX", 9, {}),
        ("GAMMA", 10, {"gamma": 2.2}), ("CONTRAST", 11, {"contrast": 30.0}),
        ("BRIGHTNESS", 12, {"brightness": 0.05}), ("INVERT", 13, {}),
        ("FLIP", 14, {"horizontal": True}), ("SPLIT", 15, {}), ("MERGE", 16, {}),
        ("GRAYSCALE", 17, {}),
        ("RESIZE", 18, {"rtype": 1, "size": (0, 0), "scale": (50.0, 50.0)}),
        ("SET_ALPHA", 19, {}),
        ("INPUT", 20, {"texture": LTC_TEXTURE}),
        ("COLOR", 21, {"color": (0.8, 0.4, 0.2, 1.0)}),
        ("MIX", 22, {"alpha": 0.25}),
        ("RESIZE", 23, {"rtype": 0, "size": (48, 40), "scale": (100.0, 100.0)}),
    ]
    links = [(2, 0, 4, 0), (2, 0, 5, 0), (3, 0, 5, 1), (5, 0, 6, 0), (3, 0, 6, 1),
             (6, 0, 7, 0), (4, 0, 7, 1), (7, 0, 9, 0), (8, 0, 9, 1), (9, 0, 10, 0),
             (10, 0, 11, 0), (11, 0, 12, 0), (12, 0, 13, 0), (13, 0, 14, 0), (14, 0, 15, 0),
             (15, 0, 16, 0), (15, 1, 16, 1), (15, 2, 16, 2), (16, 0, 17, 0), (17, 0, 18, 0),
             (18, 0, 19, 0), (3, 0, 19, 1), (19, 0, 1, 0),
             (20, 0, 22, 0), (21, 0, 22, 1), (22, 0, 23, 0), (23, 0, 1, 1)]
    return nodes, links


def detail_texture(seed: int = 0, size: int = 24) -> np.ndarray:
    """The INPUT node's texture: f32 [size, size, 4] in [0, 1]."""
    rng = np.random.default_rng(seed + 5)
    img = rng.random((size, size, 4)).astype(np.float32)
    img[..., 3] = 1.0
    return img


def texture_loader(seed: int = 0):
    """A loader for the composite graph's INPUT nodes (path → image)."""
    img = detail_texture(seed)
    return lambda path: img if path == LTC_TEXTURE else None


def meta_text(physics: str = "none") -> str:
    """A prop's ``.fbx.meta``: scale 0.5, origin bottom, 3 LODs."""
    out = ([f'physics = "{physics}"'] if physics != "none" else []) + [
        'origin = "bottom"', "lod_count = 3", "scale = 0.5",
        "lod0_distance = 30.0", "lod1_distance = 80.0", "lod2_distance = 200.0"]
    return "\n".join(out) + "\n"


PAT_TEXT = """emitter sparks {
	max_particles 256
	init_emit_count 8
	emit_per_second 120
	var pos : float3
	var vel : float3
	var life : float
	fn emit() {
		pos = {0, 0, 0};
		vel.x = random(-1, 1);
		vel.y = random(2, 4);
		vel.z = random(-1, 1);
		life = random(0.2, 0.6);
	}
	fn update() {
		vel.y = vel.y - 9.8 * time_delta;
		pos = pos + vel * time_delta;
		life = life - time_delta;
		if life < 0 { kill(); }
	}
}
"""


def act_bytes(model: str, take: str) -> bytes:
    """A version-6 ``.act`` controller on `model`: inputs speed_x, speed_y
    and stance, four locomotion slots (idle, walk forward, walk left, run
    forward), each on the clip `take` (a ``.ani:<fbx>`` path)."""
    inputs = [(0, b"speed_x"), (0, b"speed_y"), (3, b"stance")]
    slots = [b"idle", b"walk forward", b"walk left", b"run forward"]
    out = b"CAL_" + struct.pack("<II", 6, len(slots)) + model.encode() + b"\0"
    out += struct.pack("<I", len(inputs))
    for t, name in inputs:
        out += struct.pack("<I", t) + name.ljust(32, b"\0")
    out += struct.pack("<I", len(slots)) + b"".join(s + b"\0" for s in slots)
    out += struct.pack("<I", len(slots))
    for i in range(len(slots)):
        out += struct.pack("<II", i, 0) + take.encode() + b"\0"
    return out


CHARACTER = "models/character.fbx"
PROPS = {"box": "models/box.fbx", "sphere": "models/sphere.fbx", "rock": "models/rock.fbx"}
MAT = "materials/rock.mat"
LTC = "textures/detail.ltc"
ANM = "models/character.anm"


def write_assets(data_dir: str, seed: int = 0) -> Dict[str, str]:
    """Write the character, the props with their ``.meta``, the ``.mat``,
    the ``.ltc`` and the take's ``.anm`` under `data_dir`; returns {name:
    path relative to `data_dir`}. The ``.anm`` comes from the port's
    encoder (``importers/anm.compile_fbx_animations``)."""
    from lumixengine_tpu_torch.importers import anm

    files = {CHARACTER: character_fbx(seed), PROPS["box"]: box_fbx(seed),
             PROPS["sphere"]: sphere_fbx(seed), PROPS["rock"]: rock_fbx(seed),
             MAT: MAT_TEXT.encode(), LTC: ltc_bytes(*composite_graph())}
    for name, path in PROPS.items():
        files[path + ".meta"] = meta_text("convex" if name == "rock" else "none").encode()
    takes = anm.compile_fbx_animations(CHARACTER, files[CHARACTER])
    files[ANM] = takes["character"]
    for rel, data in files.items():
        full = os.path.join(data_dir, rel)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)
    return {"character": CHARACTER, **PROPS, "mat": MAT, "ltc": LTC, "anm": ANM}


# the stress scene's placeholder paths → the written assets
_SCENE_MODELS = {"models/hero.fbx": CHARACTER, "models/slab.fbx": PROPS["box"],
                 "models/cube.fbx": PROPS["box"], "models/crate.fbx": PROPS["box"],
                 "models/lamp.fbx": PROPS["box"], "models/spawned.fbx": PROPS["box"],
                 "models/sphere.fbx": PROPS["sphere"], "models/tree.fbx": PROPS["sphere"],
                 "models/rock.fbx": PROPS["rock"]}


def asset_stress_scene(seed: int = 0, **kw) -> Dict[str, Any]:
    """``host_scenes.stress_scene(seed, **kw)`` with every model instance on
    the written assets: the animables on the character and its take
    (``.ani:models/character.fbx``), the bodies, the slab and the groups'
    models on the box, the sphere and the rock, and the model the Lua
    spawner creates on the box."""
    from lumixengine_tpu_torch.models import host_scenes as H

    sc = H.stress_scene(seed, **kw)
    for mi in sc["renderer"]["model_instances"]:
        mi["model"] = _SCENE_MODELS[mi["model"]]
    for an in sc["animation"]["animables"]:
        an["animation"] = f".ani:{CHARACTER}"
    for s in sc["lua_script"]["inline_scripts"]:
        s["source"] = s["source"].replace("models/spawned.fbx", PROPS["box"])
    return sc

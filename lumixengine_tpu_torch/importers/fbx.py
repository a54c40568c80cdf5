"""Binary FBX importer (counterpart of ``lumixengine_tpu/importers/fbx.py``;
the binary container layout and the FBX 7.x object/connection model are
public knowledge, e.g. the Blender developer documentation of the format).
It stands in for the reference's openfbx-based
`renderer/editor/fbx_importer.cpp` for the capability set this engine needs:

  * `to_model`  — skinned mesh: control points, ≤4 bone influences, skeleton
                  (topo-sorted, local bind pose), bounding radius
  * `to_clip`   — animation take sampled into dense local bone tracks
                  (importers bake dense; see animation/animation.py ClipBank)

Supports FBX ≥ 7.1 binary (u32 offsets) and ≥ 7.5 (u64 offsets), zlib-deflated
arrays, the full local-transform chain with pivots/offsets/pre/post rotations
and all six Euler rotation orders. Units are normalised to meters via
GlobalSettings UnitScaleFactor (FBX native unit is cm).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_MAGIC = b"Kaydara FBX Binary  \x00"
FBX_TICKS_PER_SECOND = 46_186_158_000


# ---------------------------------------------------------------------------
# container parsing

@dataclass
class FNode:
    name: str
    props: List[Any]
    children: List["FNode"] = field(default_factory=list)

    def find(self, name: str) -> Optional["FNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FNode"]:
        return [c for c in self.children if c.name == name]

    def prop(self, i: int = 0, default=None):
        return self.props[i] if i < len(self.props) else default


_ARRAY_FMT = {b"f": ("<f4", 4), b"d": ("<f8", 8), b"l": ("<i8", 8),
              b"i": ("<i4", 4), b"b": ("<u1", 1)}
_SCALAR_FMT = {b"Y": ("<h", 2), b"C": ("<B", 1), b"I": ("<i", 4),
               b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8)}


def _read_props(data: bytes, o: int, count: int) -> Tuple[List[Any], int]:
    out: List[Any] = []
    for _ in range(count):
        t = data[o:o + 1]
        o += 1
        if t in _SCALAR_FMT:
            fmt, sz = _SCALAR_FMT[t]
            v = struct.unpack_from(fmt, data, o)[0]
            if t == b"C":
                v = bool(v & 1)
            out.append(v)
            o += sz
        elif t in _ARRAY_FMT:
            n, enc, blen = struct.unpack_from("<III", data, o)
            o += 12
            raw = data[o:o + blen]
            o += blen
            if enc == 1:
                raw = zlib.decompress(raw)
            dt, isz = _ARRAY_FMT[t]
            arr = np.frombuffer(raw, dtype=dt, count=n)
            out.append(arr.astype(bool) if t == b"b" else arr)
        elif t == b"S":
            n = struct.unpack_from("<I", data, o)[0]
            o += 4
            out.append(data[o:o + n].decode("utf-8", "replace"))
            o += n
        elif t == b"R":
            n = struct.unpack_from("<I", data, o)[0]
            o += 4
            out.append(data[o:o + n])
            o += n
        else:
            raise ValueError(f"fbx: unknown property type {t!r} at {o - 1}")
    return out, o


def parse_fbx(data: bytes) -> FNode:
    if not data.startswith(_MAGIC):
        raise ValueError("fbx: not a binary FBX file")
    version = struct.unpack_from("<I", data, 23)[0]
    big = version >= 7500
    word = "<QQQ" if big else "<III"
    wsz = 24 if big else 12
    sentinel = 25 if big else 13

    def read_node(o: int) -> Tuple[Optional[FNode], int]:
        end, nprops, plen = struct.unpack_from(word, data, o)
        o += wsz
        nlen = data[o]
        o += 1
        if end == 0:  # null record
            return None, o + nlen
        name = data[o:o + nlen].decode("ascii", "replace")
        o += nlen
        props, o = _read_props(data, o, nprops)
        node = FNode(name, props)
        while o < end - sentinel:
            child, o = read_node(o)
            if child is not None:
                node.children.append(child)
        if o < end:  # consume the null-record terminator
            o = end
        return node, o

    root = FNode("", [])
    o = 27
    while o < len(data) - sentinel:
        node, o = read_node(o)
        if node is None:
            break
        root.children.append(node)
    root.props = [version]
    return root


# ---------------------------------------------------------------------------
# document model

def _p70(node: FNode) -> Dict[str, List[Any]]:
    """Properties70 → {name: raw value list (after the 4 header entries)}."""
    out: Dict[str, List[Any]] = {}
    p = node.find("Properties70")
    if p is None:
        return out
    for c in p.find_all("P"):
        out[c.prop(0)] = c.props[4:]
    return out


def _vec3(props: Dict[str, List[Any]], key: str, default=(0.0, 0.0, 0.0)):
    v = props.get(key)
    if v is None or len(v) < 3:
        return np.asarray(default, np.float64)
    return np.asarray(v[:3], np.float64)


class FbxObject:
    def __init__(self, node: FNode):
        self.node = node
        self.id = int(node.prop(0))
        nm = node.prop(1, "")
        self.name = nm.split("\x00")[0] if isinstance(nm, str) else ""
        self.subtype = node.prop(2, "")
        self.props = _p70(node)


class FbxDoc:
    """Objects + connections with typed lookups."""

    def __init__(self, root: FNode):
        self.root = root
        self.objects: Dict[int, FbxObject] = {}
        self.by_class: Dict[str, List[FbxObject]] = {}
        objs = root.find("Objects")
        if objs is not None:
            for n in objs.children:
                o = FbxObject(n)
                self.objects[o.id] = o
                self.by_class.setdefault(n.name, []).append(o)
        # connections: (child, parent[, property])
        self.parents: Dict[int, List[Tuple[int, Optional[str]]]] = {}
        self.children: Dict[int, List[Tuple[int, Optional[str]]]] = {}
        conns = root.find("Connections")
        if conns is not None:
            for c in conns.find_all("C"):
                kind = c.prop(0)
                a, b = int(c.prop(1)), int(c.prop(2))
                pname = c.prop(3) if kind == "OP" else None
                self.parents.setdefault(a, []).append((b, pname))
                self.children.setdefault(b, []).append((a, pname))
        gs = root.find("GlobalSettings")
        p = _p70(gs) if gs is not None else {}
        unit = float(p.get("UnitScaleFactor", [1.0])[0] or 1.0)
        self.scale = unit * 0.01  # FBX cm → meters

    def connected_children(self, oid: int, cls: Optional[str] = None,
                           prop: object = "any") -> List[FbxObject]:
        out = []
        for cid, pname in self.children.get(oid, []):
            if prop != "any" and pname != prop:
                continue
            o = self.objects.get(cid)
            if o is not None and (cls is None or o.node.name == cls):
                out.append(o)
        return out

    def connected_parents(self, oid: int, cls: Optional[str] = None) -> List[FbxObject]:
        out = []
        for pid, _ in self.parents.get(oid, []):
            o = self.objects.get(pid)
            if o is not None and (cls is None or o.node.name == cls):
                out.append(o)
        return out

    def op_target(self, oid: int) -> List[Tuple[FbxObject, str]]:
        """(parent object, property name) for OP connections of oid."""
        out = []
        for pid, pname in self.parents.get(oid, []):
            if pname is not None and pid in self.objects:
                out.append((self.objects[pid], pname))
        return out


def load_fbx(path: str) -> FbxDoc:
    with open(path, "rb") as f:
        return FbxDoc(parse_fbx(f.read()))


# ---------------------------------------------------------------------------
# transform math (numpy 4x4, column-vector convention)

def _rot_matrix(euler_deg: np.ndarray, order: int) -> np.ndarray:
    rx, ry, rz = np.radians(np.asarray(euler_deg, np.float64))

    def R(axis, a):
        c, s = np.cos(a), np.sin(a)
        m = np.eye(4)
        if axis == 0:
            m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
        elif axis == 1:
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        else:
            m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
        return m

    mx, my, mz = R(0, rx), R(1, ry), R(2, rz)
    orders = {0: (mz, my, mx), 1: (my, mz, mx), 2: (mx, mz, my),
              3: (mz, mx, my), 4: (my, mx, mz), 5: (mx, my, mz)}
    a, b, c = orders.get(order, (mz, my, mx))
    return a @ b @ c


def _t_matrix(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _s_matrix(v) -> np.ndarray:
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def local_matrix(props: Dict[str, List[Any]], t=None, r=None, s=None) -> np.ndarray:
    """FBX local transform chain:
    T · Roff · Rp · Rpre · R · Rpost⁻¹ · Rp⁻¹ · Soff · Sp · S · Sp⁻¹"""
    t = _vec3(props, "Lcl Translation") if t is None else np.asarray(t, np.float64)
    r = _vec3(props, "Lcl Rotation") if r is None else np.asarray(r, np.float64)
    s = _vec3(props, "Lcl Scaling", (1, 1, 1)) if s is None else np.asarray(s, np.float64)
    order = int(props.get("RotationOrder", [0])[0] or 0)
    roff = _vec3(props, "RotationOffset")
    rp = _vec3(props, "RotationPivot")
    rpre = _vec3(props, "PreRotation")
    rpost = _vec3(props, "PostRotation")
    soff = _vec3(props, "ScalingOffset")
    sp = _vec3(props, "ScalingPivot")
    m = (_t_matrix(t) @ _t_matrix(roff) @ _t_matrix(rp)
         @ _rot_matrix(rpre, 0) @ _rot_matrix(r, order)
         @ np.linalg.inv(_rot_matrix(rpost, 0)) @ _t_matrix(-rp)
         @ _t_matrix(soff) @ _t_matrix(sp) @ _s_matrix(s) @ _t_matrix(-sp))
    return m


def geometric_matrix(props: Dict[str, List[Any]]) -> np.ndarray:
    return (_t_matrix(_vec3(props, "GeometricTranslation"))
            @ _rot_matrix(_vec3(props, "GeometricRotation"), 0)
            @ _s_matrix(_vec3(props, "GeometricScaling", (1, 1, 1))))


def _mat_to_posquat(m: np.ndarray, scale: float = 1.0):
    """Decompose: returns (pos*scale f32[3], quat xyzw f32[4])."""
    pos = (m[:3, 3] * scale).astype(np.float32)
    r = m[:3, :3].astype(np.float64)
    sc = np.linalg.norm(r, axis=0)
    sc = np.where(sc < 1e-12, 1.0, sc)
    r = r / sc
    # Shepperd's method
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0:
        s_ = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s_
        x = (r[2, 1] - r[1, 2]) / s_
        y = (r[0, 2] - r[2, 0]) / s_
        z = (r[1, 0] - r[0, 1]) / s_
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s_ = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w = (r[2, 1] - r[1, 2]) / s_
        x = 0.25 * s_
        y = (r[0, 1] + r[1, 0]) / s_
        z = (r[0, 2] + r[2, 0]) / s_
    elif r[1, 1] > r[2, 2]:
        s_ = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w = (r[0, 2] - r[2, 0]) / s_
        x = (r[0, 1] + r[1, 0]) / s_
        y = 0.25 * s_
        z = (r[1, 2] + r[2, 1]) / s_
    else:
        s_ = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w = (r[1, 0] - r[0, 1]) / s_
        x = (r[0, 2] + r[2, 0]) / s_
        y = (r[1, 2] + r[2, 1]) / s_
        z = 0.25 * s_
    q = np.asarray([x, y, z, w], np.float32)
    return pos, q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# skeleton + model extraction

def _model_parent(doc: FbxDoc, oid: int) -> Optional[FbxObject]:
    for p in doc.connected_parents(oid, "Model"):
        return p
    return None


def build_skeleton(doc: FbxDoc):
    """Skeleton from skin clusters' bones + their Model ancestors.

    Returns (Skeleton, bone_id_list) — ids aligned with skeleton rows."""
    from lumixengine_tpu_torch.renderer.model import Skeleton

    bone_ids: List[int] = []
    seen = set()
    bind_global: Dict[int, np.ndarray] = {}
    for cl in doc.by_class.get("Deformer", []):
        if "Cluster" not in (cl.subtype or ""):
            continue
        tl = cl.node.find("TransformLink")
        bones = doc.connected_children(cl.id, "Model", prop=None)
        if not bones:
            continue
        b = bones[0]
        chain = []
        cur: Optional[FbxObject] = b
        while cur is not None:
            chain.append(cur)
            cur = _model_parent(doc, cur.id)
        for m in reversed(chain):  # root-first
            if m.id not in seen:
                seen.add(m.id)
                bone_ids.append(m.id)
        if tl is not None:
            bind_global[b.id] = np.asarray(tl.prop(0), np.float64).reshape(4, 4).T
    if not bone_ids:
        raise ValueError("fbx: no skin clusters — not a skinned model")

    # global bind for bones without clusters: parent chain of local defaults
    def global_default(oid: int) -> np.ndarray:
        if oid in bind_global:
            return bind_global[oid]
        o = doc.objects[oid]
        p = _model_parent(doc, oid)
        m = local_matrix(o.props)
        g = (global_default(p.id) @ m) if p is not None else m
        bind_global[oid] = g
        return g

    n = len(bone_ids)
    idx = {oid: i for i, oid in enumerate(bone_ids)}
    parent = np.full(n, -1, np.int32)
    bind_pos = np.zeros((n, 3), np.float32)
    bind_rot = np.zeros((n, 4), np.float32)
    names = []
    for i, oid in enumerate(bone_ids):
        p = _model_parent(doc, oid)
        g = global_default(oid)
        if p is not None and p.id in idx:
            parent[i] = idx[p.id]
            local = np.linalg.inv(global_default(p.id)) @ g
        else:
            local = g
        bind_pos[i], bind_rot[i] = _mat_to_posquat(local, doc.scale)
        names.append(doc.objects[oid].name)
    sk = Skeleton(bone_parent=parent, bind_pos=bind_pos, bind_rot=bind_rot,
                  bone_names=names)
    return sk, bone_ids, bind_global


def _geo_cp_uvs(geo: FbxObject, n_cp: int) -> Optional[np.ndarray]:
    """Per-control-point UVs [n_cp, 2] from a geometry's LayerElementUV
    (mapping ByControlPoint or ByPolygonVertex, reference Direct or
    IndexToDirect — the shipped content uses ByPolygonVertex+IndexToDirect).
    Our meshes are control-point indexed, so polygon-vertex UVs AVERAGE
    onto their control point — exact on seamless meshes, a documented
    mip-0-ish approximation across UV seams."""
    uvn = geo.node.find("LayerElementUV")
    if uvn is None:
        return None
    uvv = uvn.find("UV")
    if uvv is None or uvv.prop(0) is None:
        return None
    uv = np.asarray(uvv.prop(0), np.float64).reshape(-1, 2)

    def _s(node, default=""):
        v = node.prop(0) if node is not None else None
        return v.decode() if isinstance(v, bytes) else (v or default)

    mapping = _s(uvn.find("MappingInformationType"), "ByPolygonVertex")
    ref = _s(uvn.find("ReferenceInformationType"), "Direct")
    idxn = uvn.find("UVIndex")
    if ref == "IndexToDirect" and idxn is not None and len(uv):
        uvi = np.asarray(idxn.prop(0), np.int64)
        per = uv[np.clip(uvi, 0, len(uv) - 1)]
        per[uvi < 0] = 0.0                   # -1 = polygon vertex without UV
    else:
        per = uv
    out = np.zeros((n_cp, 2), np.float64)
    if mapping == "ByControlPoint":
        n = min(n_cp, len(per))
        out[:n] = per[:n]
        return out
    pvi = geo.node.find("PolygonVertexIndex")
    if pvi is None:
        return None
    raw = np.asarray(pvi.prop(0), np.int64)
    cp = np.where(raw < 0, ~raw, raw)
    cnt = np.zeros(n_cp, np.float64)
    n = min(len(cp), len(per))
    good = cp[:n] < n_cp
    np.add.at(out, cp[:n][good], per[:n][good])
    np.add.at(cnt, cp[:n][good], 1.0)
    return out / np.maximum(cnt[:, None], 1.0)


def to_model(doc: FbxDoc, name: str = "fbx"):
    """FBX → renderer Model: merged control points, top-4 skin weights,
    skeleton, bounding radius. Unskinned meshes give a static model."""
    from lumixengine_tpu_torch.renderer.model import Model

    skeleton = None
    bone_ids: List[int] = []
    try:
        skeleton, bone_ids, _bind = build_skeleton(doc)
    except ValueError:
        pass
    idx = {oid: i for i, oid in enumerate(bone_ids)}

    all_pos: List[np.ndarray] = []
    all_w: List[np.ndarray] = []
    all_b: List[np.ndarray] = []
    all_tris: List[np.ndarray] = []
    all_uv: List[np.ndarray] = []
    any_uv = False
    vert_base = 0
    for geo in doc.by_class.get("Geometry", []):
        vn = geo.node.find("Vertices")
        if vn is None:
            continue
        cp = np.asarray(vn.prop(0), np.float64).reshape(-1, 3)
        uv_cp = _geo_cp_uvs(geo, cp.shape[0])
        any_uv = any_uv or uv_cp is not None
        all_uv.append((uv_cp if uv_cp is not None
                       else np.zeros((cp.shape[0], 2))).astype(np.float32))
        # polygons → fan-triangulated indices (negative = ~last-of-polygon,
        # the FBX PolygonVertexIndex convention); kept for trimesh cooking
        pvi = geo.node.find("PolygonVertexIndex")
        if pvi is not None:
            raw = np.asarray(pvi.prop(0), np.int64)
            tris = []
            poly: List[int] = []
            for ix in raw:
                poly.append(int(~ix) if ix < 0 else int(ix))
                if ix < 0:
                    for t in range(1, len(poly) - 1):
                        tris.append((poly[0], poly[t], poly[t + 1]))
                    poly = []
            if tris:
                all_tris.append(np.asarray(tris, np.int32) + vert_base)
        vert_base += cp.shape[0]
        # mesh model's global transform + geometric transform
        models = doc.connected_parents(geo.id, "Model")
        gm = np.eye(4)
        if models:
            mo = models[0]
            chain = []
            cur: Optional[FbxObject] = mo
            while cur is not None:
                chain.append(cur)
                cur = _model_parent(doc, cur.id)
            for m in reversed(chain):
                gm = gm @ local_matrix(m.props)
            gm = gm @ geometric_matrix(mo.props)
        cp = (cp @ gm[:3, :3].T + gm[:3, 3]) * doc.scale
        nv = cp.shape[0]
        w = np.zeros((nv, 4), np.float32)
        b = np.zeros((nv, 4), np.int32)
        if skeleton is not None:
            acc: Dict[int, Dict[int, float]] = {}
            for skin in doc.connected_children(geo.id, "Deformer"):
                if "Skin" not in (skin.subtype or ""):
                    continue
                for cl in doc.connected_children(skin.id, "Deformer"):
                    bones = doc.connected_children(cl.id, "Model", prop=None)
                    ixn = cl.node.find("Indexes")
                    wn = cl.node.find("Weights")
                    if not bones or ixn is None or wn is None:
                        continue
                    bi = idx.get(bones[0].id)
                    if bi is None:
                        continue
                    for v, wt in zip(np.asarray(ixn.prop(0)), np.asarray(wn.prop(0))):
                        acc.setdefault(int(v), {})[bi] = float(wt)
            for v, m in acc.items():
                top = sorted(m.items(), key=lambda kv: -kv[1])[:4]
                tw = sum(x for _, x in top) or 1.0
                for k, (bi, wt) in enumerate(top):
                    b[v, k] = bi
                    w[v, k] = wt / tw
        all_pos.append(cp.astype(np.float32))
        all_w.append(w)
        all_b.append(b)

    if not all_pos:
        raise ValueError("fbx: no geometry")
    vpos = np.concatenate(all_pos)
    vw = np.concatenate(all_w)
    vb = np.concatenate(all_b)
    radius = float(np.linalg.norm(vpos, axis=1).max()) if len(vpos) else 1.0
    return Model(
        name=name, bounding_radius=max(radius, 1e-3), skeleton=skeleton,
        vertex_positions=vpos,
        vertex_uvs=np.concatenate(all_uv) if any_uv else None,
        vertex_triangles=np.concatenate(all_tris) if all_tris else None,
        vertex_bone=vb[:, 0] if skeleton is not None else None,
        vertex_weights=vw if skeleton is not None else None,
        vertex_bones4=vb if skeleton is not None else None,
    )


# ---------------------------------------------------------------------------
# animation takes

def _sample_curve(times: np.ndarray, values: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Linear resample of an FBX curve at ts (seconds)."""
    if len(times) == 0:
        return np.zeros_like(ts)
    t = times.astype(np.float64) / FBX_TICKS_PER_SECOND
    return np.interp(ts, t, values.astype(np.float64))


def to_clip(doc: FbxDoc, skeleton, name: str = "take", fps: float = 30.0,
            flags: int = 0):
    """Sample the (first) animation stack into a dense Clip on `skeleton`
    (bones matched by name — clips usually live in their own FBX files)."""
    from lumixengine_tpu_torch.animation.animation import Clip

    stacks = doc.by_class.get("AnimationStack", [])
    layers = doc.by_class.get("AnimationLayer", [])
    if not stacks or not layers:
        raise ValueError("fbx: no animation stack")
    layer = layers[0]

    # models by name for bone matching
    models_by_name: Dict[str, FbxObject] = {}
    for m in doc.by_class.get("Model", []):
        models_by_name.setdefault(m.name, m)

    # curve nodes on our layer: model id → {property: {axis: (times, values)}}
    anim: Dict[int, Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]]] = {}
    t_max = 0.0
    for cn in doc.by_class.get("AnimationCurveNode", []):
        on_layer = any(p.id == layer.id for p in doc.connected_parents(cn.id))
        if not on_layer:
            continue
        for target, pname in doc.op_target(cn.id):
            if target.node.name != "Model":
                continue
            curves: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            for cv in doc.connected_children(cn.id, "AnimationCurve", prop="any"):
                axes = [pn for pid, pn in doc.parents.get(cv.id, []) if pid == cn.id]
                kt = cv.node.find("KeyTime")
                kv = cv.node.find("KeyValueFloat")
                if kt is None or kv is None or not axes:
                    continue
                times = np.asarray(kt.prop(0))
                vals = np.asarray(kv.prop(0))
                if len(times):
                    t_max = max(t_max, float(times[-1]) / FBX_TICKS_PER_SECOND)
                curves[axes[0]] = (times, vals)
            if curves:
                anim.setdefault(target.id, {})[pname] = curves

    # clip span: stack LocalStop if present, else last key
    p = stacks[0].props
    stop = p.get("LocalStop", [0])[0] or 0
    span = max(float(stop) / FBX_TICKS_PER_SECOND, t_max)
    if span <= 0:
        raise ValueError("fbx: empty animation span")
    frames = max(int(round(span * fps)) + 1, 2)
    ts = np.arange(frames, dtype=np.float64) / fps

    nb = skeleton.bone_count
    pos = np.zeros((frames, nb, 3), np.float32)
    rot = np.zeros((frames, nb, 4), np.float32)
    for i, bname in enumerate(skeleton.bone_names):
        mo = models_by_name.get(bname)
        if mo is None:  # bone absent in this file: bind pose
            pos[:, i] = skeleton.bind_pos[i]
            rot[:, i] = skeleton.bind_rot[i]
            continue
        chans = anim.get(mo.id, {})

        def sampled(prop_name: str, default: np.ndarray) -> np.ndarray:
            cs = chans.get(prop_name)
            out = np.tile(default[None, :], (frames, 1))
            if cs:
                for k, axis in enumerate(("d|X", "d|Y", "d|Z")):
                    if axis in cs:
                        out[:, k] = _sample_curve(*cs[axis], ts)
            return out

        t_def = _vec3(mo.props, "Lcl Translation")
        r_def = _vec3(mo.props, "Lcl Rotation")
        s_def = _vec3(mo.props, "Lcl Scaling", (1, 1, 1))
        tt = sampled("Lcl Translation", t_def)
        rr = sampled("Lcl Rotation", r_def)
        ss = sampled("Lcl Scaling", s_def)
        static = not chans and True
        if static:
            m = local_matrix(mo.props)
            pq = _mat_to_posquat(m, doc.scale)
            pos[:, i] = pq[0]
            rot[:, i] = pq[1]
            continue
        for f in range(frames):
            m = local_matrix(mo.props, t=tt[f], r=rr[f], s=ss[f])
            pos[f, i], rot[f, i] = _mat_to_posquat(m, doc.scale)
    return Clip(name=name, pos=pos, rot=rot, fps=fps, flags=flags)

"""Composite texture (.ltc) graphs (counterpart of
``lumixengine_tpu/importers/composite_texture.py``; ≙ reference
renderer/editor/composite_texture.cpp:1-3520 — a node-graph texture
compositor the AssetCompiler bakes to texture layers; the demo ships four
.ltc assets: terrain albedo/normal detail arrays, water height, particle
explosion).

Byte-compatible reader for the reference's binary format ('_LTC' magic,
node list with per-type payloads, pin-packed links), plus a vectorized
numpy evaluator for the node subset the shipped content and common graphs
use (output/input/color/constant/invert/grayscale/multiply/mix/merge/
split/set-alpha/flip/brightness/contrast/gamma/min/max/step/circle/
gradient-noise). The noise kernels replicate the reference's exact integer
hashes (ihash1D / multiHash2D) so baked pixels match bit-for-bit in f32.

Unknown node types fail loudly with the node name — never a silent wrong
texture."""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = 0x5F4C5443   # '_LTC'

NODE_TYPES = [
    "OUTPUT", "INPUT", "INVERT", "COLOR", "SPLIT", "MERGE", "FLIP", "GAMMA",
    "CONTRAST", "BRIGHTNESS", "GRAYSCALE", "MULTIPLY", "MIX", "GRADIENT",
    "VALUE_NOISE", "CONSTANT", "RESIZE", "CIRCLE", "CELLULAR_NOISE", "SPLAT",
    "GRADIENT_NOISE", "WAVE_NOISE", "CURVE", "SET_ALPHA", "CROP", "SHARPEN",
    "STATIC_SWITCH", "STEP", "SPLATTER", "GRADIENT_MAP", "TRANSLATE",
    "CIRCULAR_SPLATTER", "PIXEL_PROCESSOR", "PIXEL_COLOR", "PIXEL_X",
    "PIXEL_Y", "PIXEL_CTX_W", "PIXEL_CTX_H", "DIVIDE", "MIN", "MAX",
    "SQUARE", "TRIANGLE", "BLUR", "VBLUR", "CHECKERBOARD", "WARP", "TWIRL",
    "NORMALMAP",
]


@dataclass
class CNode:
    type: str
    id: int
    pos: Tuple[float, float]
    props: dict = field(default_factory=dict)


@dataclass
class CompositeGraph:
    nodes: List[CNode]
    links: List[Tuple[int, int, int, int]]   # (from_id, from_pin, to_id, to_pin)

    def node(self, nid: int) -> CNode:
        for n in self.nodes:
            if n.id == nid:
                return n
        raise KeyError(nid)

    def input_of(self, nid: int, pin: int) -> Optional[Tuple[CNode, int]]:
        for f_id, f_pin, t_id, t_pin in self.links:
            if t_id == nid and t_pin == pin:
                return self.node(f_id), f_pin
        return None


class _R:
    def __init__(self, b: bytes, o: int = 0):
        self.b, self.o = b, o

    def u32(self):
        v, = struct.unpack_from("<I", self.b, self.o)
        self.o += 4
        return v

    def i32(self):
        v, = struct.unpack_from("<i", self.b, self.o)
        self.o += 4
        return v

    def u16(self):
        v, = struct.unpack_from("<H", self.b, self.o)
        self.o += 2
        return v

    def f32(self, n=1):
        v = struct.unpack_from(f"<{n}f", self.b, self.o)
        self.o += 4 * n
        return v[0] if n == 1 else v

    def b8(self):
        v = self.b[self.o]
        self.o += 1
        return bool(v)

    def cstr(self):
        e = self.b.index(0, self.o)
        s = self.b[self.o:e].decode()
        self.o = e + 1
        return s


# per-type payload readers (field order = the node's serialize(); cite:
# composite_texture.cpp per-node serialize implementations)
_PAYLOAD = {
    "OUTPUT": lambda r: {"output_type": r.u32(), "layers": r.u32(),
                         "channels": r.u32()},
    "INPUT": lambda r: {"texture": r.cstr()},
    "INVERT": lambda r: {},
    "COLOR": lambda r: {"color": r.f32(4)},
    "SPLIT": lambda r: {},
    "MERGE": lambda r: {},
    "FLIP": lambda r: {"horizontal": r.b8()},
    "GAMMA": lambda r: {"gamma": r.f32()},
    "CONTRAST": lambda r: {"contrast": r.f32()},
    "BRIGHTNESS": lambda r: {"brightness": r.f32()},
    "GRAYSCALE": lambda r: {},
    "MULTIPLY": lambda r: {},
    "MIX": lambda r: {"alpha": r.f32()},
    "CONSTANT": lambda r: {"value": r.f32()},
    "CIRCLE": lambda r: {"w": r.u32(), "h": r.u32(), "power": r.f32()},
    "GRADIENT_NOISE": lambda r: {"w": r.u32(), "h": r.u32(),
                                 "scale": r.f32()},
    "SET_ALPHA": lambda r: {},
    "RESIZE": lambda r: {"rtype": r.i32(), "size": (r.u32(), r.u32()),
                         "scale": (r.f32(), r.f32())},
    "STEP": lambda r: {"value": r.f32()},
    "MIN": lambda r: {},
    "MAX": lambda r: {},
    "DIVIDE": lambda r: {},
}


def parse_ltc(blob: bytes) -> CompositeGraph:
    r = _R(blob)
    magic, version = r.u32(), r.u32()
    if magic != MAGIC:
        raise ValueError("not a composite texture ('_LTC' magic missing)")
    if version > 0:
        raise ValueError(f"composite texture version {version} unsupported")
    r.u32()                       # node id generator
    n = r.i32()
    nodes = []
    for _ in range(n):
        t = r.u32()
        name = NODE_TYPES[t] if t < len(NODE_TYPES) else f"#{t}"
        nid = r.u16()
        pos = (r.f32(), r.f32())
        if name not in _PAYLOAD:
            raise ValueError(f"composite node {name!r} not supported by "
                             "this reader (payload layout unknown)")
        nodes.append(CNode(type=name, id=nid, pos=pos,
                           props=_PAYLOAD[name](r)))
    nl = r.i32()
    links = []
    for _ in range(nl):
        f, t = r.u32(), r.u32()
        links.append((f & 0xFFFF, f >> 16, t & 0xFFFF, t >> 16))
    return CompositeGraph(nodes=nodes, links=links)


# -- reference noise kernels (exact integer hashes) ---------------------------

def _ihash1d(q: np.ndarray) -> np.ndarray:
    q = (q * np.uint32(747796405) + np.uint32(2891336453)).astype(np.uint32)
    q = (q << np.uint32(13)) ^ q
    return (q * (q * q * np.uint32(15731) + np.uint32(789221))
            + np.uint32(1376312589)).astype(np.uint32)


def gradient_noise(w: int, h: int, scale: float) -> np.ndarray:
    """[h, w] f32 in [0,1] — bit-replicates GradientNoiseNode::gradientNoise
    (composite_texture.cpp:1039-1079: Hugo Elias integer hash gradients +
    quintic interpolation, tiled by `scale`)."""
    u = (np.arange(w, dtype=np.float32) / np.float32(w))[None, :]
    v = (np.arange(h, dtype=np.float32) / np.float32(h))[:, None]
    px = (u * np.float32(scale)) + np.zeros((h, w), np.float32)
    py = (v * np.float32(scale)) + np.zeros((h, w), np.float32)
    ix, iy = np.floor(px), np.floor(py)
    fx, fy = px - ix, py - iy
    # cell corners (i.xy, i.zw) = (ix, iy), (ix+1, iy+1), wrapped by scale
    cx0 = np.mod(ix, scale).astype(np.int64).astype(np.uint32)
    cy0 = np.mod(iy, scale).astype(np.int64).astype(np.uint32)
    cx1 = np.mod(ix + 1, scale).astype(np.int64).astype(np.uint32)
    cy1 = np.mod(iy + 1, scale).astype(np.int64).astype(np.uint32)
    # multiHash2D over (x0,y0) (x1,y0) (x0,y1) (x1,y1):
    # hash0 = ihash1D(ihash1D(i.xzxz) + i.yyww)
    h00 = _ihash1d(_ihash1d(cx0) + cy0)
    h10 = _ihash1d(_ihash1d(cx1) + cy0)
    h01 = _ihash1d(_ihash1d(cx0) + cy1)
    h11 = _ihash1d(_ihash1d(cx1) + cy1)
    inv = np.float32(1.0 / 0xFFFFFFFF)

    def grads(hv, dx, dy):
        gx = (hv.astype(np.float32) * inv) * 2.0 - 1.0
        gy = (_ihash1d(hv ^ np.uint32(1933247)).astype(np.float32)
              * inv) * 2.0 - 1.0
        return gx * dx + gy * dy

    g00 = grads(h00, fx, fy)
    g10 = grads(h10, fx - 1.0, fy)
    g01 = grads(h01, fx, fy - 1.0)
    g11 = grads(h11, fx - 1.0, fy - 1.0)
    ux = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    uy = fy * fy * fy * (fy * (fy * 6.0 - 15.0) + 10.0)
    ga = g00 + ux * (g10 - g00)
    gb = g01 + ux * (g11 - g01)
    out = np.float32(1.4142135623730950) * (ga + uy * (gb - ga))
    return (out * 0.5 + 0.5).astype(np.float32)


def circle(w: int, h: int, power: float) -> np.ndarray:
    x = np.arange(w, dtype=np.float32) / np.float32(w - 1) - 0.5
    y = np.arange(h, dtype=np.float32) / np.float32(h - 1) - 0.5
    d = np.sqrt(x[None, :] ** 2 + y[:, None] ** 2) * 2.0
    return np.power(d, np.float32(power)).astype(np.float32)


# -- evaluation ---------------------------------------------------------------


def _to4(img: np.ndarray) -> np.ndarray:
    """[h, w, c] → [h, w, 4] (grey broadcast, alpha 1 — the reference's
    Image::sample channel-fill rules)."""
    h, w, c = img.shape
    if c == 4:
        return img
    out = np.ones((h, w, 4), np.float32)
    if c == 1:
        out[..., 0] = out[..., 1] = out[..., 2] = img[..., 0]
    else:
        out[..., :c] = img
    return out


class CompositeTextureBaker:
    """Evaluate a graph → list of [h, w, 4] f32 layers (OUTPUT array mode =
    one layer per input pin; ≙ CompositeTexture::generate)."""

    def __init__(self, graph: CompositeGraph, load_texture=None):
        self.g = graph
        self.load_texture = load_texture   # path -> [h, w, c] f32 0..1

    def bake(self) -> List[np.ndarray]:
        outs = [n for n in self.g.nodes if n.type == "OUTPUT"]
        if not outs:
            raise ValueError("composite texture has no OUTPUT node")
        out = outs[0]
        layers = []
        n_pins = max(int(out.props.get("layers", 1)), 1)
        for pin in range(n_pins):
            src = self.g.input_of(out.id, pin)
            if src is None:
                continue
            layers.append(_to4(self._eval(*src)))
        return layers

    def _eval(self, node: CNode, pin: int) -> np.ndarray:
        t, p = node.type, node.props

        def inp(i, required=True):
            src = self.g.input_of(node.id, i)
            if src is None:
                if required:
                    raise ValueError(f"{t} node {node.id}: input {i} unlinked")
                return None
            return self._eval(*src)

        if t == "INPUT":
            if self.load_texture is None:
                raise ValueError("INPUT node needs a texture loader")
            img = np.asarray(self.load_texture(p["texture"]), np.float32)
            if img.ndim == 2:
                img = img[..., None]
            return img
        if t == "COLOR":
            return np.broadcast_to(
                np.asarray(p["color"], np.float32), (4, 4, 4)).copy()
        if t == "CONSTANT":
            return np.full((4, 4, 1), p["value"], np.float32)
        if t == "CIRCLE":
            return circle(p["w"], p["h"], p["power"])[..., None]
        if t == "GRADIENT_NOISE":
            return gradient_noise(p["w"], p["h"], p["scale"])[..., None]
        if t == "INVERT":
            a = inp(0)
            if a.shape[-1] < 3:
                return (1.0 - a).astype(np.float32)
            out = a.copy()
            out[..., :3] = 1.0 - out[..., :3]
            return out
        if t == "GRAYSCALE":
            a = _to4(inp(0))
            g = a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114
            out = a.copy()
            out[..., 0] = out[..., 1] = out[..., 2] = g
            return out
        if t in ("MULTIPLY", "MIN", "MAX", "DIVIDE"):
            a, b = _to4(inp(0)), _to4(inp(1))
            b = _resize_like(b, a)
            if t == "MULTIPLY":
                return a * b
            if t == "DIVIDE":
                return a / np.maximum(b, 1e-6)
            return np.minimum(a, b) if t == "MIN" else np.maximum(a, b)
        if t == "MIX":
            a, b = _to4(inp(0)), _to4(inp(1))
            b = _resize_like(b, a)
            al = np.float32(p["alpha"])
            return a * (1.0 - al) + b * al
        if t == "BRIGHTNESS":
            return np.clip(_to4(inp(0)) + np.float32(p["brightness"]),
                           0.0, None)
        if t == "CONTRAST":
            a = _to4(inp(0))
            c = np.float32(p["contrast"])
            f = (259.0 * (c + 255.0)) / (255.0 * (259.0 - c))
            return np.clip((a - 0.5) * f + 0.5, 0.0, 1.0)
        if t == "GAMMA":
            return np.power(np.clip(_to4(inp(0)), 0.0, None),
                            np.float32(1.0 / max(p["gamma"], 1e-6)))
        if t == "STEP":
            return (inp(0) > np.float32(p["value"])).astype(np.float32)
        if t == "FLIP":
            a = inp(0)
            return a[:, ::-1] if p["horizontal"] else a[::-1]
        if t == "SET_ALPHA":
            a = _to4(inp(0))
            al = _to4(inp(1))
            out = a.copy()
            out[..., 3] = _resize_like(al, a)[..., 0]
            return out
        if t == "RESIZE":
            a = inp(0)
            if p["rtype"] == 0:                      # PIXELS
                w, h = p["size"]
            else:                                    # PERCENT
                h = int(a.shape[0] * p["scale"][1] * 0.01 + 0.5)
                w = int(a.shape[1] * p["scale"][0] * 0.01 + 0.5)
            return _bilinear(a, int(h), int(w))
        if t == "SPLIT":
            a = _to4(inp(0))
            return a[..., pin:pin + 1]
        if t == "MERGE":
            chans = []
            for i in range(4):
                c = inp(i, required=i < 3)
                chans.append(c[..., 0] if c is not None
                             else np.ones(chans[0].shape[:2], np.float32))
            return np.stack(chans, axis=-1)
        raise ValueError(f"composite node {t!r} evaluation not implemented")


def _bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resample to [h, w, c] (≙ ResizeNode's normalized sample)."""
    ih, iw = img.shape[:2]
    y = np.linspace(0, ih - 1, h, dtype=np.float32)
    x = np.linspace(0, iw - 1, w, dtype=np.float32)
    y0 = np.clip(np.floor(y).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    fy = (y - y0)[:, None, None]
    fx = (x - x0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx) + img[y0][:, x1] * (1 - fy) * fx
    b = img[y1][:, x0] * fy * (1 - fx) + img[y1][:, x1] * fy * fx
    return (a + b).astype(np.float32)


def _resize_like(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Nearest resize of b to a's spatial shape (the reference samples the
    smaller input with normalized coordinates)."""
    if b.shape[:2] == a.shape[:2]:
        return b
    h, w = a.shape[:2]
    yi = (np.arange(h) * b.shape[0] // h).clip(0, b.shape[0] - 1)
    xi = (np.arange(w) * b.shape[1] // w).clip(0, b.shape[1] - 1)
    return b[yi][:, xi]


def register(compiler, load_texture=None) -> None:
    """AssetCompiler plugin: .ltc → {"graph": ..., "layers": [u8 images]}
    (≙ CompositeTextureEditor's compile path writing baked texture data)."""
    def _fn(path, src):
        g = parse_ltc(src)
        baker = CompositeTextureBaker(g, load_texture=load_texture)
        layers = baker.bake()
        return {"graph": g,
                "layers": [np.clip(l * 255.0, 0, 255).astype(np.uint8)
                           for l in layers]}

    compiler.add_plugin("ltc", _fn)

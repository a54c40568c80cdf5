"""Texture loading (counterpart of ``lumixengine_tpu/renderer/texture.py``).

Host side: TGA (uncompressed and RLE), RAW u16 heightmaps and PNG, each
parsed here with the standard library (no image package), other formats
through PIL where it is installed; a box-filtered mip chain. Device side:
a bilinear sampler over tensors.
"""
from __future__ import annotations

import io
import struct as pystruct
import zlib
from typing import List

import numpy as np
import torch

from lumixengine_tpu_torch.renderer.material import Texture


def load_tga(blob: bytes, name: str = "tga") -> Texture:
    """TGA types 2/3 (uncompressed BGR(A)/gray) and 10/11 (RLE)."""
    hdr = blob[:18]
    id_len, img_type = hdr[0], hdr[2]
    w = pystruct.unpack_from("<H", hdr, 12)[0]
    h = pystruct.unpack_from("<H", hdr, 14)[0]
    bpp = hdr[16] // 8
    top_down = bool(hdr[17] & 0x20)
    off = 18 + id_len
    n = w * h
    if img_type in (2, 3):
        px = np.frombuffer(blob, np.uint8, count=n * bpp, offset=off).reshape(h, w, bpp)
    elif img_type in (10, 11):
        out = np.empty((n, bpp), np.uint8)
        src = np.frombuffer(blob, np.uint8, offset=off)
        i = j = 0
        while j < n:
            packet = int(src[i])
            count = (packet & 0x7F) + 1
            if packet & 0x80:          # run
                out[j:j + count] = src[i + 1:i + 1 + bpp]
                i += 1 + bpp
            else:                      # literal
                out[j:j + count] = src[i + 1:i + 1 + count * bpp].reshape(count, bpp)
                i += 1 + count * bpp
            j += count
        px = out.reshape(h, w, bpp)
    else:
        raise ValueError(f"tga: unsupported image type {img_type}")
    if bpp not in (1, 3, 4):
        raise ValueError(f"tga: unsupported depth {bpp * 8} bpp")
    if not top_down:
        px = px[::-1]
    if bpp == 1:
        rgba = np.repeat(px, 4, axis=-1)
        rgba[..., 3] = 255
    elif bpp == 3:
        rgba = np.concatenate([px[..., 2:3], px[..., 1:2], px[..., 0:1],
                               np.full((h, w, 1), 255, np.uint8)], axis=-1)
    else:
        rgba = np.concatenate([px[..., 2:3], px[..., 1:2], px[..., 0:1], px[..., 3:4]], axis=-1)
    return Texture(name=name, data=np.ascontiguousarray(rgba))


def load_raw(blob: bytes, name: str = "raw") -> Texture:
    """RAW u16 grayscale (square heightmaps)."""
    vals = np.frombuffer(blob, np.uint16)
    side = int(round(len(vals) ** 0.5))
    if side * side != len(vals):
        raise ValueError("raw: not square")
    data = vals.reshape(side, side).astype(np.float32) / 65535.0
    return Texture(name=name, data=data[..., None], srgb=False)


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # color type → samples a pixel
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, pos: int = 0) -> np.ndarray:
    """Undo the five PNG scanline filters of `h` lines of `stride` bytes
    from `raw[pos:]` → uint8 [h, stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw, np.uint8, count=stride, offset=pos + 1).astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ft == 1:
                    cur[x] = (cur[x] + a) & 0xFF
                elif ft == 3:
                    cur[x] = (cur[x] + ((a + prev[x]) >> 1)) & 0xFF
                elif ft == 4:
                    b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[x] = (cur[x] + pred) & 0xFF
                else:
                    raise ValueError(f"png: bad filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def _samples(raw: bytes, pos: int, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    """One (sub-)image's filtered lines from `raw[pos:]` → its samples
    [h, w, ch] (uint16 at depth 16, else uint8 holding 0 .. 2^depth - 1)."""
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(raw, h, stride, max(1, ch * depth // 8), pos)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // depth, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
    return vals[:, :w * ch].reshape(h, w, ch)


def decode_png(blob: bytes) -> np.ndarray:
    """Any PNG (gray, gray+alpha, RGB, RGBA and palette at every legal bit
    depth, Adam7-interlaced or not, tRNS transparency) → uint8 RGBA
    [H, W, 4], equal to PIL's ``Image.open(...).convert("RGBA")``: 1-, 2-
    and 4-bit gray scaled to 0 .. 255; 16-bit gray clipped to 255 (PIL's
    I;16) with its tRNS ignored; 16-bit gray+alpha, RGB and RGBA by their
    high bytes, a 16-bit RGB tRNS compared with the high bytes; palette
    alpha from tRNS (255 past its end)."""
    if blob[:8] != _PNG_MAGIC:
        raise ValueError("png: bad signature")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos < len(blob):
        n, kind = pystruct.unpack_from(">I4s", blob, pos)
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = pystruct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    legal = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
    if depth not in legal.get(ctype, ()) or interlace not in (0, 1) \
            or (ctype == 3 and plte is None):
        raise ValueError(f"png: unsupported (depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for r0, c0, dr, dc in _ADAM7:
            ph, pw = (h - r0 + dr - 1) // dr, (w - c0 + dc - 1) // dc
            if ph <= 0 or pw <= 0:
                continue
            px[r0::dr, c0::dc] = _samples(raw, pos, ph, pw, ch, depth)
            pos += ph * (1 + (pw * ch * depth + 7) // 8)
    else:
        px = _samples(raw, 0, h, w, ch, depth)
    opaque = np.full((h, w, 1), 255, np.uint8)
    if ctype == 3:
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        idx = px[..., 0]
        return np.concatenate([pal[idx], alpha[idx][..., None]], -1)
    if ctype == 0:
        if depth == 16:
            return np.concatenate([np.repeat(np.minimum(px, 255).astype(np.uint8), 3, -1),
                                   opaque], -1)
        g = (px.astype(np.int32) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        if trns is not None:
            key = pystruct.unpack(">H", trns[:2])[0]
            key = (255 if key else 0) if depth == 1 else key
            opaque = np.where(g == key, 0, 255).astype(np.uint8)
        return np.concatenate([np.repeat(g, 3, -1), opaque], -1)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ch == 2:
        return np.concatenate([np.repeat(px[..., :1], 3, -1), px[..., 1:]], -1)
    if ch == 3:
        if trns is not None:
            key = np.asarray(pystruct.unpack(">HHH", trns[:6]))
            opaque = np.where((px == key).all(-1, keepdims=True), 0, 255).astype(np.uint8)
        return np.concatenate([px, opaque], -1)
    return np.ascontiguousarray(px)


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] → PNG bytes (filter 0 rows, zlib level 6)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (pystruct.pack(">I", len(body)) + kind + body
                + pystruct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_MAGIC + chunk(b"IHDR", pystruct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
    return path


def load_image(blob: bytes, name: str = "img") -> Texture:
    """PNG here; JPG/DDS through PIL, which must then be installed."""
    if blob[:8] == _PNG_MAGIC:
        return Texture(name=name, data=decode_png(blob))
    from PIL import Image

    return Texture(name=name, data=np.asarray(Image.open(io.BytesIO(blob)).convert("RGBA"),
                                              np.uint8))


def load_texture(name: str, blob: bytes) -> Texture:
    low = name.lower()
    if low.endswith(".tga"):
        return load_tga(blob, name)
    if low.endswith(".raw"):
        return load_raw(blob, name)
    return load_image(blob, name)


def build_mips(data: np.ndarray, max_levels: int = 16) -> List[np.ndarray]:
    """Box-filtered mip chain down to 1x1."""
    mips = [data]
    cur = data.astype(np.float32)
    while (cur.shape[0] > 1 or cur.shape[1] > 1) and len(mips) < max_levels:
        h, w = cur.shape[:2]
        a = cur[: (h // 2) * 2 or 1, : (w // 2) * 2 or 1]
        if h >= 2:
            a = (a[0::2] + a[1::2]) * 0.5
        if w >= 2:
            a = (a[:, 0::2] + a[:, 1::2]) * 0.5
        cur = a
        mips.append(cur.astype(np.float32) if data.dtype == np.float32
                    else np.clip(cur + 0.5, 0, 255).astype(np.uint8))
    return mips


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor, wrap: str = "repeat"):
    """Bilinear sample: tex [H, W, C], u/v [...] in [0, 1] → [..., C].
    "repeat" takes texel centres with modulo neighbours (the seam blends
    texel W-1 with texel 0); otherwise coordinates clamp to the edge."""
    h, w = tex.shape[0], tex.shape[1]
    if wrap == "repeat":
        x = torch.remainder(u, 1.0) * w - 0.5
        y = torch.remainder(v, 1.0) * h - 0.5
        x0f, y0f = torch.floor(x), torch.floor(y)
        x0 = torch.remainder(x0f.to(torch.int64), w)
        y0 = torch.remainder(y0f.to(torch.int64), h)
        x1, y1 = torch.remainder(x0 + 1, w), torch.remainder(y0 + 1, h)
        fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    else:
        x = torch.clamp(u, 0.0, 1.0) * (w - 1)
        y = torch.clamp(v, 0.0, 1.0) * (h - 1)
        x0 = torch.floor(x).to(torch.int64)
        y0 = torch.floor(y).to(torch.int64)
        x1, y1 = torch.clamp_max(x0 + 1, w - 1), torch.clamp_max(y0 + 1, h - 1)
        fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    tf = tex.to(torch.float32)
    c00, c10, c01, c11 = tf[y0, x0], tf[y0, x1], tf[y1, x0], tf[y1, x1]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def register_texture_plugins(compiler, registry) -> None:
    """Hook the loaders into an asset compiler: .tga/.raw/.png/.dds/.jpg →
    a Texture added to the MaterialRegistry."""
    def compile_tex(path: str, blob: bytes):
        tex = load_texture(path, blob)
        registry.add_texture(tex)
        return tex

    for ext in ("tga", "raw", "png", "dds", "jpg"):
        compiler.add_plugin(ext, compile_tex)

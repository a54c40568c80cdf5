"""Stable hashing (≙ reference core/hash.{h,cpp}: xxhash-based RuntimeHash,
64-bit StableHash, BoneNameHash, FilePathHash).

Self-contained FNV-1a/xx-style mixes — stable across runs and platforms (the
property the reference needs them for: content-addressed asset caches and
serialized name hashes).
"""
from __future__ import annotations

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


try:
    import xxhash as _xxhash
except ImportError:  # pragma: no cover
    _xxhash = None


def stable_hash64(data) -> int:
    """64-bit stable content hash — BIT-EXACT with the reference's StableHash
    (hash.cpp: XXH3_64bits), so serialized name hashes in shipped .unv content
    (e.g. Lua script property hashes) resolve against live names."""
    if isinstance(data, str):
        data = data.encode()
    if _xxhash is not None:
        return _xxhash.xxh3_64_intdigest(data)
    # fallback mix (stable, NOT reference-compatible)
    h = _FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & _MASK64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _MASK64
    h ^= h >> 33
    return h


def stable_hash32(data) -> int:
    """32-bit runtime hash (≙ RuntimeHash)."""
    return stable_hash64(data) & _MASK32


def bone_name_hash(name: str) -> int:
    """≙ BoneNameHash = StableHash of the bone name (hash.h:76) — bit-exact so
    serialized bone references in .unv content resolve against FBX bone names."""
    return stable_hash64(name)


def file_path_hash(path: str) -> int:
    """≙ FilePathHash — hashes the normalized path."""
    norm = path.replace("\\", "/").lower()
    return stable_hash64(norm)

"""World serialization: the save system (counterpart of
``lumixengine_tpu/engine/serialize.py``; ≙ reference engine/world.cpp
serialize/deserialize and the engine's prefab instantiation).

A world blob is a versioned header, the world's core arrays and one versioned
component list per module, packed as an npz with a JSON manifest and
compressed with the LZ4 block codec of the shared ``csrc/lz4_codec.cpp``
(``utils/native.py``) when it builds, zlib otherwise; the header names the
codec. The layout is the reference's byte for byte, so a blob written by
either package loads in the other.

Prefabs (≙ engine/prefab.h): a prefab is the same blob restricted to an
entity subset; instantiating it deserializes through an ``EntityMap`` that
rebases the ids onto fresh entities.

Checkpoints (``save_checkpoint``/``load_checkpoint``): a device state's
tensors as npz leaves under the ``LXTPUC`` header, in the leaf order
``jax.tree_util.tree_flatten`` gives the reference's ``WorldState`` (fields
in declaration order, dict keys sorted; ``bridge.state_to_numpy(...,
sort_keys=True)``), so a checkpoint written by either package loads in the
other. The manifest's ``treedef`` is a description only: neither loader
reads it.
"""
from __future__ import annotations

import io
import json
import struct as pystruct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from lumixengine_tpu_torch.engine.plugin import IModule

MAGIC = b"LXTPUW"
CHECKPOINT_MAGIC = b"LXTPUC"
WORLD_VERSION = 1  # bump and add a migration step on a format change


class EntityMap:
    """Old entity id → new id (≙ world.h EntityMap)."""

    def __init__(self):
        self.map: Dict[int, int] = {}

    def get(self, old: int) -> int:
        if old < 0:
            return -1
        return self.map.get(old, -1)

    def set(self, old: int, new: int) -> None:
        self.map[old] = new


# -- compression -------------------------------------------------------------------


def _compress(data: bytes) -> tuple:
    """(codec, bytes): ``lz4n`` when the native codec builds, else ``zlib``
    (the reference's rule: the codec is named in the header)."""
    from lumixengine_tpu_torch.utils import native

    if native.lz4_available():
        return b"lz4n", native.lz4_compress(data)
    return b"zlib", zlib.compress(data, 6)


def _decompress(codec: bytes, data: bytes, raw_size: int) -> bytes:
    if codec == b"lz4n":
        from lumixengine_tpu_torch.utils import native

        return native.lz4_decompress(data, raw_size)
    return zlib.decompress(data)


# -- payload encoding --------------------------------------------------------------


def _pack_payload(manifest: dict, arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    arr_bytes = buf.getvalue()
    mani = json.dumps(manifest).encode()
    return pystruct.pack("<II", len(mani), len(arr_bytes)) + mani + arr_bytes


def _unpack_payload(data: bytes):
    mlen, alen = pystruct.unpack_from("<II", data, 0)
    off = 8
    manifest = json.loads(data[off:off + mlen].decode())
    arrays = dict(np.load(io.BytesIO(data[off + mlen:off + mlen + alen]), allow_pickle=False))
    return manifest, arrays


def _frame(magic: bytes, payload: bytes) -> bytes:
    codec, compressed = _compress(payload)
    return (magic + pystruct.pack("<I", WORLD_VERSION) + codec
            + pystruct.pack("<II", len(payload), len(compressed)) + compressed)


def blob_codec(blob: bytes) -> str:
    """The codec a world blob or checkpoint names in its header."""
    return blob[10:14].decode()


# -- module components ---------------------------------------------------------------


def _dump_module_components(module) -> List[dict]:
    """A module's components: its ``serialize_components()`` where it has
    one, else the generic dump of its COMPONENT_STORES."""
    from lumixengine_tpu_torch.utils.store import dump_stores

    if hasattr(module, "serialize_components"):
        return module.serialize_components()
    return dump_stores(module)


_ENTITY_PROPS = {"body_a", "body_b", "ent_a", "ent_b", "target_entity", "parent_entity"}


def _restore_component(world, comp: dict, emap: EntityMap) -> None:
    e = emap.get(comp["entity"])
    if e < 0:
        return
    props = dict(comp["props"])
    ctype = comp["type"]
    for k in list(props.keys()):
        if k in _ENTITY_PROPS:
            props[k] = emap.get(int(props[k]))
    if ctype == "distance_joint":
        props = {"body_a": props["ent_a"], "body_b": props["ent_b"], "length": props["length"]}
    world.create_component(e, ctype, **props)


# -- world save / load ---------------------------------------------------------------


def serialize_world(world, entities: Optional[Sequence[int]] = None) -> bytes:
    """The whole world as a blob, or an entity subset as a prefab fragment
    (parents outside the subset become roots)."""
    subset = None if entities is None else set(int(e) for e in entities)
    ids = [e for e in range(world.capacity)
           if world.alive[e] and (subset is None or e in subset)]
    idx = np.asarray(ids, np.int32)
    parent = world.parent[idx]
    if subset is not None:
        parent = np.where(np.isin(parent, idx), parent, -1).astype(np.int32)
    arrays = {
        "ids": idx,
        "parent": parent,
        "local_pos": world.local_pos[idx],
        "local_rot": world.local_rot[idx],
        "local_scale": world.local_scale[idx],
        "partition_of": world.partition_of[idx],
    }
    modules = {}
    for name, m in world.modules.items():
        comps = _dump_module_components(m)
        if subset is not None:
            comps = [c for c in comps if c["entity"] in subset]
        modules[name] = {"version": getattr(m, "VERSION", 0), "components": comps}
    id_set = set(ids)
    manifest = {
        "version": WORLD_VERSION,
        "capacity": world.capacity,
        "names": {str(e): n for e, n in world.names.items() if int(e) in id_set},
        "partitions": world.partitions,
        "modules": modules,
        "extra": {name: m.serialize() for name, m in world.modules.items()
                  if type(m).serialize is not IModule.serialize},
    }
    return _frame(MAGIC, _pack_payload(manifest, arrays))


def _parse(blob: bytes):
    if blob[:6] != MAGIC:
        raise ValueError("not a lumixengine_tpu world blob")
    version = pystruct.unpack_from("<I", blob, 6)[0]
    if version > WORLD_VERSION:
        raise ValueError(f"world version {version} is newer than supported {WORLD_VERSION}")
    raw_size, comp_size = pystruct.unpack_from("<II", blob, 14)
    payload = _decompress(blob[10:14], blob[22:22 + comp_size], raw_size)
    manifest, arrays = _unpack_payload(payload)
    if manifest["version"] > WORLD_VERSION:
        raise ValueError(f"world version {manifest['version']} is newer than supported "
                         f"{WORLD_VERSION}")
    return manifest, arrays


def deserialize_into(world, blob: bytes, emap: Optional[EntityMap] = None,
                     keep_ids: bool = False) -> List[int]:
    """Instantiate a serialized fragment into `world`; returns the new
    entity ids. ``keep_ids`` restores the original ids (a full world loaded
    into an empty one)."""
    manifest, arrays = _parse(blob)
    emap = emap or EntityMap()
    ids = arrays["ids"]
    created = []
    for i, old in enumerate(ids):
        old = int(old)
        if keep_ids:
            if world.alive[old]:
                raise ValueError(f"entity id {old} already in use")
            world._free.remove(old)
            world.alive[old] = True
            world._count += 1
            new = old
        else:
            new = world.create_entity()
        world.local_pos[new] = arrays["local_pos"][i]
        world.local_rot[new] = arrays["local_rot"][i]
        world.local_scale[new] = arrays["local_scale"][i]
        world.partition_of[new] = arrays["partition_of"][i]
        emap.set(old, new)
        created.append(new)
    for i, old in enumerate(ids):
        p_old = int(arrays["parent"][i])
        if p_old >= 0:
            world.parent[emap.get(int(old))] = emap.get(p_old)
    world._levels_dirty = True
    for old_str, name in manifest["names"].items():
        new = emap.get(int(old_str))
        if new >= 0:
            world.names[new] = name
    if keep_ids:
        world.partitions = list(manifest["partitions"])
    for mname, mblob in manifest["modules"].items():
        if mname not in world.modules:
            continue  # the system is absent: its components are skipped, as in the reference
        for comp in mblob["components"]:
            _restore_component(world, comp, emap)
    for mname, extra in manifest.get("extra", {}).items():
        if mname in world.modules:
            world.modules[mname].deserialize(extra, emap)
    return created


def load_world(engine, blob: bytes, capacity: Optional[int] = None):
    """A fresh world from a full blob (≙ the runner's loadWorld →
    World::deserialize)."""
    manifest, _ = _parse(blob)
    world = engine.create_world(capacity=capacity or manifest["capacity"])
    deserialize_into(world, blob, keep_ids=True)
    return world


# -- prefabs -------------------------------------------------------------------------


def make_prefab(world, root_entities: Sequence[int]) -> bytes:
    """The root entities and all their descendants as a prefab blob."""
    all_ids = set()
    frontier = [int(e) for e in root_entities]
    while frontier:
        e = frontier.pop()
        if e in all_ids:
            continue
        all_ids.add(e)
        frontier.extend(world.children_of(e))
    return serialize_world(world, entities=sorted(all_ids))


def instantiate_prefab(world, prefab: bytes, position=None, rotation=None) -> List[int]:
    """≙ engine.cpp instantiatePrefab: deserialize with a remap, then move
    the spawned roots to the given pose."""
    created = deserialize_into(world, prefab)
    if position is not None or rotation is not None:
        for e in created:
            if world.get_parent(e) == -1:
                world.set_local_transform(e, position=position, rotation=rotation)
    return created


# -- device-state checkpoints ----------------------------------------------------------


def save_checkpoint(state, path: str) -> None:
    """A WorldState (one world or a batch [W, ...]) to disk: its tensors as
    npz leaves in the reference's leaf order, for an exact resume."""
    from lumixengine_tpu_torch import bridge

    leaves = list(bridge.state_to_numpy(state, sort_keys=True).items())
    arrays = {f"leaf_{i}": x for i, (_, x) in enumerate(leaves)}
    manifest = {"version": WORLD_VERSION, "n_leaves": len(leaves),
                "treedef": "lumixengine_tpu_torch WorldState leaves: "
                           + ",".join(name for name, _ in leaves)}
    with open(path, "wb") as f:
        f.write(_frame(CHECKPOINT_MAGIC, _pack_payload(manifest, arrays)))


def load_checkpoint(path: str, like):
    """A checkpoint restored into the structure of `like` (a template state
    from World.device_state on the device to load onto; the shapes must
    match)."""
    from lumixengine_tpu_torch import bridge

    with open(path, "rb") as f:
        blob = f.read()
    if blob[:6] != CHECKPOINT_MAGIC:
        raise ValueError("not a lumixengine_tpu checkpoint")
    raw_size, comp_size = pystruct.unpack_from("<II", blob, 14)
    payload = _decompress(blob[10:14], blob[22:22 + comp_size], raw_size)
    manifest, arrays = _unpack_payload(payload)
    template = bridge.state_to_numpy(like, sort_keys=True)
    if manifest["n_leaves"] != len(template):
        raise ValueError("checkpoint structure mismatch")
    tree = {}
    for i, (name, tmpl) in enumerate(template.items()):
        arr = arrays[f"leaf_{i}"]
        if tuple(tmpl.shape) != tuple(arr.shape) or tmpl.dtype != arr.dtype:
            raise ValueError(f"leaf {i} ({name}) mismatch: {arr.dtype} {arr.shape} vs "
                             f"{tmpl.dtype} {tmpl.shape}")
        tree[name] = arr
    return bridge.state_from_numpy(tree, like.frame.device)

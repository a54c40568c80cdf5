"""Animation controller (`.act`) importer (counterpart of
``lumixengine_tpu/importers/act.py``).

Layout (clean-room from LumixEngine src/animation/controller.cpp:81-140
serialize/deserialize plus byte-level analysis of the shipped
demo/models/ybot/ybot.act, which is an OLDER version (header version 6) than
the snapshot's enum knows):

  u32 magic '_LAC' | u32 version | u32 id_counter | cstr skeleton_path |
  u32 input_count  | input_count × { u32 Value::Type, char name[32] } |
  u32 slot_count   | slot_count × cstr slot_name |
  u32 entry_count  | entry_count × { u32 slot, u32 set, cstr animation_path } |
  <node graph blob>

The node-graph blob is the editor-era tree serialization whose reader is not
present in the snapshot source (the snapshot's deserialize rejects version 6),
so it cannot be decoded faithfully. Everything BEFORE it — skeleton, typed
inputs, slot names, slot→clip mapping — parses exactly, and those are the
data that matter: we rebuild a semantically equivalent locomotion graph from
the slot inventory (direction/gait/stance naming is the mixamo-style
convention the demo uses): Blend2D over (speed_x, speed_y) per stance,
stance Select on top. The report marks these controllers as `reconstructed`.
"""
from __future__ import annotations

import re
import struct
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"CAL_"  # '_LAC' little-endian on disk

VALUE_TYPES = {0: "float", 1: "i32", 2: "vec3", 3: "bool"}


def parse_act(data: bytes) -> Dict[str, Any]:
    if data[:4] != MAGIC:
        raise ValueError("act: bad magic")
    o = 4
    version = struct.unpack_from("<I", data, o)[0]
    o += 4
    id_counter = struct.unpack_from("<I", data, o)[0]
    o += 4
    end = data.index(b"\0", o)
    skeleton = data[o:end].decode("utf-8", "replace")
    o = end + 1
    n_inputs = struct.unpack_from("<I", data, o)[0]
    o += 4
    inputs: List[Tuple[str, str]] = []
    raw_inputs: List[bytes] = []     # exact 36-byte records: a C char[32]
    for _ in range(n_inputs):        # buffer can carry garbage after the \0,
        raw_inputs.append(data[o:o + 36])   # kept for byte-exact re-export
        t = struct.unpack_from("<I", data, o)[0]
        name = data[o + 4:o + 36].split(b"\0")[0].decode("utf-8", "replace")
        inputs.append((VALUE_TYPES.get(t, str(t)), name))
        o += 36
    n_slots = struct.unpack_from("<I", data, o)[0]
    o += 4
    slots: List[str] = []
    for _ in range(n_slots):
        end = data.index(b"\0", o)
        slots.append(data[o:end].decode("utf-8", "replace"))
        o = end + 1
    n_entries = struct.unpack_from("<I", data, o)[0]
    o += 4
    entries: List[Dict[str, Any]] = []
    for _ in range(n_entries):
        slot, set_ = struct.unpack_from("<II", data, o)
        o += 8
        end = data.index(b"\0", o)
        entries.append({"slot": slot, "set": set_,
                        "animation": data[o:end].decode("utf-8", "replace")})
        o = end + 1
    return {"version": version, "id_counter": id_counter,
            "skeleton": skeleton, "inputs": inputs, "slots": slots,
            "entries": entries, "graph_blob": data[o:],
            "raw_inputs": raw_inputs}


_DIRS = {"forward": (0.0, 1.0), "backward": (0.0, -1.0),
         "left": (-1.0, 0.0), "right": (1.0, 0.0)}
_GAIT_SPEED = {"walk": 1.5, "run": 4.0, "idle": 0.0}


def _slot_point(name: str) -> Optional[Tuple[float, float, int]]:
    """(x, y, stance) locomotion point from a slot name, or None if the slot
    isn't a locomotion clip (jump, aiming, ...)."""
    n = name.lower()
    if "jump" in n or "aiming" in n:
        return None
    stance = 1 if "crouching" in n else 0
    gait = next((g for g in ("walk", "run", "idle") if n.startswith(g)), None)
    if gait is None:
        return None
    d = [0.0, 0.0]
    for w, v in _DIRS.items():
        if re.search(rf"\b{w}\b", n):
            d[0] += v[0]
            d[1] += v[1]
    mag = (d[0] ** 2 + d[1] ** 2) ** 0.5
    if mag > 0:
        d = [d[0] / mag, d[1] / mag]
    s = _GAIT_SPEED[gait]
    return (d[0] * s, d[1] * s, stance)


def build_controller(parsed: Dict[str, Any], assets, name: str,
                     model_path: Optional[str] = None) -> int:
    """Register all referenced clips and create a semantically equivalent
    Controller in the anim system; returns the controller id."""
    from lumixengine_tpu_torch.animation.controller import (
        AnimationNode, Blend2D, Controller, Input, Select,
    )

    skel_path = parsed["skeleton"] or model_path
    slot_clip: Dict[int, int] = {}
    for e in parsed["entries"]:
        if e["set"] != 0 or not e["animation"]:
            continue
        slot_clip[e["slot"]] = assets.clip_id(e["animation"], skel_path)

    input_names: List[str] = []
    for t, nm in parsed["inputs"]:
        if t == "vec3":  # scalar input rows; vec3 splits into components
            input_names += [f"{nm}.x", f"{nm}.y", f"{nm}.z"]
        else:
            input_names.append(nm)

    def input_idx(nm: str) -> Optional[int]:
        return input_names.index(nm) if nm in input_names else None

    # locomotion points by stance
    stances: Dict[int, List[Tuple[Tuple[float, float], Any]]] = {0: [], 1: []}
    fallback = None
    for slot, cid in slot_clip.items():
        sname = parsed["slots"][slot] if slot < len(parsed["slots"]) else ""
        pt = _slot_point(sname)
        node = AnimationNode(cid)
        if fallback is None:
            fallback = node
        if pt is None:
            continue
        x, y, stance = pt
        stances[stance].append(((x, y), node))

    ix, iy = input_idx("speed_x"), input_idx("speed_y")
    blends = []
    for stance in (0, 1):
        pts = stances[stance]
        if len(pts) >= 3 and ix is not None and iy is not None:
            blends.append(Blend2D(Input(ix), Input(iy), pts))
        elif pts:
            blends.append(pts[0][1])
    if not blends:
        if fallback is None:
            raise ValueError("act: no usable animation entries")
        root = fallback
    elif len(blends) == 2 and input_idx("stance") is not None:
        root = Select(Input(input_idx("stance")), blends)
    else:
        root = blends[0]

    ctrl = Controller(name, assets.anim.bank_statics, root, inputs=input_names)
    return assets.anim.add_controller(ctrl)


def load_controller(path: str, assets, model_path: Optional[str] = None) -> int:
    with open(path, "rb") as f:
        parsed = parse_act(f.read())
    return build_controller(parsed, assets, name=path, model_path=model_path)


_VALUE_TYPE_IDS = {v: k for k, v in VALUE_TYPES.items()}


def write_act(parsed: Dict[str, Any]) -> bytes:
    """Inverse of parse_act: re-emit the exactly-specified header portion
    (magic/version/id_counter, skeleton, typed inputs, slots, slot→clip
    entries) and pass the opaque editor-era node-graph blob through
    unchanged, so an unedited file round-trips byte-exact and header edits
    (retargeted entries, renamed slots/inputs) write the reference layout
    (≙ controller.cpp:81-140 serialize)."""
    out = bytearray()
    out += MAGIC
    out += struct.pack("<II", parsed["version"], parsed["id_counter"])
    out += parsed["skeleton"].encode("utf-8") + b"\0"
    out += struct.pack("<I", len(parsed["inputs"]))
    raw = parsed.get("raw_inputs") or []
    for i, (t, nm) in enumerate(parsed["inputs"]):
        tid = _VALUE_TYPE_IDS.get(t)
        if tid is None:
            tid = int(t)  # unknown types round-trip via their numeric string
        rec = struct.pack("<I", tid) + nm.encode("utf-8")[:31].ljust(32, b"\0")
        if i < len(raw) and raw[i][:4] == rec[:4] and \
                raw[i][4:].split(b"\0")[0] == nm.encode("utf-8")[:31]:
            rec = raw[i]       # unedited: keep the exact on-disk bytes
        out += rec
    out += struct.pack("<I", len(parsed["slots"]))
    for s in parsed["slots"]:
        out += s.encode("utf-8") + b"\0"
    out += struct.pack("<I", len(parsed["entries"]))
    for e in parsed["entries"]:
        out += struct.pack("<II", e["slot"], e["set"])
        out += e["animation"].encode("utf-8") + b"\0"
    out += parsed.get("graph_blob", b"")
    return bytes(out)

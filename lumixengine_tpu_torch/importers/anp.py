"""PropertyAnimation (.anp) importer (counterpart of
``lumixengine_tpu/importers/anp.py``; ≙ reference
src/animation/property_animation.cpp — curve list driving transform channels
or reflected float properties; the demo ships the editor's text form).

Text format: a sequence of ``{ version?, type, keyframes = [...],
values = [...] }`` blocks. Old files (no ``version`` field) store keyframes
as 30 fps frame numbers — the reference's loader divides by 30 when
``header.version <= Version::TIME``; versioned files store seconds.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

# curve type → (component, property) in this engine's property_animator
# (≙ animation_plugins.cpp g_transform_descs; POS and LOCAL_POS coincide for
# the root-level entities property animations target in practice)
CURVE_TARGETS = {
    "Position X": ("transform", "x"),
    "Position Y": ("transform", "y"),
    "Position Z": ("transform", "z"),
    "Local position X": ("transform", "x"),
    "Local position Y": ("transform", "y"),
    "Local position Z": ("transform", "z"),
    "Scale X": ("transform", "scale_x"),
    "Scale Y": ("transform", "scale_y"),
    "Scale Z": ("transform", "scale_z"),
}

_BLOCK = re.compile(r"\{(.*?)\}", re.S)
_FIELD = re.compile(r"(\w+)\s*=\s*(\"[^\"]*\"|\[[^\]]*\]|[-\w.]+)")


def parse_anp(text: str) -> List[Dict[str, Any]]:
    """→ [{"type", "times" (seconds), "values"}]."""
    curves = []
    for m in _BLOCK.finditer(text):
        fields: Dict[str, Any] = {}
        for fm in _FIELD.finditer(m.group(1)):
            key, val = fm.group(1), fm.group(2)
            if val.startswith('"'):
                fields[key] = val.strip('"')
            elif val.startswith("["):
                fields[key] = [float(x) for x in
                               re.findall(r"[-\d.eE+]+", val)]
            else:
                try:
                    fields[key] = float(val)
                except ValueError:
                    fields[key] = val
        if "type" not in fields:
            continue
        times = fields.get("keyframes", [])
        if "version" not in fields:
            times = [t / 30.0 for t in times]   # old files: 30 fps frames
        curves.append({"type": fields["type"], "times": times,
                       "values": fields.get("values", [])})
    return curves


def to_component_curves(curves: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """→ property_animator component curve dicts; unknown types skipped."""
    out = []
    for c in curves:
        tgt = CURVE_TARGETS.get(c["type"])
        if tgt is None:
            continue
        out.append({"component": tgt[0], "property": tgt[1],
                    "times": c["times"], "values": c["values"]})
    return out

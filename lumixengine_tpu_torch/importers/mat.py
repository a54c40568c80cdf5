"""`.mat` material files (counterpart of ``lumixengine_tpu/importers/mat.py``)
— parse + write the reference's text format
(≙ src/renderer/material.cpp:455-540 load keywords and
:137-216 Material::serialize — clean-room reimplementation of the written
format, not the code).

A material file is a flat list of statements:

    shader "/engine/shaders/standard.hlsl"
    backface_culling true
    layer "transparent"
    define "ALPHA_CUTOUT"
    custom_flag "require8bit"
    texture "albedo.tga"            # ordered slots; "" keeps the default
    uniform "Material color", { 1, 0.5, 0.25, 1 }
    uniform "Roughness", 0.8
    int_uniform "Frames cols", 2

`parse_mat` returns a MatFile; `write_mat` emits text the reference loader
accepts back (serialize order mirrors material.cpp:137-216: shader,
backface_culling, layer, defines, textures, custom_flags, uniforms).
`to_material` bridges a MatFile into the renderer's MaterialRegistry slots
so engine-side draws pick up albedo/roughness/etc. (renderer/material.py
UNIFORM_SLOTS)."""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple, Union

Number = Union[int, float]
UniformValue = Union[Number, Tuple[float, ...]]


@dataclass
class MatFile:
    shader: str = ""
    backface_culling: bool = True
    layer: str = "default"
    defines: List[str] = field(default_factory=list)
    custom_flags: List[str] = field(default_factory=list)
    textures: List[str] = field(default_factory=list)   # ordered slots
    uniforms: Dict[str, UniformValue] = field(default_factory=dict)
    int_uniforms: Dict[str, int] = field(default_factory=dict)


_STR = re.compile(r'\s*"([^"]*)"')
_NUM = re.compile(r"\s*([-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)")


def _parse_value(rest: str) -> UniformValue:
    rest = rest.strip()
    if rest.startswith("{"):
        nums = [float(m) for m in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?",
                                             rest)]
        return tuple(nums)
    m = _NUM.match(rest)
    if not m:
        raise ValueError(f"bad uniform value: {rest!r}")
    s = m.group(1)
    return float(s)


def parse_mat(text: Union[str, bytes]) -> MatFile:
    if isinstance(text, bytes):
        text = text.decode("utf-8", "replace")
    out = MatFile()
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        key, _, rest = line.partition(" ")
        if key == "shader":
            m = _STR.match(rest)
            out.shader = m.group(1) if m else rest.strip().strip('"')
        elif key == "backface_culling":
            out.backface_culling = rest.strip().lower() in ("true", "1")
        elif key == "layer":
            m = _STR.match(rest)
            out.layer = m.group(1) if m else rest.strip().strip('"')
        elif key == "define":
            m = _STR.match(rest)
            if m:
                out.defines.append(m.group(1))
        elif key == "custom_flag":
            m = _STR.match(rest)
            if m:
                out.custom_flags.append(m.group(1))
        elif key == "texture":
            m = _STR.match(rest)
            out.textures.append(m.group(1) if m else "")
        elif key in ("uniform", "int_uniform"):
            m = _STR.match(rest)
            if not m:
                raise ValueError(f"bad uniform line: {line!r}")
            name = m.group(1)
            after = rest[m.end():].lstrip()
            if after.startswith(","):
                after = after[1:]
            val = _parse_value(after)
            if key == "int_uniform":
                out.int_uniforms[name] = int(val)
            else:
                out.uniforms[name] = val
        # unknown keys are skipped (the reference hard-errors; imports
        # should survive newer files)
    return out


def _fmt_num(v: float) -> str:
    return f"{v:.6f}" if isinstance(v, float) else str(v)


def write_mat(m: MatFile) -> str:
    """Serialize in the reference's order (material.cpp:137-216)."""
    lines = [f'shader "{m.shader}"',
             f"backface_culling {'true' if m.backface_culling else 'false'}",
             f'layer "{m.layer}"']
    lines += [f'define "{d}"' for d in m.defines]
    lines += [f'texture "{t}"' for t in m.textures]
    lines += [f'custom_flag "{f}"' for f in m.custom_flags]
    for name, v in m.int_uniforms.items():
        lines.append(f'int_uniform "{name}", {int(v)}')
    for name, v in m.uniforms.items():
        if isinstance(v, tuple):
            body = ", ".join(_fmt_num(float(x)) for x in v)
            lines.append(f'uniform "{name}", {{ {body} }}')
        else:
            lines.append(f'uniform "{name}", {_fmt_num(float(v))}')
    return "\n".join(lines) + "\n"


# -- bridge into the renderer's material registry ---------------------------

# reference shader uniform names → our MaterialBank slots
# (renderer/material.py UNIFORM_SLOTS)
_SLOT_MAP = {
    "Roughness": "roughness",
    "Metallic": "metallic",
    "Emission": "emission",
    "Alpha ref": "alpha_ref",
}


def to_material(name: str, mf: MatFile):
    """MatFile → renderer Material (the engine-side parameter block)."""
    from lumixengine_tpu_torch.renderer.material import Material

    uniforms: Dict[str, float] = {}
    for uname, v in mf.uniforms.items():
        if uname == "Material color" and isinstance(v, tuple):
            for i, c in enumerate(("color_r", "color_g", "color_b",
                                   "color_a")[: len(v)]):
                uniforms[c] = float(v[i])
        elif uname in _SLOT_MAP and not isinstance(v, tuple):
            uniforms[_SLOT_MAP[uname]] = float(v)
    textures = {f"slot{i}": t for i, t in enumerate(mf.textures) if t}
    return Material(
        name=name,
        shader="standard",
        layer=mf.layer or "default",
        uniforms=uniforms,
        textures=textures,
        defines=list(mf.defines),
        alpha_blend=(mf.layer == "transparent"),
    )


def register(compiler) -> None:
    """AssetCompiler plugin: .mat validates/round-trips through the parser
    (≙ MaterialPlugin::compile passing the source through,
    render_plugins.cpp MaterialPlugin)."""

    def _compile(path: str, src: bytes) -> bytes:
        return write_mat(parse_mat(src)).encode()

    compiler.add_plugin("mat", _compile)

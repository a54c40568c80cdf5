"""DrawStream — the host command buffer (counterpart of
``lumixengine_tpu/renderer/draw_stream.py``).

The render pipeline records typed commands that reference device tensors
(instance buffers, palettes, particle payloads) into a stream; substreams
recorded in parallel merge in a fixed order; a backend replays the commands
against whatever presents. ``record_frame`` records one view's frame with
the RenderPlugin hooks at the reference's call points. The port has no
terrain, decal or procedural-geometry store (those components raise on
creation), so a frame holds the commands of the components it has, in the
reference's order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# command opcodes
OP_SET_PASS = "set_pass"
OP_BIND_MATERIAL = "bind_material"
OP_BIND_INSTANCES = "bind_instances"
OP_BIND_PALETTES = "bind_palettes"
OP_DRAW_MODEL = "draw_model"
OP_DRAW_INSTANCED = "draw_instanced"
OP_DRAW_PARTICLES = "draw_particles"
OP_DRAW_TERRAIN = "draw_terrain"
OP_DRAW_2D = "draw_2d"
OP_DISPATCH = "dispatch"
OP_BARRIER = "barrier"


@dataclass
class DrawCommand:
    op: str
    args: Dict[str, Any] = field(default_factory=dict)


class DrawStream:
    def __init__(self, name: str = "main"):
        self.name = name
        self.commands: List[DrawCommand] = []
        self._substreams: List["DrawStream"] = []

    def push(self, op: str, **args) -> None:
        self.commands.append(DrawCommand(op, args))

    def substream(self, name: str = "") -> "DrawStream":
        """A stream recorded on its own, merged after the commands already
        pushed, in the order the substreams were created."""
        s = DrawStream(name or f"{self.name}/{len(self._substreams)}")
        self._substreams.append(s)
        return s

    def merge(self) -> None:
        for s in self._substreams:
            s.merge()
            self.commands.extend(s.commands)
        self._substreams = []

    def replay(self, backend) -> int:
        """Call the backend's method named after each op with the command's
        arguments (``backend.unknown(op=..., **args)`` for an op it lacks).
        Returns the number of commands replayed."""
        self.merge()
        for cmd in self.commands:
            fn = getattr(backend, cmd.op, None)
            if fn is None:
                getattr(backend, "unknown", lambda **kw: None)(op=cmd.op, **cmd.args)
            else:
                fn(**cmd.args)
        return len(self.commands)


class RenderPlugin:
    """Hooks called at fixed points of every frame's recording. Override any
    subset; each receives the stream, the View and the RenderModule. A
    `tonemap` that returns True claims the pass (the builtin tonemap
    dispatch is skipped)."""

    def render_opaque(self, stream, view, module):
        pass

    def render_transparent(self, stream, view, module):
        pass

    def render_before_tonemap(self, stream, view, module):
        pass

    def tonemap(self, stream, view, module) -> bool:
        return False

    def render_after_tonemap(self, stream, view, module):
        pass

    def render_ui(self, stream, view, module):
        pass


def record_frame(view, rs, module, stream: Optional[DrawStream] = None) -> DrawStream:
    """Record one frame's commands from the View of one world."""
    plugins = module.system.plugins
    s = stream or DrawStream()
    s.push(OP_SET_PASS, name="gbuffer")
    s.push(OP_BIND_INSTANCES, pos=view.instance_pos, rot=view.instance_rot,
           scale=view.instance_scale, models=view.instance_model,
           slots=view.instance_slot, count=view.visible_count)
    s.push(OP_DRAW_INSTANCED, sorted_by="material")
    if getattr(module.world.modules.get("animation"), "name", None):
        s.push(OP_BIND_PALETTES, source="animation.palette")
    # the instanced-model chunks that survived culling
    st = module.statics()
    if st.im_slots.size:
        vis = view.instanced_visible.cpu().numpy()
        for i in range(st.im_slots.size):
            if vis[i]:
                s.push(OP_DRAW_INSTANCED, model=int(st.im_models[i]), chunk=i,
                       source="instanced_model")
    # clustered point-light shading
    if (module.point_lights.entity >= 0).any():
        s.push(OP_DISPATCH, shader="deferred_lights")
    for p in plugins:
        p.render_opaque(s, view, module)
    s.push(OP_SET_PASS, name="transparent")
    for key in module.particle_emitters:
        s.push(OP_DRAW_PARTICLES, emitter=key)
    for p in plugins:
        p.render_transparent(s, view, module)
    s.push(OP_SET_PASS, name="tonemap")
    for p in plugins:
        p.render_before_tonemap(s, view, module)
    if not any(p.tonemap(s, view, module) for p in plugins):
        s.push(OP_DISPATCH, shader="tonemap")
    for p in plugins:
        p.render_after_tonemap(s, view, module)
    s.push(OP_SET_PASS, name="ui")
    s.push(OP_DRAW_2D)
    for p in plugins:
        p.render_ui(s, view, module)
    return s

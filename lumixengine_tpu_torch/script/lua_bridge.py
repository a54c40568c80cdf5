"""Lumix Lua API bridge: the game-facing userdata surface the reference's
demo scripts program against, implemented over this engine's modules
(the port's copy of ``lumixengine_tpu/script/lua_bridge.py``; its writes go
through the port's World and modules, and device state is read back with
``.cpu()``).

≙ reference src/lua/lua_script_system.cpp (environment tables, property
application, update/onInputEvent pcalls) + the meta-generated Lua C API
(lua_capi.gen.h / lumix.d.lua): `this` entity userdata with component
accessors, `Lumix.Entity.NULL`, `LumixAPI.Keycode`, `Editor.createEntityEx`,
world/module wrappers.

Device interaction contract: script writes are RECORDED host-side during the
script phase and applied to the device state in one batch before the fused
step (ScriptModule.apply_pending). Structural edits (createEntityEx, destroy)
mark the step for rebuild — the slow path, exactly like the reference's
structural edits walking engine reflection.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from lumixengine_tpu_torch.core import log
from lumixengine_tpu_torch.script.lua import Interpreter, LuaError, LuaTable, lua_tostring

# ≙ reference core/os.h Keycode (Win32 VK codes; letters/digits are ASCII)
KEYCODES: Dict[str, int] = {
    "LBUTTON": 0x01, "RBUTTON": 0x02, "BACKSPACE": 0x08, "TAB": 0x09,
    "RETURN": 0x0D, "SHIFT": 0x10, "CTRL": 0x11, "ALT": 0x12,
    "ESCAPE": 0x1B, "SPACE": 0x20, "PAGEUP": 0x21, "PAGEDOWN": 0x22,
    "END": 0x23, "HOME": 0x24, "LEFT": 0x25, "UP": 0x26, "RIGHT": 0x27,
    "DOWN": 0x28, "INSERT": 0x2D, "DEL": 0x2E,
    **{c: ord(c) for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"},
    **{f"F{i}": 0x6F + i for i in range(1, 13)},
    "NUMPAD0": 0x60, "MULTIPLY": 0x6A, "ADD": 0x6B, "SUBTRACT": 0x6D,
    "DIVIDE": 0x6F, "LSHIFT": 0xA0, "RSHIFT": 0xA1, "LCTRL": 0xA2,
    "RCTRL": 0xA3, "LALT": 0xA4, "RALT": 0xA5,
}

# reference component property name → this engine's component type
COMPONENT_ALIASES = {
    "physical_controller": "physics_controller",
    "navmesh_agent": "nav_agent",
    "lua_script": "lua_script",  # handled specially
}


def _host(t) -> np.ndarray:
    """A device tensor read back to numpy."""
    return t.detach().cpu().numpy()


def t2v(t, n: int = 3) -> np.ndarray:
    """Lua {x, y, z} table → np.float32 vector."""
    if isinstance(t, LuaTable):
        return np.asarray([float(t.get(i + 1) or 0.0) for i in range(n)], np.float32)
    return np.asarray(t, np.float32)


def v2t(v) -> LuaTable:
    t = LuaTable()
    for i, x in enumerate(np.asarray(v).reshape(-1)):
        t.set(i + 1, float(x))
    return t


class LuaEntity:
    """Entity userdata (≙ generated Lumix.Entity): transform properties +
    component accessors + destroy()."""

    __slots__ = ("rt", "id")

    def __init__(self, rt: "ScriptRuntime", entity: int):
        self.rt = rt
        self.id = int(entity)

    def lua_eq(self, other) -> bool:
        return isinstance(other, LuaEntity) and other.id == self.id

    def _check(self):
        if self.id < 0:
            raise LuaError("attempt to use a NULL entity")

    def lua_index(self, key):
        rt = self.rt
        if key == "position":
            self._check()
            return v2t(rt.read_transform(self.id)[0])
        if key == "rotation":
            self._check()
            return v2t(rt.read_transform(self.id)[1])
        if key == "scale":
            self._check()
            return v2t(rt.read_transform(self.id)[2])
        if key == "local_position":
            self._check()
            return v2t(rt.world.local_pos[self.id])
        if key == "local_rotation":
            self._check()
            return v2t(rt.world.local_rot[self.id])
        if key == "name":
            self._check()
            return rt.world.get_entity_name(self.id)
        if key == "world":
            return rt.lua_world
        if key == "parent":
            self._check()
            p = int(rt.world.parent[self.id])
            return LuaEntity(rt, p) if p >= 0 else None
        if key == "destroy":
            return lambda self_, *a: rt.destroy_entity(self_.id)
        if key == "isValid":
            return lambda self_, *a: self_.id >= 0 and bool(rt.world.alive[self_.id])
        if isinstance(key, str):
            self._check()
            if key == "lua_script":
                return LuaScriptComponent(rt, self.id)
            ctype = COMPONENT_ALIASES.get(key, key)
            if ctype in rt.world.component_types and \
                    rt.world.has_component(self.id, ctype):
                return LuaComponent(rt, self.id, ctype)
            return None
        raise LuaError(f"bad entity key {lua_tostring(key)!r}")

    def lua_set(self, key, value):
        rt = self.rt
        self._check()
        if key == "position":
            rt.write_transform(self.id, position=t2v(value))
        elif key == "rotation":
            rt.write_transform(self.id, rotation=t2v(value, 4))
        elif key == "scale":
            rt.write_transform(self.id, scale=t2v(value))
        elif key == "local_position":
            rt.write_local(self.id, position=t2v(value))
        elif key == "local_rotation":
            rt.write_local(self.id, rotation=t2v(value, 4))
        elif key == "parent":
            rt.world.set_parent(self.id, value.id if isinstance(value, LuaEntity) else -1)
            rt.structure_dirty = True
        elif key == "name":
            rt.world.set_entity_name(self.id, str(value))
        else:
            raise LuaError(f"cannot set entity key {lua_tostring(key)!r}")

    def __repr__(self):
        return f"Entity({self.id})"


class LuaComponent:
    """Component userdata: methods + reflected properties by component type."""

    __slots__ = ("rt", "entity", "ctype")

    def __init__(self, rt: "ScriptRuntime", entity: int, ctype: str):
        self.rt = rt
        self.entity = entity
        self.ctype = ctype

    # -- methods by type ------------------------------------------------------------

    def lua_index(self, key):
        rt = self.rt
        e = self.entity
        ct = self.ctype
        if ct == "animator":
            if key == "getInputIndex":
                return lambda s, name: float(rt.animator_input_index(e, str(name)))
            if key == "setFloatInput":
                return lambda s, idx, v: rt.set_animator_input(e, int(idx), float(v))
            if key == "setBoolInput":
                return lambda s, idx, v: rt.set_animator_input(
                    e, int(idx), 1.0 if v else 0.0)
            if key == "setVec3Input":
                return lambda s, idx, v: rt.set_animator_input(e, int(idx), t2v(v))
        elif ct == "physics_controller":
            if key == "move":
                return lambda s, disp: rt.move_controller(e, t2v(disp))
            if key == "getGravitySpeed":
                return lambda s: rt.controller_gravity_speed(e)
            if key == "isGrounded":
                return lambda s: rt.controller_grounded(e)
        elif ct == "rigid_actor":
            if key == "applyForce":
                return lambda s, f: rt.apply_force(e, t2v(f))
            if key == "applyImpulse":
                return lambda s, f: rt.apply_force(e, t2v(f), impulse=True)
        elif ct == "nav_agent":
            if key == "navigate":
                return lambda s, pos, speed=3.0, stop=0.5: rt.navigate(
                    e, t2v(pos), float(speed), float(stop))
            if key == "cancelNavigation":
                return lambda s: rt.cancel_navigation(e)
        elif ct == "model_instance":
            if key == "overrideMaterialVec4":
                return lambda s, mesh_idx, name, v: rt.override_material(
                    e, int(mesh_idx), str(name), t2v(v, 4))
            if key == "source":
                return rt.model_source(e)
        # reflected property read (≙ generated per-property getters)
        try:
            from lumixengine_tpu_torch.engine import reflection

            v = reflection.registry.get_property(rt.world, e, ct, str(key))
            if isinstance(v, np.ndarray):
                return v2t(v)
            if isinstance(v, (np.bool_, bool)):
                return bool(v)
            if isinstance(v, (int, float, np.integer, np.floating)):
                return float(v)
            return v
        except Exception:
            return None

    def lua_set(self, key, value):
        rt = self.rt
        if self.ctype == "property_animator" and key == "enabled":
            rt.set_property_animator_enabled(self.entity, bool(value))
            return
        if self.ctype in ("gui_rect", "gui_text") and key == "enabled":
            rt.set_gui_enabled(self.entity, bool(value))
            return
        if self.ctype == "gui_text" and key == "text":
            rt.set_gui_text(self.entity, lua_tostring(value))
            return
        if isinstance(value, LuaTable):
            value = t2v(value, value.length())
        elif isinstance(value, bool):
            pass
        from lumixengine_tpu_torch.engine import reflection

        try:
            reflection.registry.set_property(rt.world, self.entity, self.ctype,
                                             str(key), value)
            rt.component_prop_dirty = True
        except Exception as ex:
            raise LuaError(f"cannot set {self.ctype}.{key}: {ex}")


class LuaScriptComponent:
    """`entity.lua_script` userdata (≙ lua_script component): `.scripts` array
    with add()/[i].path, and [i] → that script's environment table."""

    __slots__ = ("rt", "entity")

    def __init__(self, rt: "ScriptRuntime", entity: int):
        self.rt = rt
        self.entity = entity

    def lua_index(self, key):
        if key == "scripts":
            return LuaScriptsArray(self.rt, self.entity)
        if isinstance(key, (int, float)):
            envs = self.rt.module.lua_envs.get(self.entity, [])
            i = int(key) - 1
            if 0 <= i < len(envs):
                return envs[i].env
            return None
        # fall through: first script's global (player.lua_script.handle_input)
        envs = self.rt.module.lua_envs.get(self.entity, [])
        if envs:
            return envs[0].env.get(key)
        return None

    def lua_set(self, key, value):
        envs = self.rt.module.lua_envs.get(self.entity, [])
        if envs:
            envs[0].env.set(key, value)


class LuaScriptsArray:
    __slots__ = ("rt", "entity")

    def __init__(self, rt: "ScriptRuntime", entity: int):
        self.rt = rt
        self.entity = entity

    def lua_len(self) -> int:
        return len(self.rt.module.lua_envs.get(self.entity, []))

    def lua_index(self, key):
        if key == "add":
            def _add(*_a):
                self.rt.module.attach_lua_script(self.entity, source="")
            return _add
        if isinstance(key, (int, float)):
            envs = self.rt.module.lua_envs.get(self.entity, [])
            i = int(key) - 1
            if 0 <= i < len(envs):
                return LuaScriptSlot(self.rt, self.entity, i)
        return None

    def lua_set(self, key, value):
        raise LuaError("scripts array is not directly assignable")


class LuaScriptSlot:
    __slots__ = ("rt", "entity", "index")

    def __init__(self, rt, entity, index):
        self.rt = rt
        self.entity = entity
        self.index = index

    def lua_index(self, key):
        envs = self.rt.module.lua_envs.get(self.entity, [])
        if key == "path":
            return envs[self.index].path if self.index < len(envs) else None
        if self.index < len(envs):
            return envs[self.index].env.get(key)
        return None

    def lua_set(self, key, value):
        if key == "path":
            self.rt.module.set_lua_script_path(self.entity, self.index, str(value))
        else:
            envs = self.rt.module.lua_envs.get(self.entity, [])
            if self.index < len(envs):
                envs[self.index].env.set(key, value)


class LuaModuleWrapper:
    """`world:getModule(name)` result — per-module script methods."""

    __slots__ = ("rt", "mname")

    def __init__(self, rt, mname):
        self.rt = rt
        self.mname = mname

    def lua_index(self, key):
        rt = self.rt
        if self.mname == "audio":
            if key == "play":
                def _play(_s, entity, path, _is_3d=False):
                    rt.play_sound(entity.id if isinstance(entity, LuaEntity) else -1,
                                  lua_tostring(path))
                return _play
        if self.mname in ("renderer", "render"):
            if key == "addDebugLine":
                return lambda _s, a, b, color=None: rt.add_debug_line(
                    t2v(a), t2v(b), t2v(color) if color is not None else None)
            if key == "addDebugCross":
                return lambda _s, p, size=1.0, color=None: rt.add_debug_line(
                    t2v(p) - size, t2v(p) + size,
                    t2v(color) if color is not None else None)
        if self.mname == "gui":
            if key == "getSystem":
                return lambda _s: LuaGuiSystem(rt)
        if self.mname == "navigation":
            if key == "setActorActive":
                return lambda _s, *a: None
        return None

    def lua_set(self, key, value):
        raise LuaError(f"cannot set module key {key!r}")


class LuaGuiSystem:
    __slots__ = ("rt",)

    def __init__(self, rt):
        self.rt = rt

    def lua_index(self, key):
        if key == "enableCursor":
            return lambda _s, on: setattr(self.rt, "cursor_enabled", bool(on))
        return None

    def lua_set(self, key, value):
        raise LuaError("gui system is read-only")


class LuaWorld:
    """`this.world` userdata (≙ generated Lumix.World)."""

    __slots__ = ("rt",)

    def __init__(self, rt):
        self.rt = rt

    def lua_index(self, key):
        rt = self.rt
        if key == "createEntityEx":
            return lambda _s, props: rt.create_entity_ex(props)
        if key == "createEntity":
            return lambda _s: LuaEntity(rt, rt.world.create_entity())
        if key == "getModule":
            return lambda _s, name: LuaModuleWrapper(rt, lua_tostring(name))
        if key == "findEntityByName":
            def _find(_s, name):
                e = rt.world.find_by_name(lua_tostring(name))
                return LuaEntity(rt, e) if e >= 0 else None
            return _find
        if key == "getActivePartition":
            return lambda _s: float(rt.world.active_partition)
        if key == "setActivePartition":
            def _setap(_s, p):
                rt.active_partition = int(p)
                rt.world.set_active_partition(int(p))
            return _setap
        if key == "createPartition":
            return lambda _s, name: float(rt.world.create_partition(lua_tostring(name)))
        if key == "destroyPartition":
            def _dp(_s, p):
                n = rt.world.destroy_partition(int(p))
                if n:
                    rt.structure_dirty = True
            return _dp
        if key == "load":
            return lambda _s, path, cb=None: rt.load_additive(lua_tostring(path), cb)
        if key in ("renderer", "navigation", "audio", "gui", "physics"):
            return LuaModuleWrapper(rt, key)
        return None

    def lua_set(self, key, value):
        raise LuaError("world is read-only from scripts")


class LuaResource:
    """`Lumix.Resource` stub: newEmpty + getPath (sound properties)."""

    __slots__ = ("path",)

    def __init__(self, path: str = ""):
        self.path = path

    def lua_index(self, key):
        if key == "newEmpty":
            return lambda _s, _rtype=None: LuaResource("")
        if key == "getPath":
            return lambda s: s.path
        return None

    def lua_set(self, key, value):
        if key == "path":
            self.path = str(value)
        else:
            raise LuaError("resource is read-only")


class ScriptRuntime:
    """Per-world Lua universe + the pending-write buffers the Runner flushes
    into the device state each frame (see module docstring)."""

    def __init__(self, module):
        self.module = module
        self.world = module.world
        self.interp = Interpreter(loader=self._load_module)
        self.interp.print_fn = lambda s: log.log_info("lua", s)
        self.lua_world = LuaWorld(self)
        self.active_partition = 0
        self.cursor_enabled = False
        # pending writes (flushed by ScriptModule.apply_pending)
        self.dirty_transforms: set = set()
        self.pending_anim_inputs: Dict[tuple, Any] = {}   # (input, slot) → value
        self.pending_moves: Dict[int, np.ndarray] = {}    # entity → summed disp
        self.pending_forces: List[tuple] = []             # (entity, force, impulse)
        self.pending_nav: List[tuple] = []                # (entity, dst, speed, stop)
        self.pending_pa_enabled: Dict[int, bool] = {}     # pa index → flag
        self.pending_gui_enabled: Dict[int, bool] = {}    # rect slot → flag
        self.structure_dirty = False
        self.component_prop_dirty = False
        self.debug_lines: List[tuple] = []
        self.material_overrides: Dict[tuple, np.ndarray] = {}
        self._nav_active: set = set()
        # spawn pool (see create_entity_ex): spec → parked entity ids
        self.spawn_pools: Dict[tuple, List[int]] = {}
        self.pooled_entities: Dict[int, tuple] = {}
        self.pool_batch = 64
        self._install_globals()

    # -- module loading (require / inherit) ------------------------------------------

    def _load_module(self, path: str) -> Optional[str]:
        return self.module.read_lua_source(path if path.endswith(".lua")
                                           else path + ".lua")

    # -- globals (≙ lua_capi.gen.h installation into the state) ----------------------

    def _install_globals(self) -> None:
        G = self.interp.G
        lumix = LuaTable()
        ent = LuaTable()
        ent.set("NULL", LuaEntity(self, -1))
        lumix.set("Entity", ent)
        lumix.set("Resource", LuaResource())
        G.set("Lumix", lumix)

        api = LuaTable()
        kc = LuaTable()
        for name, code in KEYCODES.items():
            kc.set(name, float(code))
        api.set("Keycode", kc)
        api.set("logError", lambda msg=None: log.log_error("lua", lua_tostring(msg)))
        api.set("logInfo", lambda msg=None: log.log_info("lua", lua_tostring(msg)))
        G.set("LumixAPI", api)

        editor = LuaTable()
        editor.set("createEntityEx", lambda props: self.create_entity_ex(props))
        editor.set("setPropertyValue", lambda *a: None)
        G.set("Editor", editor)

        gui = LuaTable()
        gui.set("enableCursor", lambda on=False: setattr(self, "cursor_enabled", bool(on)))
        G.set("Gui", gui)

        G.set("this", None)  # real `this` lives in each script env

    # -- transforms -------------------------------------------------------------------

    def read_transform(self, e: int):
        """Prefer last frame's device result unless scripts wrote this entity
        this frame (then the host-side value is authoritative)."""
        st = self.module.latest_state
        if st is not None and e not in self.dirty_transforms \
                and self.world.alive[e]:
            slot = self.world.slot(e)
            if slot >= 0:
                return (_host(st.world.pos[:, slot]),
                        _host(st.world.rot[:, slot]),
                        _host(st.world.scale[:, slot]))
        return self.world.get_global_transform(e)

    def write_transform(self, e: int, position=None, rotation=None, scale=None):
        self.world.set_global_transform(e, position=position, rotation=rotation,
                                        scale=scale)
        self.dirty_transforms.add(e)

    def write_local(self, e: int, position=None, rotation=None):
        if position is not None:
            self.world.local_pos[e] = position
        if rotation is not None:
            self.world.local_rot[e] = rotation
        self.dirty_transforms.add(e)

    # -- entity / structure --------------------------------------------------------------

    PARK_POS = (0.0, -1.0e6, 0.0)
    POOLABLE = ("model_instance", "nav_agent", "navmesh_agent", "animator",
                "lua_script")

    def destroy_entity(self, e: int) -> None:
        if e in self.pooled_entities:
            self._park(e)
            return
        self.world.destroy_entity(e)
        self.module.lua_envs.pop(e, None)
        self.dirty_transforms.discard(e)
        self.structure_dirty = True

    def _park(self, e: int) -> None:
        """Return a pooled entity: hide it with state writes only (scale 0 at
        the park position culls it; no retrace)."""
        w = self.world
        w.local_pos[e] = np.asarray(self.PARK_POS, np.float32)
        w.local_scale[e] = np.zeros(3, np.float32)
        self.dirty_transforms.add(e)
        self.module.lua_envs.pop(e, None)
        self.cancel_navigation(e)
        self.spawn_pools[self.pooled_entities[e]].append(e)

    def _spec_key(self, props) -> Optional[tuple]:
        """Poolable component signature, or None if the spawn needs the
        structural slow path (non-poolable component kinds)."""
        if not isinstance(props, LuaTable):
            return ()
        key = []
        for k, v in props.hash.items():
            k = str(k)
            if k in ("position", "rotation", "scale", "name"):
                continue
            if k not in self.POOLABLE:
                return None
            src = ""
            if isinstance(v, LuaTable) and v.get("source") is not None:
                src = lua_tostring(v.get("source"))
            key.append((COMPONENT_ALIASES.get(k, k), src))
        return tuple(sorted(key))

    def create_entity_ex(self, props) -> LuaEntity:
        """≙ Editor.createEntityEx / World::createEntityEx — table of
        component-type → prop-table (plus position/rotation/scale).

        Spawn pool: repeated spawns of the same component signature claim
        pre-created parked entities (state writes only — the step keeps its
        trace); only the FIRST spawn of a signature pays one retrace to create
        the batch. This is the capacity+mask discipline the rest of the engine
        uses for dynamic counts (SURVEY §7 design stance)."""
        spec = self._spec_key(props)
        if spec is not None:
            pool = self.spawn_pools.setdefault(spec, [])
            if not pool:
                self._create_pool_batch(spec, props)
            if pool:
                return self._claim(pool.pop(), props)
        return self._create_structural(props)

    def _claim(self, e: int, props) -> LuaEntity:
        w = self.world
        pos = t2v(props.get("position")) if props.get("position") is not None \
            else np.zeros(3, np.float32)
        rot = t2v(props.get("rotation"), 4) if props.get("rotation") is not None \
            else np.asarray([0, 0, 0, 1], np.float32)
        scale = t2v(props.get("scale")) if props.get("scale") is not None \
            else np.ones(3, np.float32)
        w.set_global_transform(e, position=pos, rotation=rot, scale=scale)
        if props.get("name") is not None:
            w.set_entity_name(e, lua_tostring(props.get("name")))
        self.dirty_transforms.add(e)
        return LuaEntity(self, e)

    def _create_pool_batch(self, spec: tuple, props) -> None:
        w = self.world
        n_free = len(w._free)
        batch = min(self.pool_batch, max(n_free - 8, 0))
        if batch <= 0:
            return
        for _ in range(batch):
            e = w.create_entity(position=self.PARK_POS, scale=(0.0, 0.0, 0.0))
            model_path = next((src for k, src in spec if k == "model_instance"), None)
            for kind, src in spec:
                if kind == "lua_script":
                    continue
                t = LuaTable()
                if src:
                    t.set("source", src)
                self._create_component_from_lua(e, kind, t, model_path)
            self.pooled_entities[e] = spec
            self.spawn_pools[spec].append(e)
        self.structure_dirty = True

    def _create_structural(self, props) -> LuaEntity:
        w = self.world
        kw = {}
        if isinstance(props, LuaTable):
            if props.get("position") is not None:
                kw["position"] = t2v(props.get("position"))
            if props.get("rotation") is not None:
                kw["rotation"] = t2v(props.get("rotation"), 4)
            if props.get("scale") is not None:
                kw["scale"] = t2v(props.get("scale"))
            if props.get("name") is not None:
                kw["name"] = lua_tostring(props.get("name"))
        e = w.create_entity(**kw)
        if isinstance(props, LuaTable):
            model_path = None
            mi = props.get("model_instance")
            if isinstance(mi, LuaTable):
                model_path = mi.get("source")
            for k, v in list(props.hash.items()):
                if k in ("position", "rotation", "scale", "name"):
                    continue
                self._create_component_from_lua(e, str(k), v, model_path)
        self.structure_dirty = True
        self.dirty_transforms.add(e)
        return LuaEntity(self, e)

    def _create_component_from_lua(self, e: int, kind: str, props, model_path):
        w = self.world
        assets = self.module.asset_bank()
        ctype = COMPONENT_ALIASES.get(kind, kind)
        p = {str(k): v for k, v in props.hash.items()} if isinstance(props, LuaTable) else {}
        try:
            if ctype == "lua_script":
                return  # scripts attach via .scripts.add() afterwards
            if ctype == "model_instance":
                src = lua_tostring(p.get("source", ""))
                mid = assets.model_id(src) if (assets and src) else 0
                w.create_component(e, "model_instance", model=mid)
            elif ctype == "animator":
                src = lua_tostring(p.get("source", ""))
                cid = (assets.controller_id(src, model_path or "")
                       if (assets and src) else -1)
                w.create_component(e, "animator", controller=cid)
            elif ctype == "nav_agent":
                w.create_component(e, "nav_agent",
                                   radius=float(p.get("radius", 0.5)),
                                   speed=float(p.get("speed", 3.0)))
            else:
                clean = {}
                for k, v in p.items():
                    if isinstance(v, LuaTable):
                        v = t2v(v, v.length())
                    clean[k] = v
                w.create_component(e, ctype, **clean)
        except Exception as ex:
            log.log_error("lua", f"createEntityEx: {kind}: {ex}")

    def load_additive(self, path: str, cb) -> None:
        """≙ World::load additive partition load: needs the host tier's .unv
        importer, which the port does not have yet."""
        raise NotImplementedError(
            f"world:load({path!r}): instantiate_additive needs the host tier's importers "
            "(ROADMAP Queue 1 item 7)")

    # -- animator ---------------------------------------------------------------------------

    def _anim(self):
        return self.world.modules.get("animation")

    def animator_input_index(self, e: int, name: str) -> int:
        am = self._anim()
        if am is None:
            return -1
        slot = am.animators.slot_of(e)
        if slot < 0:
            return -1
        cid = int(am.animators.data["controller"][slot])
        try:
            ctrl = am.system.controllers[cid]
            return int(ctrl.input_index(name))
        except Exception:
            return -1

    def set_animator_input(self, e: int, idx: int, value) -> None:
        am = self._anim()
        if am is None or idx < 0:
            return
        slot = am.animators.slot_of(e)
        if slot < 0:
            return
        if isinstance(value, np.ndarray):      # vec3 input: 3 consecutive rows
            for i, x in enumerate(value[:3]):
                self.pending_anim_inputs[(idx + i, slot)] = float(x)
        else:
            self.pending_anim_inputs[(idx, slot)] = float(value)
        am.default_inputs[min(idx, am.default_inputs.shape[0] - 1), slot] = (
            float(value) if not isinstance(value, np.ndarray) else float(value[0]))

    # -- character controller ------------------------------------------------------------------

    def move_controller(self, e: int, disp: np.ndarray) -> None:
        self.pending_moves[e] = self.pending_moves.get(e, 0.0) + disp

    def controller_gravity_speed(self, e: int) -> float:
        st = self.module.latest_state
        pm = self.world.modules.get("physics")
        if st is None or pm is None:
            return 0.0
        slot = pm.controllers.slot_of(e)
        ms = st.modules.get("physics")
        return float(ms.ctrl_vel_y[slot]) if (ms is not None and slot >= 0) else 0.0

    def controller_grounded(self, e: int) -> bool:
        st = self.module.latest_state
        pm = self.world.modules.get("physics")
        if st is None or pm is None:
            return False
        slot = pm.controllers.slot_of(e)
        ms = st.modules.get("physics")
        return bool(ms.ctrl_grounded[slot]) if (ms is not None and slot >= 0) else False

    # -- rigid bodies ----------------------------------------------------------------------------

    def apply_force(self, e: int, force: np.ndarray, impulse: bool = False) -> None:
        self.pending_forces.append((e, force, impulse))

    # -- per-component toggles (state arrays, no retrace) --------------------------------------

    def set_property_animator_enabled(self, e: int, on: bool) -> None:
        am = self._anim()
        if am is None or e not in getattr(am, "property_animators", ()):
            return
        am.pa_default_enabled[e] = on
        idx = sorted(am.property_animators).index(e)
        self.pending_pa_enabled[idx] = on

    def set_gui_enabled(self, e: int, on: bool) -> None:
        gm = self.world.modules.get("gui")
        if gm is None:
            return
        slot = gm.rects.slot_of(e)
        if slot < 0:
            return
        gm.rects.data["enabled"][slot] = on       # host (draw_list) view
        self.pending_gui_enabled[slot] = on       # device (layout/hit) view

    def set_gui_text(self, e: int, text: str) -> None:
        gm = self.world.modules.get("gui")
        if gm is not None and e in gm.texts:
            gm.texts[e]["text"] = text    # host text store feeds draw_list

    # -- navigation --------------------------------------------------------------------------------

    def navigate(self, e: int, dst: np.ndarray, speed: float, stop: float) -> None:
        self.pending_nav.append((e, dst, speed, stop))
        self._nav_active.add(e)

    def cancel_navigation(self, e: int) -> None:
        self._nav_active.discard(e)

    def poll_path_finished(self, state) -> List[int]:
        """Agents whose waypoint list is exhausted since last poll →
        onPathFinished (≙ dtCrowd arrival callbacks)."""
        nm = self.world.modules.get("navigation")
        if nm is None or state is None or not self._nav_active:
            return []
        ms = state.modules.get("navigation")
        if ms is None:
            return []
        done = []
        wp_i = _host(ms.wp_index)
        wp_n = _host(ms.wp_count)
        for e in list(self._nav_active):
            slot = nm.agents.slot_of(e)
            if slot < 0:
                self._nav_active.discard(e)
                continue
            if wp_n[slot] > 0 and wp_i[slot] >= wp_n[slot]:
                self._nav_active.discard(e)
                done.append(e)
        return done

    # -- renderer / audio / misc -----------------------------------------------------------------------

    def add_debug_line(self, a, b, color=None) -> None:
        self.debug_lines.append((a, b, color))
        if len(self.debug_lines) > 4096:
            del self.debug_lines[:2048]

    def override_material(self, e: int, mesh_idx: int, name: str, v) -> None:
        self.material_overrides[(e, mesh_idx, name)] = v

    def model_source(self, e: int):
        rm = self.world.modules.get("renderer")
        if rm is None:
            return None
        slot = rm.model_instances.slot_of(e)
        if slot < 0:
            return None
        mid = int(rm.model_instances.data["model"][slot])
        mdl = rm.system.bank.models.get(mid) if hasattr(rm.system, "bank") else None
        return getattr(mdl, "name", None)

    def play_sound(self, e: int, path: str) -> None:
        am = self.world.modules.get("audio")
        if am is None:
            return
        self.module.pending_sounds.append((e, path))

    # -- input events ------------------------------------------------------------------------------------

    def event_to_lua(self, ev) -> LuaTable:
        from lumixengine_tpu_torch.engine import input as inp

        t = LuaTable()
        t.set("type", "button" if ev.type == inp.EVENT_BUTTON else
              ("axis" if ev.type == inp.EVENT_AXIS else "text"))
        dev = LuaTable()
        dev.set("type", {inp.DEVICE_KEYBOARD: "keyboard",
                         inp.DEVICE_MOUSE: "mouse"}.get(ev.device, "controller"))
        dev.set("index", float(ev.device_index))
        t.set("device", dev)
        t.set("key_id", float(ev.key_id))
        t.set("down", bool(ev.down))
        t.set("x", float(ev.x))
        t.set("y", float(ev.y))
        return t

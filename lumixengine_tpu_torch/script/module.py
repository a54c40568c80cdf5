"""Scripting module (≙ reference src/lua: Luau VM, Script + InlineScript
components, per-script env tables, update/start/input callbacks via pcall, and
the meta-generated typed API).

TPU build: Python IS the embedded scripting language — each Script component
gets an isolated environment dict; callbacks (`start`, `update(dt)`,
`on_input(event)`) run host-side in the serial update phase, exactly where the
reference runs Lua (engine update → LuaScriptModule::update). The exposed API
surface mirrors the generated Lua one: an `Entity` handle with transform
accessors + reflected component property access driven by engine/reflection.py
(≙ lua_capi.gen.h / lumix.d.lua).

Device interaction contract: scripts mutate HOST state (transforms, component
properties, controller inputs). Structural edits mark statics dirty and are
picked up at the next state snapshot/trace — scripts are the slow control
path, the fused device step is the fast path (same split as Lua vs C++ jobs in
the reference).

The port's counterpart of ``lumixengine_tpu/script/module.py``: the host
side is the same code; the device side (the compiled ``update`` groups,
``apply_pending``) works on tensors, a leading world axis standing in for
``vmap``. Prefab instantiation and the asset bank need the host tier's
importers and serializer and raise ``NotImplementedError`` (ROADMAP Queue 1
item 7).
"""
from __future__ import annotations

import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import log
from lumixengine_tpu_torch.engine import reflection
from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World


_NO_HOST_TIER = ("{what} needs the host tier's importers and serializer, which the port "
                 "does not have yet (ROADMAP Queue 1 item 7)")


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


class EntityHandle:
    """Script-facing entity wrapper (≙ the generated Lua Entity class)."""

    def __init__(self, world: World, entity: int):
        self._world = world
        self.id = entity

    # transforms
    @property
    def position(self):
        return self._world.get_global_transform(self.id)[0]

    @position.setter
    def position(self, v):
        self._world.set_global_transform(self.id, position=np.asarray(v, np.float32))

    @property
    def rotation(self):
        return self._world.get_global_transform(self.id)[1]

    @rotation.setter
    def rotation(self, v):
        self._world.set_global_transform(self.id, rotation=np.asarray(v, np.float32))

    @property
    def scale(self):
        return self._world.get_global_transform(self.id)[2]

    @scale.setter
    def scale(self, v):
        self._world.set_global_transform(self.id, scale=np.asarray(v, np.float32))

    @property
    def parent(self) -> Optional["EntityHandle"]:
        p = self._world.get_parent(self.id)
        return EntityHandle(self._world, p) if p >= 0 else None

    @parent.setter
    def parent(self, other):
        self._world.set_parent(self.id, other.id if other is not None else -1)

    @property
    def name(self) -> str:
        return self._world.get_entity_name(self.id)

    # reflected component property access: entity.get("point_light", "range")
    def get(self, ctype: str, prop: str):
        return reflection.registry.get_property(self._world, self.id, ctype, prop)

    def set(self, ctype: str, prop: str, value) -> None:
        reflection.registry.set_property(self._world, self.id, ctype, prop, value)

    def has_component(self, ctype: str) -> bool:
        return self._world.has_component(self.id, ctype)

    def create_component(self, ctype: str, **props):
        return self._world.create_component(self.id, ctype, **props)


class ScriptEnv:
    """One script instance's environment (≙ per-script Lua env table)."""

    def __init__(self, module: "ScriptModule", entity: int, source: str, name: str):
        self.entity = entity
        self.name = name
        w = module.world

        def find_entity(name):
            e = w.find_by_name(name)
            return EntityHandle(w, e) if e >= 0 else None

        def create_entity(**kw):
            return EntityHandle(w, w.create_entity(**kw))

        def instantiate_prefab(blob, position=None):
            raise NotImplementedError(_NO_HOST_TIER.format(what="instantiate_prefab"))

        self.globals: Dict[str, Any] = {
            "this": EntityHandle(w, entity),
            "world": w,
            "engine_api": module.api,
            "log_info": lambda msg: log.log_info("script", str(msg)),
            "log_error": lambda msg: log.log_error("script", str(msg)),
            "np": np,
            # ≙ lua_api.cpp world/entity surface
            "find_entity": find_entity,
            "create_entity": create_entity,
            "destroy_entity": lambda h: w.destroy_entity(
                h.id if isinstance(h, EntityHandle) else int(h)),
            "instantiate_prefab": instantiate_prefab,
            # ≙ LuaScript timers (setTimer → callback after t seconds)
            "set_timer": lambda t, fn: module.set_timer(float(t), fn),
            # ≙ getScriptEnvironment: peer script globals for cross-script calls
            "get_script_env": module.get_script_env,
            # ≙ lua input API
            "is_key_down": lambda key, device=0:
                module.system.engine.input.is_down(key, device),
            # ≙ lua physics API: raycast against the last frame's sim state
            "raycast": module.raycast_host,
        }
        self.error = None
        try:
            code = compile(source, f"<script:{name}>", "exec")
            exec(code, self.globals)  # noqa: S102 — scripts are trusted game code
        except Exception:
            self.error = traceback.format_exc()
            log.log_error("script", f"{name}: {self.error}")

    def call(self, fn_name: str, *args) -> Any:
        """pcall-style guarded call (≙ lua_script_system.cpp pcall wrappers)."""
        fn = self.globals.get(fn_name)
        if not callable(fn):
            return None
        try:
            return fn(*args)
        except Exception:
            self.error = traceback.format_exc()
            log.log_error("script", f"{self.name}.{fn_name}: {self.error}")
            return None


class LuaScriptEnv:
    """One LUA script instance: real Luau-content execution (≙ reference
    lua_script_system.cpp ScriptInstance: env table with __index → globals,
    chunk run inside the env, stored properties applied after)."""

    def __init__(self, module: "ScriptModule", entity: int,
                 path: str = "", source: Optional[str] = None):
        from lumixengine_tpu_torch.script.lua import LuaError
        from lumixengine_tpu_torch.script.lua_bridge import LuaEntity

        rt = module.lua_runtime()
        self._rt = rt
        self.entity = entity
        self.path = path
        self.name = path or f"inline:{entity}"
        self.error: Optional[str] = None
        self.env = rt.interp.new_env()
        self.env.set("this", LuaEntity(rt, entity))

        def _inherit(p=None):
            """≙ Lumix `inherit "path"`: run the base script in THIS env."""
            sp = str(p)
            src2 = module.read_lua_source(sp if sp.endswith(".lua") else sp + ".lua")
            if src2 is None:
                raise LuaError(f"inherit: script '{sp}' not found")
            rt.interp.call(rt.interp.compile(src2, chunkname=sp, env=self.env), [])

        self.env.set("inherit", _inherit)
        if source is None and path:
            source = module.read_lua_source(path)
        self.source = source or ""
        if self.source:
            self._run_chunk(rt)

    def _run_chunk(self, rt) -> None:
        from lumixengine_tpu_torch.script.lua import LuaError, LuaSyntaxError

        try:
            fn = rt.interp.compile(self.source, chunkname=self.name, env=self.env)
            rt.interp.call(fn, [])
        except (LuaError, LuaSyntaxError) as ex:
            self.error = str(ex)
            log.log_error("lua", f"{self.name}: {self.error}")

    def apply_properties(self, props: Dict[Any, Any]) -> None:
        """Stored .unv property values overwrite chunk defaults
        (≙ applyProperty after onScriptLoaded). Keys may be property NAMES or
        the serialized StableHash64 of the name — hashes resolve against the
        chunk's declared globals (XXH3, bit-exact with the reference)."""
        from lumixengine_tpu_torch.core.hash import stable_hash64

        by_hash = None
        for k, v in props.items():
            if v is None:
                continue
            if isinstance(k, int):
                if by_hash is None:
                    by_hash = {stable_hash64(str(g)): str(g)
                               for g in self.env.hash.keys()}
                name = by_hash.get(k)
                if name is None:
                    log.log_error(
                        "lua", f"{self.name}: property hash {k:#x} matches no "
                               f"declared global")
                    continue
                k = name
            self.env.set(k, v)

    def call(self, fn_name: str, *args) -> Any:
        from lumixengine_tpu_torch.script.lua import LuaError, LuaFunction

        fn = self.env.get(fn_name)
        if not isinstance(fn, LuaFunction) and not callable(fn):
            return None
        try:
            from lumixengine_tpu_torch.script.lua_bridge import ScriptRuntime  # noqa: F401
            rt = self._rt_of()
            r = rt.interp.call_value(fn, list(args))
            return r[0] if r else None
        except LuaError as ex:
            self.error = str(ex.value)
            log.log_error("lua", f"{self.name}.{fn_name}: {self.error}")
            return None
        except Exception:
            self.error = traceback.format_exc()
            log.log_error("lua", f"{self.name}.{fn_name}: {self.error}")
            return None

    def _rt_of(self):
        # env table's metatable __index is the shared interpreter's globals
        return self._rt

    _rt = None  # set by ScriptModule.attach_lua_script


class ScriptModule(IModule):
    """≙ lua_script_system.h LuaScriptModule: Script + InlineScript components."""

    name = "script"
    COMPONENT_STORES: Dict[str, str] = {}

    def __init__(self, world: World, system: "ScriptSystem", max_scripts: int = 256):
        super().__init__(world, system)
        self.scripts: Dict[int, List[ScriptEnv]] = {}
        self.lua_envs: Dict[int, List[LuaScriptEnv]] = {}
        self._lua_rt = None
        self._asset_bank = None
        self.lua_search_dirs: List[str] = []
        self.pending_sounds: List[tuple] = []
        self._started = False
        # restricted-Lua device fast path (script/lua_fastpath.py): groups of
        # compiled update() instances, rebuilt in prepare_statics
        self._fast_groups: list = []
        self._fast_envs: set = set()
        self._timers: List[tuple] = []   # (remaining_s, callback)
        # last frame's device state, set by the Runner before script update —
        # scripts query against the previous sim results like the reference's
        # Lua physics API does
        self.latest_state = None

    # -- Lua runtime (≙ the module's lua_State) --------------------------------------

    def lua_runtime(self):
        if self._lua_rt is None:
            from lumixengine_tpu_torch.script.lua_bridge import ScriptRuntime

            self._lua_rt = ScriptRuntime(self)
        return self._lua_rt

    def has_lua(self) -> bool:
        return self._lua_rt is not None and bool(self.lua_envs)

    def set_asset_bank(self, bank) -> None:
        self._asset_bank = bank

    def asset_bank(self):
        if self._asset_bank is None:
            raise NotImplementedError(_NO_HOST_TIER.format(what="the asset bank"))
        return self._asset_bank

    def read_lua_source(self, path: str) -> Optional[str]:
        """Script/module source by data-relative path (≙ FileSystem mounts)."""
        import os as _os

        for d in self.lua_search_dirs:
            p = _os.path.join(d, path)
            if _os.path.isfile(p):
                with open(p, "r", encoding="utf-8", errors="replace") as f:
                    return f.read()
        try:
            return self.system.engine.fs.read(path).decode()
        except Exception:
            return None

    def attach_lua_script(self, entity: int, path: str = "",
                          source: Optional[str] = None,
                          properties: Optional[Dict[str, Any]] = None
                          ) -> LuaScriptEnv:
        env = LuaScriptEnv(self, entity, path=path, source=source)
        env._rt = self.lua_runtime()
        if properties:
            env.apply_properties(properties)
        self.lua_envs.setdefault(entity, []).append(env)
        if self._started and env.source:
            env.call("start")
        return env

    def set_lua_script_path(self, entity: int, index: int, path: str) -> None:
        """≙ `e.lua_script.scripts[i].path = ...`: (re)load slot `index`."""
        envs = self.lua_envs.get(entity, [])
        if index >= len(envs):
            self.attach_lua_script(entity, path=path)
            return
        rt = self.lua_runtime()
        new_env = LuaScriptEnv(self, entity, path=path)
        new_env._rt = rt
        envs[index] = new_env
        if self._started:
            new_env.call("start")

    def lua_entity(self, e: int):
        from lumixengine_tpu_torch.script.lua_bridge import LuaEntity

        return LuaEntity(self.lua_runtime(), int(e))

    def lua_resource(self, path: str):
        from lumixengine_tpu_torch.script.lua_bridge import LuaResource

        return LuaResource(path)

    def apply_pending(self, state, dt: float):
        """Flush the frame's recorded script writes into the device state
        (one batch before the step; see the lua_bridge docstring). Each write
        lands in every world of a batch: index_put_/index_add_ on the slot
        axis of clones, so the state passed in is left as it was."""
        rt = self._lua_rt
        if rt is None:
            return state
        w = self.world
        dev = state.local.pos.device
        if rt.dirty_transforms and not rt.structure_dirty:
            ents = [e for e in rt.dirty_transforms
                    if 0 <= e < w.capacity and w.alive[e]]
            slots = np.asarray([w.slot(e) for e in ents], np.int64)
            ok = slots >= 0
            if ok.any():
                sl = torch.as_tensor(slots[ok], device=dev)
                sel = np.asarray(ents)[ok]
                local = state.local
                pos, rot, scale = local.pos.clone(), local.rot.clone(), local.scale.clone()
                pos[..., :, sl] = _t(w.local_pos[sel].T, dev)
                rot[..., :, sl] = _t(w.local_rot[sel].T, dev)
                scale[..., :, sl] = _t(w.local_scale[sel].T, dev)
                state = state.replace(local=local.replace(pos=pos, rot=rot, scale=scale))
            # teleport physics bodies/controllers with their entity
            # (≙ componentTransformed → PxActor::setGlobalPose)
            pm = w.modules.get("physics")
            if pm is not None:
                ms0 = state.modules.get("physics")
                ms = ms0
                for e in ents:
                    aslot = pm.actors.slot_of(e)
                    if aslot >= 0:
                        gp, gr, _ = w.get_global_transform(e)
                        p, r = ms.pos.clone(), ms.rot.clone()
                        v, av = ms.vel.clone(), ms.angvel.clone()
                        p[..., :, aslot] = _t(gp, dev)
                        r[..., :, aslot] = _t(gr, dev)
                        v[..., :, aslot] = 0.0
                        av[..., :, aslot] = 0.0
                        ms = ms.replace(pos=p, rot=r, vel=v, angvel=av)
                    cslot = pm.controllers.slot_of(e)
                    if cslot >= 0:
                        cp = ms.ctrl_pos.clone()
                        cp[..., :, cslot] = _t(w.get_global_transform(e)[0], dev)
                        ms = ms.replace(ctrl_pos=cp)
                if ms is not ms0:
                    state = state.replace(modules={**state.modules, "physics": ms})
        rt.dirty_transforms.clear()

        if rt.pending_anim_inputs:
            ms = state.modules.get("animation")
            if ms is not None:
                rows = np.asarray([k[0] for k in rt.pending_anim_inputs], np.int64)
                cols = np.asarray([k[1] for k in rt.pending_anim_inputs], np.int64)
                vals = np.asarray(list(rt.pending_anim_inputs.values()), np.float32)
                keep = rows < ms.ctrl_inputs.shape[-2]
                ci = ms.ctrl_inputs.clone()
                ci[..., torch.as_tensor(rows[keep], device=dev),
                   torch.as_tensor(cols[keep], device=dev)] = _t(vals[keep], dev)
                state = state.replace(modules={**state.modules,
                                               "animation": ms.replace(ctrl_inputs=ci)})
            rt.pending_anim_inputs.clear()

        pm = w.modules.get("physics")
        if pm is not None:
            for e, disp in rt.pending_moves.items():
                state = pm.move_controller(state, e, disp)
            rt.pending_moves.clear()
            if rt.pending_forces:
                ms = state.modules["physics"]
                vel = ms.vel.clone()
                for e, force, impulse in rt.pending_forces:
                    slot = pm.actors.slot_of(e)
                    if slot < 0:
                        continue
                    mass = max(float(pm.actors.data["mass"][slot]), 1e-6)
                    dv = np.asarray(force, np.float32) / mass
                    if not impulse:     # ≙ PxRigidBody::addForce eFORCE: F·dt/m
                        dv = dv * dt
                    idx = torch.tensor([slot], device=dev)
                    vel.index_add_(-1, idx, _t(dv, dev)[:, None].expand(
                        vel.shape[:-1] + (1,)).contiguous())
                state = state.replace(modules={**state.modules,
                                               "physics": ms.replace(vel=vel)})
                rt.pending_forces.clear()

        nm = w.modules.get("navigation")
        if nm is not None and rt.pending_nav:
            for e, dst, speed, stop in rt.pending_nav:
                slot = nm.agents.slot_of(e)
                if slot < 0:
                    continue
                nm.agents.data["speed"][slot] = np.float32(speed)
                ms = state.modules.get("navigation")
                if ms is not None:
                    sp = ms.speed.clone()
                    sp[..., slot] = float(np.float32(speed))
                    state = state.replace(modules={**state.modules,
                                                   "navigation": ms.replace(speed=sp)})
                state = nm.set_destination(state, e, (float(dst[0]), float(dst[2])))
            rt.pending_nav.clear()

        if rt.pending_pa_enabled:
            ms = state.modules.get("animation")
            if ms is not None and ms.pa_enabled.shape[-1]:
                idx = np.asarray(list(rt.pending_pa_enabled), np.int64)
                vals = np.asarray(list(rt.pending_pa_enabled.values()), bool)
                keep = idx < ms.pa_enabled.shape[-1]
                pa = ms.pa_enabled.clone()
                pa[..., torch.as_tensor(idx[keep], device=dev)] = _t(vals[keep], dev, torch.bool)
                state = state.replace(modules={**state.modules,
                                               "animation": ms.replace(pa_enabled=pa)})
            rt.pending_pa_enabled.clear()

        if rt.pending_gui_enabled:
            gs = state.modules.get("gui")
            if gs is not None:
                idx = np.asarray(list(rt.pending_gui_enabled), np.int64)
                vals = np.asarray(list(rt.pending_gui_enabled.values()), bool)
                en = gs.enabled.clone()
                en[..., torch.as_tensor(idx, device=dev)] = _t(vals, dev, torch.bool)
                state = state.replace(modules={**state.modules, "gui": gs.replace(enabled=en)})
            rt.pending_gui_enabled.clear()

        am = w.modules.get("audio")
        if am is not None and self.pending_sounds:
            for e, _path in self.pending_sounds:
                if am.sounds.slot_of(e) >= 0:
                    state = am.play(state, e)
            self.pending_sounds.clear()
        return state

    def poll_events(self, state) -> None:
        """Post-step event callbacks driven by sim results
        (≙ onPathFinished / onControllerHit pcalls)."""
        rt = self._lua_rt
        if rt is None:
            return
        for e in rt.poll_path_finished(state):
            for env in self.lua_envs.get(e, []):
                env.call("onPathFinished")

    def consume_structure_dirty(self) -> bool:
        rt = self._lua_rt
        if rt is not None and rt.structure_dirty:
            rt.structure_dirty = False
            return True
        return False

    def raycast_host(self, origin, direction, layer_mask: int = -1):
        """≙ the Lua physics raycast: → (EntityHandle, t) or None."""
        pm = self.world.modules.get("physics")
        if pm is None or self.latest_state is None:
            return None
        ms = self.latest_state.modules.get("physics")
        if ms is None:
            return None
        d = np.asarray(direction, np.float32)
        d = d / max(float(np.linalg.norm(d)), 1e-9)
        hit, t, idx = pm.raycast(ms, np.asarray(origin, np.float32), d,
                                 layer_mask=layer_mask)
        if not bool(hit):
            return None
        e = int(pm.actors.entity[int(idx)])
        return EntityHandle(self.world, e), float(t)

    def set_timer(self, t: float, fn) -> None:
        """≙ LuaScriptModule::setTimer — fire fn once after t seconds."""
        self._timers.append((t, fn))

    def get_script_env(self, entity, name: str = None):
        """≙ getScriptEnvironment: a peer entity's script globals."""
        e = entity.id if isinstance(entity, EntityHandle) else int(entity)
        for env in self.scripts.get(e, []):
            if name is None or env.name == name:
                return env.globals
        return None

    def component_types(self):
        return ["script", "inline_script"]

    def create_component(self, entity: int, ctype: str, **props):
        if ctype in ("script", "inline_script"):
            src = props.get("source")
            if src is None and "path" in props:
                src = self.system.engine.fs.read(props["path"]).decode()
            env = ScriptEnv(self, entity, src or "", props.get("name", f"script{entity}"))
            self.scripts.setdefault(entity, []).append(env)
            if self._started:
                env.call("start")
            return env
        raise KeyError(ctype)

    def destroy_component(self, entity: int, ctype: str) -> None:
        self.scripts.pop(entity, None)
        self.lua_envs.pop(entity, None)

    @property
    def api(self) -> Dict[str, Any]:
        return self.system.api

    # -- restricted-Lua device fast path (script/lua_fastpath.py) -----------------

    def prepare_statics(self, device=None) -> None:
        """Compile eligible update() bodies and group identical sources for
        vectorized execution. Only after start() ran — chunk locals (the
        state vector) must hold their post-start values."""
        self._fast_groups = []
        self._fast_envs = set()
        if not self._started or not self.lua_envs:
            return
        from lumixengine_tpu_torch.script import lua_fastpath as FP

        groups: Dict[tuple, FP.FastUpdate] = {}
        for envs in self.lua_envs.values():
            for env in envs:
                fu = FP.try_compile(env, self.world)
                if fu is None:
                    continue
                key = (fu.source_key, tuple(fu.layout))
                if key in groups:
                    g = groups[key]
                    g.entities.extend(fu.entities)
                    g.init_rows.extend(fu.init_rows)
                    g.envs.extend(fu.envs)
                else:
                    groups[key] = fu
                self._fast_envs.add(id(env))
        self._fast_groups = list(groups.values())
        for g in self._fast_groups:
            g.slots = self.world.to_slots(np.asarray(g.entities, np.int64))
            if device is not None:
                g.slot_index(device)

    def device_state(self, device):
        """{"fast": {group: rows [NI, K]}, "fast0": {group: [NI, 0]}} on
        `device` (groups with no state in fast0), or None without groups."""
        if not self._fast_groups:
            return None
        return {"fast": {str(i): torch.as_tensor(np.stack(g.init_rows), device=device)
                         for i, g in enumerate(self._fast_groups) if g.nslots > 0},
                "fast0": {str(i): torch.zeros((len(g.entities), 0), device=device)
                          for i, g in enumerate(self._fast_groups) if g.nslots == 0}}

    def update(self, state, dt):
        """Device phase: every compiled script instance of every world, one
        evaluation per group — ≙ the reference's per-instance update pcall
        loop (lua_script_system.cpp:1661-1684), moved onto the device for
        the restricted subset."""
        if not self._fast_groups:
            return state
        ss = state.modules[self.name]
        pos_all = state.local.pos
        new_fast = dict(ss["fast"])
        for i, g in enumerate(self._fast_groups):
            rows = ss["fast"][str(i)] if g.nslots > 0 else ss["fast0"][str(i)]
            sl = g.slot_index(pos_all.device)
            nrows, npos = g.fn(rows, pos_all.index_select(-1, sl), dt)
            pos_all = pos_all.index_copy(-1, sl, npos)
            if g.nslots > 0:
                new_fast[str(i)] = nrows
        state = state.replace(local=state.local.replace(pos=pos_all))
        return state.replace(modules={**state.modules, self.name: {**ss, "fast": new_fast}})

    def load_state(self, module_state) -> None:
        """Device rows → Lua chunk scopes so host reads (save, editor
        property grid) see the fast path's current values."""
        if not self._fast_groups or module_state is None:
            return
        from lumixengine_tpu_torch.script import lua_fastpath as FP

        for i, g in enumerate(self._fast_groups):
            if g.nslots == 0:
                continue
            rows = module_state["fast"][str(i)].detach().cpu().numpy()
            if rows.ndim == 3:      # world batch: world 0 is the canonical
                rows = rows[0]
            for env, row in zip(g.envs, rows):
                FP.write_back(env, g.layout, row)

    # -- lifecycle / frame hooks (host side) --------------------------------------

    def start_game(self) -> None:
        self._started = True
        for envs in self.scripts.values():
            for env in envs:
                env.call("start")
        for envs in list(self.lua_envs.values()):
            for env in list(envs):
                env.call("start")

    def stop_game(self) -> None:
        self._started = False
        for envs in self.scripts.values():
            for env in envs:
                env.call("stop")
        for envs in self.lua_envs.values():
            for env in envs:
                env.call("onDestroy")

    def update_host(self, dt: float) -> None:
        """Called by the app runner each frame BEFORE the device step
        (≙ LuaScriptModule::update pcall loop — scripting is host work)."""
        if self._timers:
            due, keep = [], []
            for t, fn in self._timers:
                (due if t - dt <= 0.0 else keep).append((t - dt, fn))
            self._timers = keep
            for _, fn in due:
                try:
                    fn()
                except Exception:
                    log.log_error("script", f"timer: {traceback.format_exc()}")
        for envs in self.scripts.values():
            for env in envs:
                env.call("update", dt)
        for envs in list(self.lua_envs.values()):
            for env in list(envs):
                if id(env) in self._fast_envs:
                    continue     # compiled: runs inside the device step
                env.call("update", float(dt))

    def on_input(self, event) -> None:
        for envs in self.scripts.values():
            for env in envs:
                env.call("on_input", event)
        if self._lua_rt is not None and self.lua_envs:
            lua_ev = self._lua_rt.event_to_lua(event)
            for envs in list(self.lua_envs.values()):
                for env in list(envs):
                    env.call("onInputEvent", lua_ev)

    def serialize_components(self):
        out = []
        for e, envs in self.scripts.items():
            for env in envs:
                src = env.globals.get("__source__", None)
                out.append({"type": "inline_script", "entity": e,
                            "props": {"source": src or "", "name": env.name}})
        return out


class ScriptSystem(ISystem):
    name = "script_system"

    def __init__(self, engine):
        super().__init__(engine)
        # functions exposed to scripts (≙ the meta-generated Lua C API)
        self.api: Dict[str, Callable] = {}

    def expose(self, name: str, fn: Callable) -> None:
        self.api[name] = fn

    def create_modules(self, world: World) -> ScriptModule:
        return ScriptModule(world, self)


# -- module-scoped reflection (≙ the reference's reflected LuaScriptModule
# functions that CoreModule signals can target, core.cpp:120-138) -------------

def _signal_call(module, entity: int) -> None:
    """Reflected module function "call": invoke ``onSignal()`` in every
    script attached to the target entity — this engine's convention for
    signal-driven script entry points."""
    if module is None:
        return
    for env in module.lua_envs.get(entity, []):
        env.call("onSignal")
    for env in module.scripts.get(entity, []):
        env.call("onSignal")


reflection.registry.module("script").func("call", _signal_call)

"""Reflection registry (≙ reference engine/reflection.{h,cpp} + the meta tool).

The reference builds a runtime registry from meta-generated code: modules →
components → properties (with attributes: min/max/radians/resource_type/
dynamic enums), functions and events; consumed by the editor property grid,
serialization and the generated Lua API (docs/meta.md).

Python needs no code generation — modules register their component schemas
directly at import time with the same information model. The registry drives:
  * generic get/set of component properties by name (property grid analog)
  * world serialization of component data (engine/serialize.py)
  * the scripting API surface (script/module.py)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class PropertyDef:
    """≙ reflection.h Property<T> + attributes."""

    name: str
    type: str                      # "float" | "int" | "bool" | "vec3" | "quat" | "string" | "entity" | "resource"
    default: Any = None
    min: Optional[float] = None
    max: Optional[float] = None
    radians: bool = False
    resource_type: Optional[str] = None
    getter: Optional[Callable] = None   # (module, entity) -> value
    setter: Optional[Callable] = None   # (module, entity, value) -> None


@dataclass
class FunctionDef:
    """≙ reflection.h functions — callable from scripts/editor."""

    name: str
    fn: Callable
    doc: str = ""


@dataclass
class EventDef:
    """≙ reflection.h events — connected to functions by CoreModule signals."""

    name: str


@dataclass
class ComponentDef:
    name: str
    label: str = ""
    icon: str = ""
    properties: Dict[str, PropertyDef] = field(default_factory=dict)
    functions: Dict[str, FunctionDef] = field(default_factory=dict)
    events: Dict[str, EventDef] = field(default_factory=dict)


@dataclass
class ModuleDef:
    name: str
    components: Dict[str, ComponentDef] = field(default_factory=dict)
    functions: Dict[str, FunctionDef] = field(default_factory=dict)
    # module-scoped events (≙ the reference's `//@ events` on IModule
    # interfaces, e.g. gui_module.h:153-159 buttonClicked/rectHovered —
    # CoreModule signals connect these, core.cpp:120-138)
    events: Dict[str, EventDef] = field(default_factory=dict)


class Registry:
    """Global reflection registry (≙ reflection.cpp getModules())."""

    def __init__(self):
        self.modules: Dict[str, ModuleDef] = {}

    def module(self, name: str) -> "ModuleBuilder":
        return ModuleBuilder(self, name)

    def get_module(self, name: str) -> Optional[ModuleDef]:
        return self.modules.get(name)

    def component(self, ctype: str) -> Optional[ComponentDef]:
        for m in self.modules.values():
            if ctype in m.components:
                return m.components[ctype]
        return None

    def module_of_component(self, ctype: str) -> Optional[str]:
        for m in self.modules.values():
            if ctype in m.components:
                return m.name
        return None

    def all_components(self) -> List[str]:
        out = []
        for m in self.modules.values():
            out.extend(m.components.keys())
        return out

    # --- signal-scope resolution (≙ reference module-scoped reflection) -----
    # .unv signals store reflection-MODULE names (core.cpp serializes the
    # module each end lives in); this registry also keys by component, so a
    # scope can legally be either. Resolution order: exact module match
    # (module event / module function, then its components), then component.

    def find_event(self, scope: str, name: str) -> Optional[str]:
        """Resolve (scope, event) → canonical scope string, or None.
        `scope` may be a module name or a component name."""
        m = self.modules.get(scope)
        if m is not None:
            if name in m.events:
                return scope
            for cname, cd in m.components.items():
                if name in cd.events:
                    return cname
        cd = self.component(scope)
        if cd is not None and name in cd.events:
            return scope
        return None

    def all_events(self) -> List[tuple]:
        """Every (scope, event) pair — module- and component-scoped
        (≙ signal_editor.cpp's Event combo walking every module)."""
        out = []
        for mn, m in self.modules.items():
            out.extend((mn, en) for en in m.events)
            for cn, cd in m.components.items():
                out.extend((cn, en) for en in cd.events)
        return out

    def all_functions(self) -> List[tuple]:
        """Every (scope, function) pair (≙ the Function combo's
        module::fn list)."""
        out = []
        for mn, m in self.modules.items():
            out.extend((mn, fn) for fn in m.functions)
            for cn, cd in m.components.items():
                out.extend((cn, fn) for fn in cd.functions)
        return out

    def find_function(self, scope: str, name: str):
        """Resolve (scope, function) → (FunctionDef, module_name) or None."""
        m = self.modules.get(scope)
        if m is not None:
            if name in m.functions:
                return m.functions[name], scope
            for cname, cd in m.components.items():
                if name in cd.functions:
                    return cd.functions[name], scope
        cd = self.component(scope)
        if cd is not None and name in cd.functions:
            return cd.functions[name], self.module_of_component(scope)
        return None

    # --- generic property access (property-grid path) --------------------------

    def get_property(self, world, entity: int, ctype: str, prop: str):
        cd = self.component(ctype)
        p = cd.properties[prop]
        mname = self.module_of_component(ctype)
        module = world.modules[mname]
        if p.getter:
            return p.getter(module, entity)
        return _default_get(module, entity, ctype, prop)

    def set_property(self, world, entity: int, ctype: str, prop: str, value) -> None:
        cd = self.component(ctype)
        p = cd.properties[prop]
        if p.min is not None:
            value = max(p.min, value)
        if p.max is not None:
            value = min(p.max, value)
        mname = self.module_of_component(ctype)
        module = world.modules[mname]
        if p.setter:
            p.setter(module, entity, value)
        else:
            _default_set(module, entity, ctype, prop, value)


def _find_store(module, ctype: str):
    """Default convention: modules expose DenseStores named after components."""
    mapping = getattr(module, "COMPONENT_STORES", None)
    if mapping and ctype in mapping:
        return getattr(module, mapping[ctype])
    return None


def _default_get(module, entity, ctype, prop):
    store = _find_store(module, ctype)
    if store is None:
        raise KeyError(f"no store for {ctype}")
    return store.get(entity, prop)


def _default_set(module, entity, ctype, prop, value):
    store = _find_store(module, ctype)
    if store is None:
        raise KeyError(f"no store for {ctype}")
    store.set(entity, prop, value)
    if hasattr(module, "invalidate_statics"):
        module.invalidate_statics()


class ModuleBuilder:
    """Fluent registration DSL (≙ reflection.h build_module builder)."""

    def __init__(self, registry: Registry, name: str):
        self.registry = registry
        self.mdef = registry.modules.setdefault(name, ModuleDef(name))
        self._cd: Optional[ComponentDef] = None

    def cmp(self, name: str, label: str = "", icon: str = "") -> "ModuleBuilder":
        self._cd = self.mdef.components.setdefault(name, ComponentDef(name, label or name, icon))
        return self

    def prop(self, name: str, type: str = "float", **kw) -> "ModuleBuilder":
        assert self._cd is not None
        self._cd.properties[name] = PropertyDef(name=name, type=type, **kw)
        return self

    def func(self, name: str, fn: Callable, doc: str = "") -> "ModuleBuilder":
        target = self._cd.functions if self._cd is not None else self.mdef.functions
        target[name] = FunctionDef(name, fn, doc)
        return self

    def event(self, name: str) -> "ModuleBuilder":
        """Component-scoped if a component is active, else module-scoped
        (≙ the reference's `//@ events` blocks on IModule interfaces)."""
        target = self._cd.events if self._cd is not None else self.mdef.events
        target[name] = EventDef(name)
        return self


# the global registry (≙ the reference's single reflection namespace)
registry = Registry()


def register_builtin_components() -> None:
    """Register schemas for the built-in modules (idempotent)."""
    if registry.get_module("renderer") and registry.get_module("physics"):
        return
    (registry.module("renderer")
        .cmp("model_instance", "Model Instance", "mesh")
        .prop("model", "resource", resource_type="model")
        .cmp("camera", "Camera", "camera")
        .prop("fov", "float", min=0.01, max=3.1, radians=True)
        .prop("near", "float", min=1e-4)
        .prop("far", "float", min=1e-3)
        .prop("aspect", "float", min=1e-3)
        .prop("ortho_size", "float", min=1e-3)
        .prop("is_ortho", "bool")
        .cmp("point_light", "Point Light", "light")
        .prop("color", "vec3")
        .prop("intensity", "float", min=0.0)
        .prop("range", "float", min=0.0)
        .prop("fov", "float", min=0.0, max=6.2831855, radians=True)
        .prop("attenuation", "float", min=0.0)
        .cmp("environment", "Environment", "sun")
        .prop("color", "vec3")
        .prop("intensity", "float", min=0.0)
        .cmp("particle_emitter", "Particle Emitter", "sparkle")
        .prop("script", "resource", resource_type="particle_script"))
    (registry.module("animation")
        .cmp("animable", "Animable", "clip")
        .prop("clip", "resource", resource_type="animation")
        .prop("time_scale", "float", min=0.0)
        .prop("start_time", "float", min=0.0)
        .cmp("animator", "Animator", "graph")
        .prop("controller", "resource", resource_type="anim_controller")
        .cmp("property_animator", "Property Animator"))
    (registry.module("physics")
        .cmp("rigid_actor", "Rigid Actor", "box")
        .prop("motion", "int")
        .prop("shape", "int")
        .prop("radius", "float", min=0.0)
        .prop("half_extents", "vec3")
        .prop("mass", "float", min=1e-6)
        .prop("friction", "float", min=0.0, max=2.0)
        .prop("restitution", "float", min=0.0, max=1.0)
        .prop("layer", "int", min=0, max=31)
        .cmp("distance_joint", "Distance Joint", "link")
        .prop("length", "float", min=0.0))
    def _sig_get(key):
        return lambda module, e: module.signals[e][key]

    def _sig_set(key):
        def s(module, e, v):
            module.signals[e][key] = int(v) if key == "target_entity" \
                else str(v)
        return s

    def _sig_prop(b, key, type_="string"):
        return b.prop(key, type_, getter=_sig_get(key), setter=_sig_set(key))

    b = (registry.module("core")
        .cmp("spline", "Spline")
        .cmp("signal", "Signal"))
    # signal connection fields surface in the property grid (≙ the
    # reference's SignalEditor property-grid plugin, signal_editor.cpp:1-73)
    for key in ("event_component", "event", "function_component",
                "function"):
        _sig_prop(b, key)
    _sig_prop(b, "target_entity", "entity")
    # module-scoped gui events (≙ gui_module.h:153-159 `//@ events`):
    # .unv signals reference these by module name ("gui")
    (registry.module("gui")
        .event("buttonClicked")
        .event("rectHovered")
        .event("rectHoveredOut")
        .event("rectMouseDown")
        .event("mousedButtonUnhandled"))

"""Plugin framework (counterpart of ``lumixengine_tpu/engine/plugin.py``):
one ``ISystem`` per app, one ``IModule`` per World. A module's phases are
functions ``WorldState -> WorldState`` on tensors; its state lives in
``state.modules[self.name]``."""
from __future__ import annotations

from typing import Any, List, Optional

from lumixengine_tpu_torch.engine.world import World, WorldState


class IModule:
    name: str = "module"

    def __init__(self, world: World, system: "ISystem"):
        self.world = world
        self.system = system

    def component_types(self) -> List[str]:
        return []

    def create_component(self, entity: int, ctype: str, **props) -> Any:
        raise NotImplementedError

    def device_state(self, device) -> Any:
        """Module's slice of WorldState.modules on `device`."""
        return ()

    def prepare_statics(self, device) -> None:
        """Host hook called by Engine.build_step: build the module's static
        index tensors on `device` once, before the first frame."""

    def end_frame(self, state: WorldState, dt) -> WorldState:
        return state

    def update_parallel(self, state: WorldState, dt) -> WorldState:
        return state

    def update(self, state: WorldState, dt) -> WorldState:
        return state

    def late_update(self, state: WorldState, dt) -> WorldState:
        return state


class ISystem:
    name: str = "system"

    def __init__(self, engine):
        self.engine = engine

    def create_modules(self, world: World) -> Optional[IModule]:
        return None


class SystemManager:
    def __init__(self, engine):
        self.engine = engine
        self.systems: List[ISystem] = []

    def add_system(self, system: ISystem) -> ISystem:
        self.systems.append(system)
        return system

    def get_system(self, name: str) -> Optional[ISystem]:
        for s in self.systems:
            if s.name == name:
                return s
        return None

    def create_all_modules(self, world: World) -> None:
        for s in self.systems:
            module = s.create_modules(world)
            if module is not None:
                world.modules[module.name] = module
                for ctype in module.component_types():
                    world.register_component_type(ctype, module)

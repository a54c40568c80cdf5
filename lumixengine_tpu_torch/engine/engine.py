"""Engine — owns systems, creates Worlds, composes the frame step
(counterpart of ``lumixengine_tpu/engine/engine.py``).

The step runs the modules' phases in the reference's order: end_frame →
update_parallel → update → late_update → hierarchy propagation → ``extra``
(e.g. the cull pass) → frame + 1, time + dt. It is an eager callable over
tensors on the device given to ``build_step``; a leading world-batch axis on
the state takes the place of ``vmap``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import debug, profiler
from lumixengine_tpu_torch.engine.phase_profile import PHASES, _phase_overridden
from lumixengine_tpu_torch.engine.plugin import SystemManager
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.ops import hierarchy as hier


class TimeSmoother:
    """Trimmed-mean dt smoothing over the last 11 frames (drop 2 lowest + 2
    highest, average the rest)."""

    WINDOW = 11
    TRIM = 2

    def __init__(self):
        self._samples: list = []

    def push(self, dt: float) -> float:
        self._samples.append(float(dt))
        if len(self._samples) > self.WINDOW:
            self._samples.pop(0)
        s = sorted(self._samples)
        if len(s) > 2 * self.TRIM + 1:
            s = s[self.TRIM: -self.TRIM]
        return float(np.mean(s))


def _extra_span(extra) -> str:
    """The extra pass's span: its module's name and its method for a bound
    method of a module (``renderer.cull_pass``), else ``extra.<name>``."""
    owner = getattr(getattr(extra, "__self__", None), "name", None)
    name = getattr(extra, "__name__", "pass")
    return f"{owner}.{name}" if isinstance(owner, str) else f"extra.{name}"


class Engine:
    """Owns the systems and the host services (file system, input), creates
    Worlds and composes the frame step."""

    def __init__(self, time_multiplier: float = 1.0, base_path: str = "."):
        from lumixengine_tpu_torch.engine.file_system import FileSystem
        from lumixengine_tpu_torch.engine.input import InputSystem
        from lumixengine_tpu_torch.engine.resource import ResourceManagerHub

        self.system_manager = SystemManager(self)
        self.time_multiplier = float(time_multiplier)
        self.module_capacities: dict = {}
        self.paused = False
        self._next_frame_paused = False
        self._smoother = TimeSmoother()
        self.game_running = False
        self.fs = FileSystem(base_path)
        self.resources = ResourceManagerHub(self.fs)
        self.input = InputSystem()

    def add_system(self, system):
        return self.system_manager.add_system(system)

    def init_systems(self) -> None:
        for s in self.system_manager.systems:
            s.init()

    def create_world(self, capacity: int = 4096) -> World:
        w = World(capacity=capacity)
        self.system_manager.create_all_modules(w)
        return w

    def start_game(self, world: World) -> None:
        self.game_running = True
        for m in world.modules.values():
            m.start_game()
        for s in self.system_manager.systems:
            s.start_game()

    def stop_game(self, world: World) -> None:
        self.game_running = False
        for m in world.modules.values():
            m.stop_game()
        for s in self.system_manager.systems:
            s.stop_game()

    def pause(self, paused: bool) -> None:
        self.paused = paused

    def next_frame(self) -> None:
        """Single-step while paused."""
        self._next_frame_paused = True

    def update_host(self, dt_raw: float) -> float:
        """Host side of the frame: dt smoothing (0 while paused, unless one
        frame was asked for), the systems' host updates, the input drain, the
        file system's callbacks and, when one is attached, the asset
        compiler's watch (a changed source recompiles). Returns the dt to
        feed the step."""
        if self.paused and not self._next_frame_paused:
            dt = 0.0
        else:
            dt = self._smoother.push(dt_raw * self.time_multiplier)
        self._next_frame_paused = False
        self.system_manager.update(dt)
        self.input.update()
        self.fs.process_callbacks()
        ac = getattr(self, "asset_compiler", None)
        if ac is not None:
            ac.poll()
        return dt

    def build_step(
        self,
        world: World,
        device,
        extra: Optional[Callable[[WorldState, torch.Tensor], WorldState]] = None,
    ) -> Callable[[WorldState, float], WorldState]:
        """Compose the modules' phases into step(state, dt) -> state, with
        every static index tensor built once on `device`.

        The step records ``core/profiler`` blocks: ``engine.frame`` around
        the whole frame, ``<module>.<phase>`` around each phase a module
        overrides (decided here, once), ``hierarchy.propagate`` and the extra
        pass's span, named from the callable (``renderer.cull_pass``)."""
        device = torch.device(device)
        modules = list(world.modules.values())
        for m in modules:
            m.prepare_statics(device)
        plan = world.plan
        plan.parent_index(device)
        # per phase, each module's span name; None where IModule's default runs
        spans = {p: [f"{m.name}.{p}" if _phase_overridden(m, p) else None for m in modules]
                 for p in PHASES}
        extra_span = _extra_span(extra)

        def step(state: WorldState, dt) -> WorldState:
            with profiler.block("engine.frame"):
                dt = torch.as_tensor(dt, dtype=torch.float32, device=device)
                for phase in PHASES:
                    for m, span in zip(modules, spans[phase]):
                        if span is None:
                            state = getattr(m, phase)(state, dt)
                            continue
                        with profiler.block(span):
                            state = getattr(m, phase)(state, dt)
                with profiler.block("hierarchy.propagate"):
                    state = state.replace(world=hier.propagate_plan(state.local, plan))
                if extra is not None:
                    with profiler.block(extra_span):
                        state = extra(state, dt)
                state = state.replace(frame=state.frame + 1, time=state.time + dt)
                if debug.floating_point_traps_enabled():
                    debug.check_floating_point(state)
            return state

        return step

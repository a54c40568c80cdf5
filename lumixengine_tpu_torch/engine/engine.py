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


class Engine:
    def __init__(self, time_multiplier: float = 1.0):
        self.system_manager = SystemManager(self)
        self.time_multiplier = float(time_multiplier)
        self.module_capacities: dict = {}
        self._smoother = TimeSmoother()

    def add_system(self, system):
        return self.system_manager.add_system(system)

    def create_world(self, capacity: int = 4096) -> World:
        w = World(capacity=capacity)
        self.system_manager.create_all_modules(w)
        return w

    def update_host(self, dt_raw: float) -> float:
        """Host side of the frame: the smoothed dt to feed the step."""
        return self._smoother.push(dt_raw * self.time_multiplier)

    def build_step(
        self,
        world: World,
        device,
        extra: Optional[Callable[[WorldState, torch.Tensor], WorldState]] = None,
    ) -> Callable[[WorldState, float], WorldState]:
        """Compose the modules' phases into step(state, dt) -> state, with
        every static index tensor built once on `device`."""
        device = torch.device(device)
        modules = list(world.modules.values())
        for m in modules:
            m.prepare_statics(device)
        plan = world.plan
        plan.parent_index(device)

        def step(state: WorldState, dt) -> WorldState:
            dt = torch.as_tensor(dt, dtype=torch.float32, device=device)
            for m in modules:
                state = m.end_frame(state, dt)
            for m in modules:
                state = m.update_parallel(state, dt)
            for m in modules:
                state = m.update(state, dt)
            for m in modules:
                state = m.late_update(state, dt)
            state = state.replace(world=hier.propagate_plan(state.local, plan))
            if extra is not None:
                state = extra(state, dt)
            return state.replace(frame=state.frame + 1, time=state.time + dt)

        return step

"""World batches (counterpart of ``replicate_state`` in
``lumixengine_tpu/parallel/mesh.py``). A batch of worlds is one scene
replicated along a leading axis, with optional per-world perturbations so
that the worlds diverge."""
from __future__ import annotations

from typing import Optional

import torch

from lumixengine_tpu_torch.engine.world import WorldState, map_tensors


def replicate_state(state: WorldState, num_worlds: int,
                    generator: Optional[torch.Generator] = None) -> WorldState:
    """Tile a single-world state into [num_worlds, ...]. With a generator the
    worlds diverge as in the reference: local positions get N(0, 0.01²)
    noise, physics velocities and angular velocities N(0, 0.05²) noise, and
    the sleep counters a random forward stagger in [0, 16). The noise is
    drawn on the generator's device."""
    def tile(t):
        # uint32 (the particle key) is tiled through an int32 view: torch has
        # few uint32 kernels
        u = t.view(torch.int32) if t.dtype == torch.uint32 else t
        out = u.unsqueeze(0).expand((num_worlds,) + t.shape).clone()
        return out.view(torch.uint32) if t.dtype == torch.uint32 else out

    batched = map_tensors(tile, state)
    if generator is None:
        return batched
    dev = state.local.pos.device

    def randn(shape):
        return torch.randn(shape, generator=generator, device=generator.device).to(dev)

    pos = batched.local.pos
    batched = batched.replace(local=batched.local.replace(pos=pos + randn(pos.shape) * 0.01))
    pm = batched.modules.get("physics")
    if pm is not None:
        stag = torch.randint(0, 16, pm.sleep.shape, generator=generator,
                             device=generator.device).to(device=dev, dtype=pm.sleep.dtype)
        pm = pm.replace(vel=pm.vel + randn(pm.vel.shape) * 0.05,
                        angvel=pm.angvel + randn(pm.angvel.shape) * 0.05,
                        sleep=torch.maximum(pm.sleep, stag))
        batched = batched.replace(modules={**batched.modules, "physics": pm})
    return batched

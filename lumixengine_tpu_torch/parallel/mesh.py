"""World batches and their sharding over devices (counterpart of
``lumixengine_tpu/parallel/mesh.py``).

A batch of worlds is one scene replicated along a leading axis, with
optional per-world perturbations so that the worlds diverge. Worlds are
embarrassingly parallel (one World = one independent game), so a batch is
spread over devices as pure data parallelism over the world axis: each
device steps its own contiguous shard of worlds, and the only cross-device
value is the summed global metric (``visible_total``).

A mesh is an ordered list of ``torch.device``s. An entry may repeat: several
shards then step one after another on one device (on the CPU, n copies of
``cpu`` stand in for XLA's forced host devices; on one card, the card
repeated).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from lumixengine_tpu_torch.engine.world import WorldState, map_tensors

# the name of the world axis (the reference's mesh axis; here it names the
# batch's leading axis, which a mesh shards)
WORLD_AXIS = "worlds"


def make_world_mesh(n_devices: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> List[torch.device]:
    """The mesh over `devices`, else over this host's CUDA devices (the
    first `n_devices` of them)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("no CUDA device: pass the mesh's devices")
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"need {n_devices} devices, this host has {len(devices)}")
            devices = devices[:n_devices]
    return [torch.device(d) for d in devices]


def shard_world_batch(batched_state: WorldState, mesh: Sequence[torch.device]) -> List[WorldState]:
    """Split a world-batched state [W, ...] into len(mesh) equal contiguous
    shards along W, shard i on mesh[i]."""
    n = len(mesh)
    w = batched_state.local.pos.shape[0]
    if w % n:
        raise ValueError(f"{w} worlds do not split into {n} equal shards")
    k = w // n
    return [map_tensors(lambda t, i=i, d=d: t[i * k:(i + 1) * k].to(d), batched_state)
            for i, d in enumerate(mesh)]


def build_sharded_step(
    make_step: Callable[[torch.device], Callable],
    mesh: Sequence[torch.device],
    donate: bool = True,
    with_metrics: bool = False,
):
    """Lift the batched ``step(state, dt) -> state`` to a sharded step over
    the mesh: ``make_step(device)`` builds the step on a device (for
    example ``lambda d: engine.build_step(world, d, extra=...)``), once per
    distinct device, and shard i steps on mesh[i]. The sharded step takes
    and returns a list of shards. When ``donate``, each input shard is
    released from the list as it steps (read none of them afterwards, as
    with XLA's donation). When ``with_metrics``, it also returns
    ``{"visible_total": int32 tensor on mesh[0]}``, the visible renderables
    summed over every world of every shard."""
    mesh = [torch.device(d) for d in mesh]
    steps = {}
    for d in mesh:
        if str(d) not in steps:
            steps[str(d)] = make_step(d)

    def step(shards: List[WorldState], dt):
        if len(shards) != len(mesh):
            raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh)}")
        outs = []
        for i, d in enumerate(mesh):
            dt_d = torch.as_tensor(dt, dtype=torch.float32).to(d)
            outs.append(steps[str(d)](shards[i], dt_d))
            if donate:
                shards[i] = None
        if not with_metrics:
            return outs
        total = torch.zeros((), dtype=torch.int32, device=mesh[0])
        for out in outs:
            vis = out.modules.get("renderer")
            if vis is not None:
                total = total + vis.counters["visible_count"].sum(dtype=torch.int32).to(mesh[0])
        return outs, {"visible_total": total}

    return step


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

"""State carried across between the JAX reference and this port, as numpy.

A WorldState is flattened to dotted names — ``alive``, ``local.pos``,
``modules.renderer.mi_visible``, ``modules.physics.pair_key``,
``modules.renderer.counters.visible_count``,
``modules.renderer.particles.pe2.storm.channels``, ``modules.animation.palette``,
``frame``, ``time`` — the names the reference's fields have. Arrays may be
single worlds or batches ``[W, ...]``.

Every field of the reference's state has its counterpart here, the
character controllers' ``ctrl_*`` and the vehicles' ``veh_*`` included, so
``SKIPPED`` (reference fields outside the port, each with its reason) is
empty; ``state_from_numpy`` drops exactly those it lists and raises on any
other name it does not know.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from lumixengine_tpu_torch.animation.module import AnimState
from lumixengine_tpu_torch.core.transform import Transform
from lumixengine_tpu_torch.engine.world import WorldState
from lumixengine_tpu_torch.physics.module import PhysicsState
from lumixengine_tpu_torch.renderer.culling_system import CullingState
from lumixengine_tpu_torch.renderer.particle_system import EmitterState
from lumixengine_tpu_torch.renderer.render_module import RenderState

# reference fields outside the port: (name prefix, why)
SKIPPED: tuple = ()


def is_skipped(name: str) -> bool:
    return any(name.startswith(prefix) for prefix, _ in SKIPPED)


def _flatten(prefix: str, x, out: Dict[str, np.ndarray]) -> None:
    if isinstance(x, torch.Tensor):
        out[prefix] = x.detach().cpu().numpy()
    elif isinstance(x, dict):
        for k, v in x.items():
            _flatten(f"{prefix}.{k}", v, out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _flatten(f"{prefix}.{f.name}" if prefix else f.name, getattr(x, f.name), out)
    else:
        raise TypeError(f"{prefix}: cannot flatten {type(x).__name__}")


def state_to_numpy(state: WorldState) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _flatten("", state, out)
    return out


def state_from_numpy(tree: Dict[str, np.ndarray], device) -> WorldState:
    """Build a WorldState on `device` from dotted-name numpy arrays."""
    used = set()

    def get(name):
        used.add(name)
        return torch.tensor(np.asarray(tree[name]), device=device)

    def xf(prefix):
        return Transform(pos=get(prefix + ".pos"), rot=get(prefix + ".rot"),
                         scale=get(prefix + ".scale"))

    def fields_of(cls, prefix, special=()):
        return {f.name: get(f"{prefix}.{f.name}") for f in dataclasses.fields(cls)
                if f.name not in special}

    def counters(prefix, names):
        return {n: get(f"{prefix}.counters.{n}") for n in names}

    def particles(prefix):
        """{component key: {emitter: EmitterState}} from `prefix`.key.emitter.field."""
        groups = sorted({tuple(k[len(prefix) + 1:].split(".")[:2]) for k in tree
                         if k.startswith(prefix + ".")})
        out: Dict[str, Dict[str, EmitterState]] = {}
        for pkey, emitter in groups:
            out.setdefault(pkey, {})[emitter] = EmitterState(
                **fields_of(EmitterState, f"{prefix}.{pkey}.{emitter}"))
        return out

    modules = {}
    if any(k.startswith("modules.renderer.") for k in tree):
        p = "modules.renderer"
        modules["renderer"] = RenderState(
            culling=CullingState(entity=get(p + ".culling.entity"),
                                 radius=get(p + ".culling.radius")),
            particles=particles(p + ".particles"),
            counters=counters(p, ("visible_count", "lights_visible", "particles_alive",
                                  "particles_emitted", "particles_killed")),
            **fields_of(RenderState, p, ("culling", "particles", "counters")))
    if any(k.startswith("modules.animation.") for k in tree):
        p = "modules.animation"
        modules["animation"] = AnimState(counters=counters(p, ("animated",)),
                                         **fields_of(AnimState, p, ("counters",)))
    if any(k.startswith("modules.physics.") for k in tree):
        p = "modules.physics"
        modules["physics"] = PhysicsState(
            counters=counters(p, ("active_contacts", "sap_window_miss", "pruned_pair_miss")),
            **fields_of(PhysicsState, p, ("counters",)))
    state = WorldState(alive=get("alive"), parent=get("parent"), level=get("level"),
                       local=xf("local"), world=xf("world"), modules=modules,
                       frame=get("frame"), time=get("time"))
    unknown = sorted(k for k in tree if k not in used and not is_skipped(k))
    if unknown:
        raise KeyError(f"fields the port does not know: {unknown}")
    return state

"""Particle system runtime (counterpart of
``lumixengine_tpu/renderer/particle_system.py``).

Channels are fixed-capacity SoA rows ``[..., R, cap]`` with an alive mask
(a leading world batch where the state has one). Dead slots are refilled by
prefix-sum ranking: the timed emission (emit-per-second accumulator) first,
then the routed cross-emitter spawns, whose requests are compacted by a
stable argsort and bounded by the target's capacity; overflow is counted.
The compiled script (``particle_compiler.py``) provides the update, emit
and output programs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from lumixengine_tpu_torch.core import random as prng
from lumixengine_tpu_torch.renderer.particle_compiler import (
    CompiledEmitter, EmitStmt, If, Vec, compile_source,
)


@dataclass
class EmitterState:
    channels: torch.Tensor   # f32 [R, cap] var channels (R = packed rows)
    outs: torch.Tensor       # f32 [O, cap] output channels (render payload)
    alive: torch.Tensor      # bool [cap]
    emit_acc: torch.Tensor   # f32 [] fractional particles owed
    emitted: torch.Tensor    # int32 [] counters
    killed: torch.Tensor
    overflow: torch.Tensor


def _pack(channels: Dict[str, Vec], layout: List[Tuple[str, int]], shape, device) -> torch.Tensor:
    """Stack a layout's channels into rows [..., R, cap] (zeros where a
    channel is missing)."""
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    rows = []
    for name, w in layout:
        v = channels.get(name)
        rows.extend([zero] * w if v is None else [c.expand(shape) for c in v.broadcast_to(w).comps])
    if not rows:
        return torch.zeros(shape[:-1] + (0, shape[-1]), dtype=torch.float32, device=device)
    return torch.stack(rows, dim=-2)


def _unpack(packed: torch.Tensor, layout: List[Tuple[str, int]]) -> Dict[str, Vec]:
    out = {}
    r = 0
    for name, w in layout:
        out[name] = Vec([packed[..., r + i, :] for i in range(w)])
        r += w
    return out


def _collect_emit_targets(stmts) -> List[str]:
    targets = []
    for st in stmts:
        if isinstance(st, EmitStmt):
            targets.append(st.target)
        elif isinstance(st, If):
            targets += _collect_emit_targets(st.then)
            targets += _collect_emit_targets(st.orelse)
    return targets


def _fill(fill: torch.Tensor, spawn: Dict[str, Vec], ch: Dict[str, Vec]) -> Dict[str, Vec]:
    """Channels where `fill` takes the spawned values."""
    return {n: Vec([torch.where(fill, s, c) for s, c in zip(spawn[n].comps, ch[n].comps)])
            if n in spawn else ch[n] for n in ch}


class ParticleSystem:
    """One compiled script instance: a set of emitters with cross-emit edges
    (one per particle_emitter component)."""

    def __init__(self, emitters: Dict[str, CompiledEmitter]):
        self.emitters = emitters
        # a declared capacity of 0 runs one slot
        self.caps = {name: max(em.decl.max_ribbons * em.decl.max_ribbon_length
                               if em.decl.max_ribbons else em.decl.max_particles, 1)
                     for name, em in emitters.items()}
        # declared `global` inputs (name → width), shared across emitters
        self.globals_decl: Dict[str, int] = {}
        for em in emitters.values():
            self.globals_decl.update(em.globals_decl)
        # topological order over EMIT edges: sources update before targets, so
        # same-frame spawns land in the frame that requests them
        deps: Dict[str, List[str]] = {n: [] for n in emitters}
        for n, em in emitters.items():
            fn = em.decl.fns.get("update")
            if fn:
                for t in _collect_emit_targets(fn.body):
                    if t not in emitters:
                        raise ValueError(f"emit target {t!r} not found")
                    deps[t].append(n)
        order: List[str] = []
        visiting: set = set()

        def visit(n):
            if n in order:
                return
            if n in visiting:
                raise ValueError("emit cycle between emitters")
            visiting.add(n)
            for d in deps[n]:
                visit(d)
            visiting.discard(n)
            order.append(n)

        for n in emitters:
            visit(n)
        self.order = order

    @classmethod
    def from_source(cls, src: str, imports: Optional[Dict[str, str]] = None):
        return cls(compile_source(src, imports=imports))

    # -- state ------------------------------------------------------------------

    def device_state(self, device, system: Optional[Dict[str, object]] = None
                     ) -> Dict[str, EmitterState]:
        states = {}
        for name, em in self.emitters.items():
            cap = self.caps[name]
            d = em.decl
            channels = torch.zeros((em.channel_rows(), cap), dtype=torch.float32, device=device)
            alive = torch.zeros(cap, dtype=torch.bool, device=device)
            emit_acc = torch.tensor(float(d.init_emit_count), dtype=torch.float32, device=device)
            if d.max_ribbons:
                # ribbon emitters: slots are ribbon-major; the initial
                # population is init_ribbons_count ribbons × init_emit_count
                # particles, emitted eagerly here with ribbon builtins bound
                rlen = max(d.max_ribbon_length, 1)
                slot = torch.arange(cap, device=device)
                ribbon_index = slot // rlen
                emit_index = slot % rlen
                alive = ((ribbon_index < d.init_ribbons_count)
                         & (emit_index < min(d.init_emit_count, rlen)))
                extern = self._extern(device, system, emit_index=emit_index.float(),
                                      ribbon_index=ribbon_index.float())
                ch = _unpack(channels, em.channels)
                spawn = em.run_emit(ch, (cap,), prng.PRNGKey(0, device), extern=extern)
                ch = {n: (spawn[n] if n in spawn else ch[n]) for n in ch}
                channels = _pack(ch, em.channels, (cap,), device)
                emit_acc = torch.zeros((), dtype=torch.float32, device=device)
            zero = torch.zeros((), dtype=torch.int32, device=device)
            states[name] = EmitterState(
                channels=channels,
                outs=torch.zeros((em.out_rows(), cap), dtype=torch.float32, device=device),
                alive=alive,
                # init_emit_count owed on the first frame
                emit_acc=emit_acc,
                emitted=zero, killed=zero.clone(), overflow=zero.clone(),
            )
        return states

    def _extern(self, device, system: Optional[Dict[str, object]], **extra) -> Dict[str, Vec]:
        """Named external values for the script: declared globals (zeros
        unless provided), entity_position, and any builtins in `extra`. A
        value is a number per world ([...]) broadcast over the slots; the
        builtins in `extra` are per slot already."""
        ext: Dict[str, Vec] = {}
        system = system or {}

        def per_world(v, w):
            if v is None:
                return Vec([torch.zeros(1, dtype=torch.float32, device=device)] * w)
            t = torch.as_tensor(v, dtype=torch.float32, device=device)
            if t.dim() <= 1:
                t = t.reshape(-1)
            return Vec([t[..., i, None] for i in range(w)])

        for gname, w in self.globals_decl.items():
            ext[gname] = per_world(system.get(gname), w)
        ext["entity_position"] = per_world(system.get("entity_position"), 3)
        for k, v in extra.items():
            ext[k] = v if isinstance(v, Vec) else Vec([v])
        return ext

    # -- the per-frame step --------------------------------------------------------

    def step(self, states: Dict[str, EmitterState], dt, time, key,
             system: Optional[Dict[str, object]] = None) -> Dict[str, EmitterState]:
        """One frame of every emitter. `key` [..., 2] is batched like the
        states; `system` carries per-frame external inputs: declared
        `global` values by name and `entity_position`."""
        dev = key.device
        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        new_states = dict(states)
        pending: Dict[str, List[tuple]] = {n: [] for n in self.emitters}

        for idx, name in enumerate(self.order):
            em = self.emitters[name]
            cap = self.caps[name]
            st = new_states[name]
            shape = tuple(st.alive.shape)
            kname = prng.fold_in(key, idx)
            d = em.decl
            rlen = max(d.max_ribbon_length, 1)
            slot = torch.arange(cap, device=dev)
            ribbon_idx = (slot // rlen if d.max_ribbons
                          else torch.zeros(cap, dtype=torch.int32, device=dev)).float()
            ext = self._extern(dev, system, ribbon_index=ribbon_idx)

            ch = _unpack(st.channels, em.channels)
            alive = st.alive

            # 1. update alive particles
            upd_ch, kill_mask, emits = em.run_update(
                ch, shape, dt, time, prng.fold_in(kname, 0), extern=ext)
            ch = {**ch, **upd_ch}
            kill_mask = kill_mask & alive
            killed = torch.sum(kill_mask, dim=-1, dtype=torch.int32)
            alive = alive & ~kill_mask

            # record cross-emits (masked by source aliveness): particles that
            # emit and then kill() in the same frame still emit
            for req in emits:
                pending[req.target].append((name, req.mask & alive | (req.mask & kill_mask),
                                            req.ins))

            # 2. timed emission (emit-per-second accumulator)
            acc = st.emit_acc + em.decl.emit_per_second * dt
            n_timed = torch.floor(acc)
            acc = acc - n_timed

            dead = ~alive
            rank = torch.cumsum(dead.to(torch.int32), dim=-1, dtype=torch.int32)  # 1-based at dead
            # timed spawns: emit_index = index within this emission batch
            fill = dead & (rank <= n_timed.to(torch.int32).unsqueeze(-1))
            emit_index = torch.clamp_min(rank.float() - 1.0, 0.0)
            spawn_ch = em.run_emit(ch, shape, prng.fold_in(kname, 1),
                                   extern={**ext, "emit_index": Vec([emit_index])})
            ch = _fill(fill, spawn_ch, ch)
            spawned_total = torch.sum(fill, dim=-1, dtype=torch.int32)
            alive = alive | fill

            # 3. routed cross-emitter spawns
            overflow = torch.zeros_like(spawned_total)
            for r_i, (src_name, req_mask, ins) in enumerate(pending[name]):
                src_shape = tuple(req_mask.shape)
                n_req = torch.sum(req_mask, dim=-1, dtype=torch.int32)
                # requesting slots first, in slot order
                req_order = torch.argsort((~req_mask).to(torch.uint8), dim=-1, stable=True)
                dead = ~alive
                rank = torch.cumsum(dead.to(torch.int32), dim=-1, dtype=torch.int32)
                fill = dead & (rank <= n_req.unsqueeze(-1))
                take = torch.clamp(rank - 1, 0, src_shape[-1] - 1).to(torch.int64)
                src = torch.gather(req_order, -1, take)
                routed = {n: Vec([torch.gather(c.expand(src_shape), -1, src) for c in v.comps])
                          for n, v in ins.items()}
                emit_index2 = torch.clamp_min(rank.float() - 1.0, 0.0)
                spawn_ch = em.run_emit(ch, shape, prng.fold_in(kname, 10 + r_i), ins=routed,
                                       extern={**ext, "emit_index": Vec([emit_index2])})
                ch = _fill(fill, spawn_ch, ch)
                filled = torch.sum(fill, dim=-1, dtype=torch.int32)
                spawned_total = spawned_total + filled
                overflow = overflow + torch.clamp_min(n_req - filled, 0)
                alive = alive | fill

            # 4. outputs (the instance payload for the renderer); dead slots
            # emit a zeroed payload
            out_vals = em.run_output(ch, shape, dt, time, prng.fold_in(kname, 2), extern=ext)
            outs = _pack(out_vals, em.outs, shape, dev)
            if outs.shape[-2]:
                outs = torch.where(alive.unsqueeze(-2), outs, 0.0)

            new_states[name] = EmitterState(
                channels=_pack(ch, em.channels, shape, dev),
                outs=outs,
                alive=alive,
                emit_acc=acc,
                emitted=st.emitted + spawned_total,
                killed=st.killed + killed,
                overflow=st.overflow + overflow,
            )
        return new_states

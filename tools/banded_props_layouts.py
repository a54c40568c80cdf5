#!/usr/bin/env python3
"""The banded props level (``models/physics_scenes.banded_props_level``)
in several layouts, through the port's PhysicsModule and, with
``--reference``, the JAX package's, after the JAX banded pile test's 360
steps: for each layout the settle checks of that test hull by hull
(``physics_scenes.check_banded_props``: finite, every velocity component
below 0.8 m/s, no vertex deeper than 0.02 m in the ground or the slab),
with the number of hulls that break each bound, and the window certificate
``sap_window_miss`` summed over the run. Both packages build the same level
from the same seed, so a layout that fails in both fails in the reference.

    python tools/banded_props_layouts.py                  # the full level on the card
    # a scaled-down level, both packages on the CPU (the banded branch forced):
    JAX_PLATFORMS=cpu python tools/banded_props_layouts.py --device cpu --hulls 256 \\
        --reference --layouts stacks grid4 grid2 pitch1 --seeds 7 8 9
    # the port's step held to the reference's at every step of its run:
    JAX_PLATFORMS=cpu python tools/banded_props_layouts.py --hulls 256 --lockstep --seeds 8
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name: (stack, pitch, grid, window). "stacks": the level's layout, stacks
# of five as the JAX test's pile; the others: full layers on a grid
LAYOUTS = {
    "stacks": (5, 2.0, False, 24),
    "grid4": (4, 1.1, True, 40),      # four layers 1.1 m apart
    "grid2": (2, 1.1, True, 24),      # two layers 1.1 m apart
    "pitch1": (2, 1.0, True, 24),     # two layers 1.0 m apart
}
STEPS = 360


def settle(sc, pos, vel, verts, valid, misses):
    """The settle readings of one run (physics_scenes.check_banded_props:
    the JAX test's bounds hull by hull, penetration into the ground or the
    slab) from numpy pos and vel [3, NB], world hull vertices [3, V, NB]
    with their valid mask [V, NB], and the misses of each step."""
    import numpy as np

    from lumixengine_tpu_torch.models import physics_scenes as PS

    slots = list(sc.slots.values())
    pen = PS.hull_penetration(verts[..., slots], valid[:, slots])
    out = PS.check_banded_props(sc, pos, vel, pen, unsettled_max=len(slots))
    out["lowest_vertex"] = round(float(verts[1][..., slots][valid[:, slots]].min()), 5)
    # the depth of the hulls resting on the slab (centre over it) and on the ground
    (x0, x1), _y, (z0, z1) = PS.SLAB
    x, z = pos[0, slots], pos[2, slots]
    on_slab = (x > x0) & (x < x1) & (z > z0) & (z < z1)
    for name, sel in (("slab", on_slab), ("ground", ~on_slab)):
        q = np.quantile(pen[sel], (0.5, 0.9, 0.99)) if sel.any() else ()
        out[f"{name}_hulls"], out[f"{name}_deep"] = int(sel.sum()), int((pen[sel] >= 0.02).sum())
        out[f"{name}_depth_q50_q90_q99"] = [round(float(v), 5) for v in q]
    out["miss"], out["first_miss"] = int(sum(misses)), next(
        (i + 1 for i, m in enumerate(misses) if m), None)
    out["holds"] = out["unsettled"] == 0
    return out


def build(api, hulls, layout, force, seed, window):
    from lumixengine_tpu_torch.models import physics_scenes as PS

    stack, pitch, grid, _own = LAYOUTS[layout]
    sc = PS.banded_props_level(api, hulls=hulls, seed=seed, capacity=max(hulls, 1024) if not force
                               else hulls + 4, neighbors=window, stack=stack, pitch=pitch,
                               grid=grid)
    pm = sc.world.modules["physics"]
    if force:
        pm.broadphase = "banded"
        pm.invalidate_statics()
    return sc, pm


def run_port(hulls, layout, device, force, steps, seed, window):
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import convex_ops as CV

    sc, pm = build(None, hulls, layout, force, seed, window)
    st = pm.statics()
    assert st.sap, "the level did not take the banded branch"
    step = sc.engine.build_step(sc.world, device)
    state = PS.start_state(sc, device)
    misses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, PS.DT)
        misses.append(state.modules["physics"].counters["sap_window_miss"])
    misses = torch.stack(misses).cpu().tolist()
    wall = time.perf_counter() - t0
    ms = state.modules["physics"]
    vw = CV.polytope_world_verts(ms.pos, ms.rot, st.on(device, pm.system).poly_verts).cpu().numpy()
    out = settle(sc, ms.pos.cpu().numpy(), ms.vel.cpu().numpy(), vw, st.poly_vert_valid, misses)
    return {"package": "torch", "device": str(device), "s": round(wall, 1), **out}


def reference_api():
    """The JAX package's classes the level's builder takes."""
    from types import SimpleNamespace

    from lumixengine_tpu.engine.engine import Engine
    from lumixengine_tpu.physics.module import PhysicsSystem
    from lumixengine_tpu.renderer.model import Model
    from lumixengine_tpu.renderer.render_module import RendererSystem

    return SimpleNamespace(Engine=Engine, PhysicsSystem=PhysicsSystem,
                           RendererSystem=RendererSystem, Model=Model)


def run_reference(hulls, layout, force, steps, seed, window):
    """The same level through the JAX package's PhysicsModule (jitted step)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import lumixengine_tpu.ops.convex_ops as CV

    sc, pm = build(reference_api(), hulls, layout, force, seed, window)
    st = pm.statics()
    assert st.sap, "the level did not take the banded branch"
    step = jax.jit(sc.engine.build_step(sc.world, jit=False))
    state = sc.world.device_state()
    misses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, jnp.float32(1.0 / 60.0))
        misses.append(int(state.modules["physics"].counters["sap_window_miss"]))
    wall = time.perf_counter() - t0
    ms = state.modules["physics"]
    vw = np.asarray(CV.polytope_world_verts(ms.pos, ms.rot, st.poly_verts))
    out = settle(sc, np.asarray(ms.pos), np.asarray(ms.vel), vw, np.asarray(st.poly_vert_valid),
                 misses)
    return {"package": "jax", "device": "cpu", "s": round(wall, 1), **out}


def run_lockstep(hulls, layout, force, steps, seed, window):
    """The port's step from the reference's own state at every step of the
    reference's run (both on the CPU), held at the CPU tests' tolerances
    (pos 1e-5, velocities 1e-4, counters and ranks equal); a step that
    breaks them is explained by physics_scenes.explain_break, the
    reference's banded polytope SAT (jitted) in place of the port's. An
    unexplained step raises. Returns the count of each cause, the largest
    tie margin and the largest error of a step that holds."""
    import collections

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import lumixengine_tpu.ops.physics_banded as RPBD
    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.models import physics_scenes as PS

    rsc, _ = build(reference_api(), hulls, layout, force, seed, window)
    psc, _ = build(None, hulls, layout, force, seed, window)
    rstep = jax.jit(rsc.engine.build_step(rsc.world, jit=False))
    pstep = psc.engine.build_step(psc.world, "cpu")
    sat = jax.jit(RPBD.banded_polytope_grids, static_argnums=(5, 6))

    def ref_sat(*args):
        out = sat(*(jnp.asarray(x.numpy()) for x in args[:5]), *args[5:])
        return tuple(torch.as_tensor(np.array(x)) for x in out)

    def numpy_state(tree):
        return {".".join(str(getattr(k, "name", getattr(k, "key", k))) for k in path):
                np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}

    def gap(got, ref):
        return PS.state_gap(got, ref, 1e-5, 1e-4)[:2]

    state, causes, margin, worst = rsc.world.device_state(), collections.Counter(), 0.0, 0.0
    t0 = time.perf_counter()
    for _ in range(steps):
        nxt = rstep(state, jnp.float32(1.0 / 60.0))
        start = bridge.state_from_numpy(numpy_state(state), "cpu")
        ref = numpy_state(nxt)
        errs, broke = gap(bridge.state_to_numpy(pstep(start, PS.DT)), ref)
        cause = "equal"
        if broke is not None:
            cause, m, errs = PS.explain_break(pstep, start, ref, gap, 0.0, ref_sat=ref_sat)
            margin = max(margin, m)
        causes[cause] += 1
        worst = max([worst] + list(errs.values()))
        state = nxt
    return {"package": "lockstep", "device": "cpu", "s": round(time.perf_counter() - t0, 1),
            "steps": dict(causes), "largest_margin": margin, "largest_err_held": worst}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hulls", type=int, default=1024)
    ap.add_argument("--layouts", nargs="+", default=list(LAYOUTS), choices=list(LAYOUTS))
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--window", type=int, help="the sweep window of every layout (default: "
                    "each layout's own)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[7],
                    help="the hulls' point clouds (7: the level's)")
    ap.add_argument("--reference", action="store_true",
                    help="also run the JAX package's PhysicsModule (on the CPU)")
    ap.add_argument("--lockstep", action="store_true",
                    help="instead, hold the port's step to the reference's at every step of the "
                    "reference's run (both on the CPU)")
    a = ap.parse_args()
    force = a.hulls <= 256   # below 257 actor slots `auto` would not pick the banded branch
    for layout in a.layouts:
        stack, pitch, grid, own = LAYOUTS[layout]
        window = a.window or own
        for seed in a.seeds:
            head = {"layout": layout, "hulls": a.hulls, "seed": seed, "stack": stack,
                    "pitch": pitch, "grid": grid, "window": window}
            if a.lockstep:
                print(json.dumps({**head, **run_lockstep(a.hulls, layout, force, a.steps, seed,
                                                         window)}), flush=True)
                continue
            print(json.dumps({**head, **run_port(a.hulls, layout, a.device, force, a.steps, seed,
                                                 window)}), flush=True)
            if a.reference:
                print(json.dumps({**head, **run_reference(a.hulls, layout, force, a.steps, seed,
                                                          window)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Readings behind the large-world settle gates (physics_scenes.check_box_drop
and check_pile), from the JAX package or the port, over several seeds and
under a planted fault, one JSON line a run.

The stand-alone steps on the elongated pile (physics_scenes.elongated_pile,
its jitter drawn from --seeds) at test_box_drop_statistics's settings for
PILE_FALL_STEPS + PILE_SETTLE_STEPS steps: |sum vx| after the fall, the
lowest centre, the centres below the pipeline's PILE_Y_MIN, the highest
centre, the kinetic energy, the window certificate summed. The sap pile
(physics_scenes.mixed_pile, --seeds its jitter) through the PhysicsModule's
broadphase="sap" for SAP_PILE_STEPS frames at W=1: the median speed, and
the deepest centre under its shape's resting height
(physics_scenes.rest_heights).

--fault half_position_iterations runs the step with half its position
iterations, a solve that lets the pile sink; no_warm_start (the banded
step only) runs it without its cross-frame warm start, with which the
banded pile rests at about the slop. The gates must fail them.

    JAX_PLATFORMS=cpu python tools/pile_gates.py --package jax --scene dynamic banded
    python tools/pile_gates.py --package torch --device cuda --scene dynamic banded sap
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DT = np.float32(1.0 / 60.0)


def box_readings(kind, y, vx_fall, vel, angvel, miss):
    from lumixengine_tpu_torch.models import physics_scenes as PS

    return {"vx_sum_fall": float(abs(vx_fall.sum())), "lowest": float(y.min()),
            "below": int((y < PS.PILE_Y_MIN[kind]).sum()), "highest": float(y.max()),
            "ke": float((vel ** 2).sum() + (angvel ** 2).sum()), "miss": int(miss)}


def run_box_jax(kind, nb, seed, pos_iters, warm):
    import functools

    import jax
    import jax.numpy as jnp

    from lumixengine_tpu.ops import physics_banded as RBD
    from lumixengine_tpu.ops import physics_big as RB
    from lumixengine_tpu_torch.models import physics_scenes as PS

    tables = PS.box_pile_tables(nb)
    kw = dict(PS.PILE_STEP, position_iterations=pos_iters)
    banded = kind == "banded"
    step = (RBD.make_banded_world_step(*tables, **kw, n_sweeps=4, warm_start=warm) if banded
            else RB.make_big_world_step(*tables, **kw))

    @functools.partial(jax.jit, static_argnums=1)
    def run(c, n):
        def body(i, c):
            out = step(*c[:4], DT, *c[5:])
            return tuple(out[:4]) + (c[4] + out[4]["sap_window_miss"],) + tuple(out[5:])
        return jax.lax.fori_loop(0, n, body, c)

    pos, rot = PS.elongated_pile(nb, seed=seed)
    z = jnp.zeros((3, nb), jnp.float32)
    c = (jnp.asarray(pos), jnp.asarray(rot), z, z, jnp.int32(0)) + \
        ((step.init_carry(),) if banded and warm else ())
    c = run(c, PS.PILE_FALL_STEPS)
    vx = np.asarray(c[2][0])
    c = run(c, PS.PILE_SETTLE_STEPS)
    return box_readings(kind, np.asarray(c[0][1]), vx, np.asarray(c[2]), np.asarray(c[3]),
                        int(c[4]))


def run_box_torch(kind, nb, seed, pos_iters, warm, dev):
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import physics_banded as PBD
    from lumixengine_tpu_torch.ops import physics_big as PBG

    tables = PS.box_pile_tables(nb)
    kw = dict(PS.PILE_STEP, position_iterations=pos_iters)
    if kind == "banded":
        step = PBD.make_banded_world_step(*tables, **kw, n_sweeps=4, warm_start=warm)
        carry = step.init_carry(dev) if warm else None
    else:
        step, carry = PBG.make_big_world_step(*tables, **kw), None
    pos, rot = PS.elongated_pile(nb, seed=seed)
    z = torch.zeros((3, nb), device=dev)
    state = [torch.as_tensor(pos, device=dev), torch.as_tensor(rot, device=dev), z, z]
    dt = torch.tensor(float(DT), device=dev)
    miss, vx = torch.zeros((), dtype=torch.int32, device=dev), None
    for i in range(PS.PILE_FALL_STEPS + PS.PILE_SETTLE_STEPS):
        res = step(*state, dt) if carry is None else step(*state, dt, carry)
        state, carry = list(res[:4]), (None if carry is None else res[5])
        miss = miss + res[4]["sap_window_miss"]
        if i + 1 == PS.PILE_FALL_STEPS:
            vx = state[2][0].cpu().numpy()
    return box_readings(kind, state[0][1].cpu().numpy(), vx, state[2].cpu().numpy(),
                        state[3].cpu().numpy(), int(miss))


def run_sap(package, seed, pos_iters, dev):
    from lumixengine_tpu_torch.models import physics_scenes as PS

    if package == "jax":
        import jax.numpy as jnp

        from types import SimpleNamespace
        from lumixengine_tpu.engine.engine import Engine
        from lumixengine_tpu.physics.module import PhysicsSystem
        from lumixengine_tpu.renderer.model import Model
        from lumixengine_tpu.renderer.render_module import RendererSystem

        api = SimpleNamespace(Engine=Engine, PhysicsSystem=PhysicsSystem,
                              RendererSystem=RendererSystem, Model=Model)
        sc = PS.mixed_pile(api, actors=PS.SAP_PILE_ACTORS, broadphase="sap", seed=seed)
        sc.world.modules["physics"].position_iterations = pos_iters
        sc.world.modules["physics"].invalidate_statics()
        step, state = sc.engine.build_step(sc.world, donate=False), sc.world.device_state()
        dt = jnp.float32(DT)
    else:
        sc = PS.mixed_pile(actors=PS.SAP_PILE_ACTORS, broadphase="sap", seed=seed)
        sc.world.modules["physics"].position_iterations = pos_iters
        sc.world.modules["physics"].invalidate_statics()
        step, state, dt = sc.engine.build_step(sc.world, dev), sc.world.device_state(dev), float(DT)
    for _ in range(PS.SAP_PILE_STEPS):
        state = step(state, dt)
    ph = state.modules["physics"]
    st = sc.world.modules["physics"].statics()
    as_np = (lambda x: np.asarray(x)) if package == "jax" else (lambda x: x.cpu().numpy())
    return PS.pile_readings(as_np(ph.pos), as_np(ph.vel), as_np(ph.angvel),
                            np.asarray(st.occupied),
                            PS.rest_heights(st.shape, st.radius, st.half_extents))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["jax", "torch"], default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scene", nargs="+", default=["dynamic", "banded", "sap"])
    ap.add_argument("--boxes", type=int, default=4096)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--fault", choices=["none", "half_position_iterations", "no_warm_start"],
                    nargs="+", default=["none", "half_position_iterations"])
    args = ap.parse_args()
    card = "cpu"
    if args.package == "torch" and args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("pile_gates: no CUDA device; nothing was run", file=sys.stderr)
            return 2
        import chip_smoke as C

        card = C.gpu_line()
    from lumixengine_tpu_torch.models import physics_scenes as PS

    for scene in args.scene:
        full = 6 if scene != "sap" else 3
        for fault in args.fault:
            if fault == "no_warm_start" and scene != "banded":
                continue       # the dynamic step and the sap branch start cold
            pos_iters = full // 2 if fault == "half_position_iterations" else full
            warm = fault != "no_warm_start"
            for seed in args.seeds:
                t0 = time.perf_counter()
                if scene == "sap":
                    r = run_sap(args.package, seed, pos_iters, args.device)
                elif args.package == "jax":
                    r = run_box_jax(scene, args.boxes, seed, pos_iters, warm)
                else:
                    r = run_box_torch(scene, args.boxes, seed, pos_iters, warm, args.device)
                n = PS.SAP_PILE_ACTORS if scene == "sap" else args.boxes
                print(json.dumps({"package": args.package, "card": card,
                                  "scene": scene, "bodies": n, "seed": seed, "fault": fault,
                                  "position_iterations": pos_iters, **r,
                                  "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

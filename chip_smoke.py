#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the hand-written kernels (nvcc, sm_90a) from lumixengine_tpu_torch/csrc;
  3. K1 (frustum cull) against its plain PyTorch version on the cull pass's
     own operands at [1024, 10240]: bit for bit;
  4. K2 (fused contact solve) against its plain version on the contact sets
     of the slice world settled at W=1024 (NB=64, C=1792, 10 + 3 iterations),
     and as a pile, within solver.K2_PLAIN_ATOL; the plain version run one
     iteration or one projection pass short must exceed that limit;
  5. the main paths, each through Engine.build_step(extra=cull_pass) on the
     card with the launch counts set to 0 just before and read just after:
     the full flagship full_frame_world(10240, 64, 64, 2048) replicated to
     1024 worlds for 200 frames (hierarchy, 32 animables, 32 locomotion
     animators with root motion and dual-quaternion palettes, 64 rigid
     bodies, the 2048-particle storm emitter, the cull pass), then the
     slice full_frame_world(10240, 0, 64, 0) at 256 worlds for 200 frames.
     Each kernel launches once per frame; the state stays finite; 64
     characters are animated per world, 0 < particles alive <= 2048, root
     motion moves the animators. Then 3 frames at W=4 on the card against
     the plain versions on the CPU, animation and particle fields included,
     and the threefry stream on the card against the CPU's, bit for bit;
  6. timings with CUDA events: ms/frame and entity-steps/s of both paths,
     each kernel beside its plain version.

Any failure raises and the exit code is not 0. The last two lines are the
kernels' JSON record and {"ok": true, "device": {...}}. Without a CUDA device
the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_ENTITIES, N_CHARACTERS, N_BODIES, N_PARTICLES = 10240, 64, 64, 2048
WORLDS, FRAMES, WARM_FRAMES, SETTLE_FRAMES = 1024, 200, 10, 240
SLICE_WORLDS = 256       # the slice path (no characters, a 1-slot emitter), at a smaller depth
DT = 1.0 / 60.0
ITERATIONS, POSITION_ITERATIONS = 10, 3
TRANSFORM_ATOL = 1e-5    # entities the physics does not move (root motion included)
BODY_POS_ATOL = 1e-3
BODY_VEL_ATOL = 5e-3
MARGIN = 1e-4            # cull decisions this close to a threshold may flip
CLOCK_ATOL = 1e-6        # animation clocks: adds and fmod, exact on both sides
POSE_ATOL = 1e-5         # poses and palettes: rsqrt and compose chains differ by ulps
PARTICLE_ATOL = 1e-4     # particle channels, |values| <= ~60 (1 ulp at 32..64 is 3.8e-6)
KILL_MARGIN = 1e-4       # kills this close to a threshold (pos.y = 0, t = 6) may flip
STORM_G = 9.8
DEVICE = "cuda:0"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call of fn() over `reps` calls, with CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def alternate(plain, kernel, reps: int):
    """Times in the order plain, kernel, kernel, plain; returns the means."""
    p1, k1, k2, p2 = (cuda_time(f, reps) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(xs, ys) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.core import geometry as geom
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import hierarchy as hier
    from lumixengine_tpu_torch.ops import native
    from lumixengine_tpu_torch.ops import solver as S
    from lumixengine_tpu_torch.parallel.mesh import replicate_state
    from lumixengine_tpu_torch.renderer import pipeline

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    W = WORLDS

    # 1. the card
    log(f"[1 device] {card} | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    native.library()
    log(f"[2 build] {native.library_path().name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(native.NVCC_FLAGS[:2])})")

    engine, world, _renderer, _anim, _phys = full_frame_world(N_ENTITIES, 0, N_BODIES, 0)
    rm, pm = world.modules["renderer"], world.modules["physics"]
    st = pm.statics()
    single = world.device_state(dev)
    step = engine.build_step(world, dev, extra=rm.cull_pass)

    # 3. K1 on the cull pass's operands: the world camera, and random views
    batch = replicate_state(single, W, torch.Generator(device=dev).manual_seed(1))
    batch = batch.replace(world=hier.propagate_plan(batch.local, world.plan))
    frustum, centers, radii = pipeline.cull_operands(batch, batch.modules["renderer"], rm.statics())
    centers, radii = centers.contiguous(), radii.contiguous()
    cam_planes = frustum.planes.contiguous()
    del batch
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((W, 4), generator=g, device=dev)
    eye = torch.randn((W, 3), generator=g, device=dev) * 20.0
    rand_planes = geom.perspective_frustum(eye, q / q.norm(dim=-1, keepdim=True),
                                           1.2, 16 / 9, 0.3, 150.0).planes.contiguous()
    k1_bad, k1_err = 0, 0.0
    for planes in (cam_planes, rand_planes):
        vk = cull.frustum_cull_cuda(centers, radii, planes)
        vp = cull.frustum_cull_plain(centers, radii, planes)
        torch.cuda.synchronize()
        k1_bad += int((vk != vp).sum())
        k1_err = max(k1_err, max_err([vk.float()], [vp.float()]))
        frac = float(vk.float().mean())
        if not 0.0 < frac < 1.0:
            raise AssertionError(f"K1 check is degenerate: visible fraction {frac}")
    log(f"[3 K1] [{W},3,{centers.shape[-1]}] world-camera and random views: "
        f"{k1_bad} mismatches with the plain version")
    if k1_bad:
        raise AssertionError(f"K1 is not bit-exact: {k1_bad} mismatches")

    # 4. K2 on the main path's shapes: settled contact sets, and the same worlds piled up
    settle = replicate_state(single, W, torch.Generator(device=dev).manual_seed(3))
    for _ in range(SETTLE_FRAMES):
        settle = step(settle, DT)
    physics = settle.modules["physics"]
    i = torch.arange(N_BODIES, device=dev)
    grid = torch.stack([(i % 4) * 0.95, 0.45 + (i // 16) * 0.95, ((i // 4) % 4) * 0.95]).float()
    piled = settle.replace(modules={**settle.modules, "physics": physics.replace(
        pos=grid.expand(physics.pos.shape).contiguous())})
    k2_err = 0.0
    problems = {}
    faults = {"one iteration short": 0.0, "one projection pass short": 0.0}
    for name, s in (("settled", settle), ("piled", piled)):
        prob = pm.solver_problem(s, DT)
        problems[name] = prob
        n_pair = int(prob.act[:, -pm.points_per_pair * st.pair_budget:].sum())
        outk = S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)
        outp = S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS)
        err = max_err(outk, outp)
        ok = all(bool(torch.isfinite(a).all()) for a in outk)
        log(f"[4 K2] {name}: W={prob.vel.shape[0]} NB={prob.vel.shape[-1]} C={prob.act.shape[-1]}"
            f" active {int(prob.act.sum())} (pair stream {n_pair}), max abs err vs plain "
            f"{err:.3e} (limit {S.K2_PLAIN_ATOL:g})")
        if not ok or not err <= S.K2_PLAIN_ATOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err} (finite {ok})")
        if int(prob.act.sum()) == 0 or (name == "piled" and n_pair == 0):
            raise AssertionError(f"K2 check on {name} has no contacts to solve")
        k2_err = max(k2_err, err)
        for fault, its in (("one iteration short", (ITERATIONS - 1, POSITION_ITERATIONS)),
                           ("one projection pass short", (ITERATIONS, POSITION_ITERATIONS - 1))):
            faults[fault] = max(faults[fault], max_err(S.solve_plain(prob, *its), outp))
    shown = {k: float(f"{v:.3e}") for k, v in faults.items()}
    log(f"[4 K2] plain version with a planted fault, max abs err vs plain: {shown}")
    if not min(faults.values()) > S.K2_PLAIN_ATOL:
        raise AssertionError(f"the K2 limit {S.K2_PLAIN_ATOL} does not catch a planted fault: {faults}")
    del settle, piled, problems["piled"]

    # 5. the main paths
    stream = check_threefry(dev)
    log(f"[5 rng] threefry on the card vs the CPU, first 8 words of one draw: {stream}")
    flag = full_frame_world(N_ENTITIES, N_CHARACTERS, N_BODIES, N_PARTICLES)
    runs = {"flagship": run_path("flagship", flag, W, dev, replicate_state, map_tensors),
            "slice": run_path("slice", (engine, world), SLICE_WORLDS, dev, replicate_state,
                              map_tensors, step=step)}

    # 6. timings
    k1_ms, k1_plain = alternate(lambda: cull.frustum_cull_plain(centers, radii, cam_planes),
                                lambda: cull.frustum_cull_cuda(centers, radii, cam_planes), 20)
    prob = problems["settled"]
    k2_ms, k2_plain = alternate(lambda: S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS),
                                lambda: S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS), 5)
    paths = "; ".join(
        f"{name} {r['ms']:.3f} ms/frame at W={r['worlds']} = "
        f"{r['worlds'] * N_ENTITIES / (r['ms'] / 1e3):.4g} entity-steps/s ({r['ops']} ops/frame)"
        for name, r in runs.items())
    log(f"[6 time] {card}: {paths};"
        f" K1 [{W},3,{N_ENTITIES}] {k1_ms:.4f} ms (plain {k1_plain:.4f} ms);"
        f" K2 W={prob.vel.shape[0]} C={prob.act.shape[-1]} {k2_ms:.4f} ms (plain {k2_plain:.4f} ms)")

    main_launches = runs["flagship"]["launches"]
    kernels = [
        {"name": "K1 frustum_cull", "route": "cuda", "source": "lumixengine_tpu_torch/csrc/cull.cu",
         "replaces": "lumixengine_tpu/ops/culling.py:54", "launches": main_launches["K1"],
         "launches_slice": runs["slice"]["launches"]["K1"],
         "max_abs_err": k1_err, "mismatches": k1_bad, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 solve_contacts_fused", "route": "cuda",
         "source": "lumixengine_tpu_torch/csrc/solver.cu",
         "replaces": "lumixengine_tpu/ops/solver_pallas.py:165", "launches": main_launches["K2"],
         "launches_slice": runs["slice"]["launches"]["K2"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def check_threefry(dev):
    """One uniform draw under a folded key on the card and on the CPU: equal
    bit for bit. Returns the first 8 words of each."""
    import torch

    from lumixengine_tpu_torch.core import random as prng

    words = {}
    for where in (dev, torch.device("cpu")):
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(0, where), 1234), torch.tensor(
            [7, -3], dtype=torch.int32, device=where))
        u = prng.uniform(key, (N_PARTICLES,))
        words[where.type] = u.view(torch.int32).cpu().numpy().view("uint32")
    cuda, cpu = words["cuda"], words["cpu"]
    if not (cuda == cpu).all():
        raise AssertionError(f"threefry differs on the card: {int((cuda != cpu).sum())} words")
    return {"cuda": cuda[0, :8].tolist(), "cpu": cpu[0, :8].tolist()}


def run_path(name, built, num_worlds, dev, replicate_state, map_tensors, step=None):
    """FRAMES frames of one path at `num_worlds` worlds on the card, timed
    and checked, then the 3-frame compare against the CPU."""
    import torch

    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import solver as S

    engine, world = built[0], built[1]
    rm = world.modules["renderer"]
    if step is None:
        step = engine.build_step(world, dev, extra=rm.cull_pass)
    state = replicate_state(world.device_state(dev), num_worlds,
                            torch.Generator(device=dev).manual_seed(0))
    start = state
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cull.frustum_cull_cuda.launches = 0
    S.solve_cuda.launches = 0
    t0 = time.perf_counter()
    for f in range(FRAMES):
        if f == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": cull.frustum_cull_cuda.launches, "K2": S.solve_cuda.launches}
    ms_frame = ev0.elapsed_time(ev1) / (FRAMES - WARM_FRAMES)
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    rs = state.modules["renderer"]
    active = state.modules["physics"].counters["active_contacts"]
    visible = rs.counters["visible_count"]
    alive = rs.counters["particles_alive"]
    ams = state.modules["animation"]
    animated = ams.counters["animated"]            # the animables, as the reference counts
    posed = (ams.pose_pos != 0).any(dim=-3).any(dim=-2).sum(dim=-1)  # pool columns written
    moved = _root_motion(world, start, state)
    an = world.modules["animation"]
    n_char = len(an.animables) + len(an.animators)
    log(f"[5 {name}] W={num_worlds}: {FRAMES} frames in {wall:.2f} s; launches {launches}; "
        f"finite {finite}; active contacts {int(active.sum())} (worlds with contacts "
        f"{int((active > 0).sum())}); visible min/mean {int(visible.min())}/"
        f"{float(visible.float().mean()):.1f}; characters animated min/max {int(posed.min())}/"
        f"{int(posed.max())} (animables {int(animated.min())}); particles alive min/max "
        f"{int(alive.min())}/{int(alive.max())}; "
        f"animators moved min/max {moved[0]:.3f}/{moved[1]:.3f} m")
    if launches != {"K1": FRAMES, "K2": FRAMES}:
        raise AssertionError(f"each kernel must launch once per frame: {launches}")
    if not finite or int(active.sum()) == 0 or int(visible.min()) <= 0:
        raise AssertionError("state is not finite, has no contacts or no visible instance")
    cap = sum(ps.caps[e] for _k, (_e, ps) in rm.particle_emitters.items() for e in ps.caps)
    if not (bool((animated == len(an.animables)).all()) and bool((posed == n_char).all())
            and int(alive.min()) > 0 and int(alive.max()) <= cap):
        raise AssertionError(f"characters animated {posed.unique().tolist()} (expected {n_char};"
                             f" animables {animated.unique().tolist()}), particles alive "
                             f"{int(alive.min())}..{int(alive.max())} (capacity {cap})")
    if len(an.animators) and not moved[2]:
        raise AssertionError(f"root motion did not move the animators: {moved}")
    del start
    ops = op_counts(world, state, dev)
    log(f"[5 {name}] torch ops dispatched in one frame at W={num_worlds} (views excluded, "
        f"K1/K2 launches not counted): {sum(ops.values())} = {ops}")
    cmp = compare_with_plain(engine, world, map_tensors(lambda t: t[:4].clone(), state), step)
    log(f"[5 {name}] {n_char} characters; 3 frames at W=4, card vs plain on the CPU: "
        f"max abs err {cmp['errs']}, boundary flips {cmp['flips']}, kill flips {cmp['kills']}")
    return {"ms": ms_frame, "worlds": num_worlds, "launches": launches, "ops": sum(ops.values())}


def op_counts(world, state, dev):
    """The torch ops one frame dispatches, per module phase, counted on the
    host as the phases of Engine.build_step run on `state`. Each non-view op
    is about one kernel launch."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from lumixengine_tpu_torch.ops import hierarchy as hier

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    dt = torch.tensor(DT, dtype=torch.float32, device=dev)

    def run(key, fn):
        with Count() as c:
            out = fn()
        if c.n:
            counts[key] = counts.get(key, 0) + c.n
        return out

    rm = world.modules["renderer"]
    for phase in ("end_frame", "update_parallel", "update", "late_update"):
        for m in world.modules.values():
            state = run(f"{m.name}.{phase}", lambda: getattr(m, phase)(state, dt))
    state = run("hierarchy", lambda: state.replace(
        world=hier.propagate_plan(state.local, world.plan)))
    run("renderer.cull_pass", lambda: rm.cull_pass(state, dt))
    return counts


def _root_motion(world, start, state):
    """(min, max) distance the animators' entities moved, and whether every
    animator whose speed input is above 0.5 moved more than 0.1 m."""
    import torch

    an = world.modules["animation"]
    if not len(an.animators):
        return 0.0, 0.0, True
    slots = [world.slot(int(e)) for e in an.animators.entity if e >= 0]
    cols = [c for c in range(an.animators.capacity) if an.animators.entity[c] >= 0]
    speed = torch.as_tensor(an.default_inputs[0, cols])
    d = (state.local.pos[..., :, slots] - start.local.pos[..., :, slots]).norm(dim=-2).cpu()
    fast = speed > 0.5
    return float(d.min()), float(d.max()), bool((d[:, fast] > 0.1).all())


def _float_tensors(state):
    from lumixengine_tpu_torch.engine.world import map_tensors

    out = []
    map_tensors(lambda t: out.append(t) if t.is_floating_point() else None, state)
    return out


def _storm_kill_margin(channels, dt):
    """How far each storm particle's next update sits from its kill
    thresholds (pos.y < 0, t > 6), from its channels [.., 7, cap]."""
    import numpy as np

    y = channels[..., 1, :] + (channels[..., 4, :] - STORM_G * dt) * dt
    t = channels[..., 6, :] + dt
    return np.minimum(np.abs(y), np.abs(t - 6.0))


def compare_with_plain(engine, world, state, step):
    """3 frames from the same W=4 state: the card's step (kernels) against the
    CPU step (plain versions), at the CPU parity tests' tolerances."""
    import numpy as np

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.renderer import pipeline

    rm = world.modules["renderer"]
    an = world.modules["animation"]
    cpu_step = engine.build_step(world, "cpu", extra=rm.cull_pass)
    pst = world.modules["physics"].statics()
    body = np.zeros(N_ENTITIES, bool)
    body[pst.entity_slots[pst.dyn_mask]] = True
    mi_body = body[rm.statics().mi_slots.clip(0)]
    char = np.zeros(N_ENTITIES, bool)
    for store in (an.animables, an.animators):
        char[world.to_slots(store.entity[store.entity >= 0])] = True
    gpu, cpu = state, state.to("cpu")
    errs, flips, kills = {}, [], []
    diverged = {}  # emitter -> slots whose kill flipped (they differ from then on)

    def close(name, a, b, atol):
        err = float(np.abs(a - b).max(initial=0.0))
        errs[name] = max(errs.get(name, 0.0), err)
        if not err <= atol:
            raise AssertionError(f"{name}: card vs plain {err} > {atol}")

    for _ in range(3):
        prev = bridge.state_to_numpy(cpu)
        gpu, cpu = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu)
        for xf in ("local", "world"):
            for f in ("pos", "rot", "scale"):
                k = f"{xf}.{f}"
                close(k, got[k][..., ~body], ref[k][..., ~body], TRANSFORM_ATOL)
                close(k + "[bodies]", got[k][..., body], ref[k][..., body], BODY_POS_ATOL)
                close(k + "[characters]", got[k][..., char], ref[k][..., char], TRANSFORM_ATOL)
        for f in ("prev_pos", "prev_rot"):
            k = "modules.renderer." + f
            close(k, got[k][..., ~mi_body], ref[k][..., ~mi_body], TRANSFORM_ATOL)
            close(k + "[bodies]", got[k][..., mi_body], ref[k][..., mi_body], BODY_POS_ATOL)
        for f in ("pos", "rot"):
            close("physics." + f, got["modules.physics." + f], ref["modules.physics." + f],
                  BODY_POS_ATOL)
        for f in ("vel", "angvel", "lam_n", "lam_t1", "lam_t2"):
            close("physics." + f, got["modules.physics." + f], ref["modules.physics." + f],
                  BODY_VEL_ATOL)
        for f in ("an_time", "ctrl_clocks"):
            close("animation." + f, got["modules.animation." + f], ref["modules.animation." + f],
                  CLOCK_ATOL)
        for f in ("pose_pos", "pose_rot", "palette"):
            close("animation." + f, got["modules.animation." + f], ref["modules.animation." + f],
                  POSE_ATOL)
        for k in ("modules.physics.sleep", "modules.physics.pair_key", "frame",
                  "modules.animation.counters.animated", "modules.renderer.prng"):
            if not np.array_equal(got[k], ref[k]):
                raise AssertionError(f"{k}: card and plain differ")
        kills.append(_compare_particles(prev, got, ref, close, diverged))
        margins = [m.numpy() for m in pipeline.cull_margins(cpu, rm)]
        frame_flips = 0
        for name, m in zip(("mi_visible", "mi_lod", "pl_visible"), margins):
            k = "modules.renderer." + name
            off = got[k] != ref[k]
            if np.any(off & (np.abs(m) >= MARGIN)):
                raise AssertionError(f"{k}: card and plain differ away from the boundary")
            frame_flips += int(off.sum())
        for counter, mask in (("visible_count", "mi_visible"), ("lights_visible", "pl_visible")):
            c = got["modules.renderer.counters." + counter]
            if not np.array_equal(c, got["modules.renderer." + mask].sum(-1)):
                raise AssertionError(f"{counter} disagrees with its mask")
        flips.append(frame_flips)
    return {"errs": {k: float(f"{v:.3g}") for k, v in errs.items() if v}, "flips": flips,
            "kills": kills}


def _compare_particles(prev, got, ref, close, diverged):
    """The storm emitters' fields, card vs CPU: equal alive masks and
    counters, channels within PARTICLE_ATOL, except at slots whose kill sat
    within KILL_MARGIN of a threshold (a flipped kill respawns the slot on
    one side, and it differs from then on; `diverged` keeps those slots, and
    the counters may differ by their number). Returns the flipped count."""
    import numpy as np

    pre = "modules.renderer.particles."
    for k in sorted(n for n in ref if n.startswith(pre) and n.endswith(".channels")):
        base = k[: -len(".channels")]
        near = _storm_kill_margin(prev[k], DT) < KILL_MARGIN
        off = np.zeros(near.shape, bool)
        for f in ("channels", "outs"):
            a, b = got[f"{base}.{f}"], ref[f"{base}.{f}"]
            off |= np.abs(a - b).max(axis=-2) > PARTICLE_ATOL
        old = diverged.get(base, np.zeros(near.shape, bool))
        if np.any(off & ~near & ~old):
            raise AssertionError(f"{base}: card vs plain differ away from a kill threshold")
        skip = diverged[base] = old | (off & near)
        for f in ("channels", "outs"):
            a, b = got[f"{base}.{f}"], ref[f"{base}.{f}"]
            keep = np.broadcast_to(~skip[..., None, :], a.shape)
            close(f"particles.{f}", a[keep], b[keep], PARTICLE_ATOL)
        a, b = got[base + ".alive"], ref[base + ".alive"]
        if np.any((a != b) & ~skip):
            raise AssertionError(f"{base}.alive: card and plain differ away from a threshold")
    flipped = int(sum(int(m.sum()) for m in diverged.values()))
    for base in {k.rsplit(".", 1)[0] for k in ref if k.startswith(pre)}:
        for f in ("emit_acc", "emitted", "killed", "overflow"):
            a, b = got[f"{base}.{f}"], ref[f"{base}.{f}"]
            if np.abs(a.astype(np.float64) - b).max(initial=0) > flipped:
                raise AssertionError(f"{base}.{f}: card {a} vs plain {b}")
    for c in ("particles_alive", "particles_emitted", "particles_killed"):
        k = "modules.renderer.counters." + c
        if np.abs(got[k].astype(np.int64) - ref[k]).max(initial=0) > flipped:
            raise AssertionError(f"{k}: card {got[k]} vs plain {ref[k]}")
    return flipped


if __name__ == "__main__":
    sys.exit(main())

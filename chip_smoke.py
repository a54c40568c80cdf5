#!/usr/bin/env python3
"""Run the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of the hand-written kernels (nvcc, sm_90a) from lumixengine_tpu_torch/csrc,
     with what ptxas reports for each kernel (registers, shared memory, spills);
  3. K1 (frustum cull) against its plain PyTorch version on the cull pass's
     own operands at [1024, 10240]: bit for bit;
  4. K2 (fused contact solve) against its plain version on the contact sets
     of the slice world settled at W=1024 (NB=64, C=1792, 10 + 3 iterations),
     as a pile, and on the largest shape the module makes,
     full_frame_world(2048, 0, 256, 0) piled at W=1024 (NB=256, C=7168),
     within solver.K2_PLAIN_ATOL; the plain version run one iteration or one
     projection pass short must exceed that limit;
  5. the main paths, each through Engine.build_step(extra=cull_pass) on the
     card with the launch counts set to 0 just before and read just after:
     the full flagship full_frame_world(10240, 64, 64, 2048) replicated to
     1024 worlds for 200 frames (hierarchy, 32 animables, 32 locomotion
     animators with root motion and dual-quaternion palettes, 64 rigid
     bodies, the 2048-particle storm emitter, the cull pass); the slice
     full_frame_world(10240, 0, 64, 0) at 256 worlds (a smaller W than the
     flagship's, to fit the script's time); the skinned crowd
     skinned_crowd_world(256) (128 animables, 128 locomotion animators, no
     physics) at CROWD_WORLDS worlds; the 1M-particle storm
     particle_stress_world(1_000_000) at 1 world. Each kernel of a path
     launches once per frame (K2 only where there is physics; on the storm
     K1 launches on the world's 8 empty model-instance slots and culls
     nothing, as in the reference); the state stays finite; every character
     is animated, 0 < particles alive <= capacity, root motion moves the
     animators. Then 3 frames at W=4 on the card against the plain versions
     on the CPU, animation and particle fields included (the storm's end
     state tiled to 4 worlds that diverge), and the threefry stream on the
     card against the CPU's, bit for bit;
  6. the 10k-box drop box_drop_pile(10_000) (the slot pipeline, no
     hand-written kernel) as the reference's bench.py --config boxes
     --steps 600 --trials 1 runs it: 600 steps to warm up, then 600 timed
     steps, the state carried through, the slot_drop and column_miss
     certificates summed on the card over all 1200: both 0, the state
     finite, kinetic energy (sum of |v|^2 + |w|^2) below 50 and more than
     90% of the boxes asleep at step 1200 (the reference's recorded end
     state on its TPU: 0.0 and 9887), every sleeping box's centre above
     BOX_SLEEP_Y_MIN; the reference's 10^3-box test bounds the lowest
     centre by 0.47 m, which a 22-level pile breaks (an awake box under
     sleeping ones sinks, in the reference too, PERF.md), so at most
     BOX_BELOW_MAX boxes lie below 0.47 m and none below BOX_LOWEST_MIN,
     bounds set from the card's and the reference's readings; then 3 steps
     from the card's state at step 60 (mid-impact) on the card against the
     CPU, within BODY_POS_ATOL / BODY_VEL_ATOL with equal certificates;
  7. timings with CUDA events: ms/frame and entity-steps/s of each path
     (particle-steps/s of the storm, as bench.py counts it), body-steps/s
     of the boxes, each kernel beside its plain version (plain, kernel,
     kernel, plain; K2 on the settled and the piled problem) and against its
     bound: the bytes it must move over 3.35 TB/s or its operations over 67
     TFLOP/s (fp32), whichever is longer; and the torch ops dispatched per
     frame or step.

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
CROWD_CHARACTERS, CROWD_WORLDS = 256, 1024
STORM_CAPACITY = 1_000_000
N_BOXES, BOX_STEPS, BOX_COMPARE_AT = 10_000, 600, 60  # bench.py: a warm run, then the timed one
BOX_KE_MAX, BOX_ASLEEP_MIN = 50.0, 0.9   # the reference's settle gate (its 10^3 CI test)
BOX_Y_MIN = 0.47         # that test's bound on the lowest box centre; see run_boxes
# At step 1200 awake boxes under sleeping ones sit below BOX_Y_MIN and sink (the reference
# does the same, PERF.md): the card reads 27 such boxes, the lowest at 0.2456 m and sinking
# 1.58e-4 m per step; the JAX package on the CPU reads 20. Held to these readings:
BOX_BELOW_MAX = 30       # boxes whose centre is below BOX_Y_MIN
BOX_LOWEST_MIN = 0.2     # the lowest centre of any box
# a box falls asleep only after its ground depth read at most 8 slop (4 cm) at the start of
# the frame before, and that frame's position pass moves it at most max_correction (4 cm)
# more: a sleeping box's centre stays above 0.5 - 0.08, less a centimetre for its velocity
BOX_SLEEP_Y_MIN = 0.41
# bench.py's recorded TPU run: its end state follows the warm run and the timed one, step 1200
BOX_REFERENCE_END = {"ke_end": 0.0, "sleeping_end": 9887}
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
HBM_BYTES_PER_S = 3.35e12   # one H100 SXM (NVIDIA's data sheet), at its 700 W limit
FP32_FLOP_PER_S = 67e12     # outside the tensor cores
KERNEL_REPS = 50
NO_LIBRARY = "no single PyTorch call computes it"


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


def alternate(plain, kernel, plain_reps: int, kernel_reps: int = KERNEL_REPS):
    """Times in the order plain, kernel, kernel, plain; returns the means."""
    p1 = cuda_time(plain, plain_reps)
    k1, k2 = cuda_time(kernel, kernel_reps), cuda_time(kernel, kernel_reps)
    p2 = cuda_time(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: int, flops: int):
    """(least ms for the work on the card, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_err(xs, ys) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.core import geometry as geom
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.models.demo_scenes import (full_frame_world,
                                                          particle_stress_world, pile_bodies,
                                                          skinned_crowd_world)
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
    for line in ptxas_report(native.build_log()):
        log(f"[2 ptxas] {line}")

    engine, world, _renderer, _anim, _phys = full_frame_world(N_ENTITIES, 0, N_BODIES, 0)
    rm, pm = world.modules["renderer"], world.modules["physics"]
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
    piled = pile_bodies(settle)
    k2_err = 0.0
    problems = {}
    faults = {"one iteration short": 0.0, "one projection pass short": 0.0}
    wide = wide_problem(dev, W, replicate_state)
    for name, s in (("settled", settle), ("piled", piled), ("piled NB=256", wide)):
        prob = pm.solver_problem(s, DT) if name != "piled NB=256" else s
        problems[name] = prob
        n_pair = int(((prob.act != 0) & (prob.body_b >= 0)).sum())
        outk = S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)
        outp = S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS)
        err = max_err(outk, outp)
        ok = all(bool(torch.isfinite(a).all()) for a in outk)
        log(f"[4 K2] {name}: W={prob.vel.shape[0]} NB={prob.vel.shape[-1]} C={prob.act.shape[-1]}"
            f" active {int(prob.act.sum())} (pair stream {n_pair}), max abs err vs plain "
            f"{err:.3e} (limit {S.K2_PLAIN_ATOL:g})")
        if not ok or not err <= S.K2_PLAIN_ATOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err} (finite {ok})")
        if int(prob.act.sum()) == 0 or (name.startswith("piled") and n_pair == 0):
            raise AssertionError(f"K2 check on {name} has no contacts to solve")
        k2_err = max(k2_err, err)
        if name == "piled NB=256":
            continue
        for fault, its in (("one iteration short", (ITERATIONS - 1, POSITION_ITERATIONS)),
                           ("one projection pass short", (ITERATIONS, POSITION_ITERATIONS - 1))):
            faults[fault] = max(faults[fault], max_err(S.solve_plain(prob, *its), outp))
    shown = {k: float(f"{v:.3e}") for k, v in faults.items()}
    log(f"[4 K2] plain version with a planted fault, max abs err vs plain: {shown}")
    if not min(faults.values()) > S.K2_PLAIN_ATOL:
        raise AssertionError(f"the K2 limit {S.K2_PLAIN_ATOL} does not catch a planted fault: {faults}")
    del settle, piled, wide, problems["piled NB=256"]

    # 5. the main paths
    stream = check_threefry(dev)
    log(f"[5 rng] threefry on the card vs the CPU, first 8 words of one draw: {stream}")
    flag = full_frame_world(N_ENTITIES, N_CHARACTERS, N_BODIES, N_PARTICLES)
    runs = {"flagship": run_path("flagship", flag, W, dev, replicate_state, map_tensors),
            "slice": run_path("slice", (engine, world), SLICE_WORLDS, dev, replicate_state,
                              map_tensors, step=step),
            "crowd": run_path("crowd", skinned_crowd_world(CROWD_CHARACTERS), CROWD_WORLDS, dev,
                              replicate_state, map_tensors),
            "particles": run_path("particles", particle_stress_world(STORM_CAPACITY), 1, dev,
                                  replicate_state, map_tensors)}
    runs["particles"].update(units=STORM_CAPACITY, unit="particle")  # bench.py's unit here

    # 6. the 10k-box drop
    boxes = run_boxes(dev)

    # 7. timings
    k1_ms, k1_plain = alternate(lambda: cull.frustum_cull_plain(centers, radii, cam_planes),
                                lambda: cull.frustum_cull_cuda(centers, radii, cam_planes), 20)
    k1_bound, k1_by = bound(cull.k1_bytes(W, N_ENTITIES), cull.k1_flops(W, N_ENTITIES))
    k2 = {}
    for name in ("settled", "piled"):
        prob = problems[name]
        w_, _, nb = prob.vel.shape
        c = prob.act.shape[-1]
        n_active = int(prob.act.sum())
        n_pair = int(((prob.act != 0) & (prob.body_b >= 0)).sum())
        ms, plain_ms = alternate(lambda: S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS),
                                 lambda: S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS), 5)
        nbytes = S.k2_bytes(w_, nb, c, int((prob.act != 0).sum()))
        bound_ms, by = bound(nbytes, S.k2_flops(w_, nb, c, n_active, n_pair, ITERATIONS,
                                                POSITION_ITERATIONS))
        k2[name] = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_by": by, "share_of_bound": bound_ms / ms, "W": w_, "C": c}
        log(f"[7 K2] {card}: {name} W={w_} NB={nb} C={c} (active {n_active}): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {nbytes} bytes, bound {bound_ms:.4f} ms ({by}), share of bound "
            f"{bound_ms / ms:.3f}")
    prob = problems["settled"]
    paths = "; ".join(
        f"{name} {r['ms']:.3f} ms/frame at W={r['worlds']} = "
        f"{r['worlds'] * r['units'] / (r['ms'] / 1e3):.4g} {r['unit']}-steps/s ({r['ops']} ops/frame)"
        for name, r in runs.items())
    log(f"[7 time] {card}: {paths}; boxes {boxes['ms']:.3f} ms/step at {N_BOXES} bodies = "
        f"{N_BOXES / (boxes['ms'] / 1e3):.4g} body-steps/s ({boxes['ops']} ops/step);"
        f" K1 [{W},3,{N_ENTITIES}] {k1_ms:.4f} ms (plain {k1_plain:.4f} ms, bound {k1_bound:.4f} ms);"
        f" K2 settled W={prob.vel.shape[0]} C={prob.act.shape[-1]} {k2['settled']['ms']:.4f} ms "
        f"(plain {k2['settled']['plain_ms']:.4f} ms, bound {k2['settled']['bound_ms']:.4f} ms)")

    main_launches = runs["flagship"]["launches"]
    kernels = [
        {"name": "K1 frustum_cull", "route": "cuda", "source": "lumixengine_tpu_torch/csrc/cull.cu",
         "replaces": "lumixengine_tpu/ops/culling.py:54", "launches": main_launches["K1"],
         "launches_slice": runs["slice"]["launches"]["K1"],
         "launches_crowd": runs["crowd"]["launches"]["K1"],
         "launches_particles": runs["particles"]["launches"]["K1"],
         "max_abs_err": k1_err, "mismatches": k1_bad, "ms": k1_ms, "plain_ms": k1_plain,
         "bytes": cull.k1_bytes(W, N_ENTITIES), "bound_ms": k1_bound, "bound_by": k1_by,
         "bound_of": k1_by, "share_of_bound": k1_bound / k1_ms, "library_ms": None,
         "library_note": NO_LIBRARY},
        {"name": "K2 solve_contacts_fused", "route": "cuda",
         "source": "lumixengine_tpu_torch/csrc/solver.cu",
         "replaces": "lumixengine_tpu/ops/solver_pallas.py:165", "launches": main_launches["K2"],
         "launches_slice": runs["slice"]["launches"]["K2"],
         "max_abs_err": k2_err, "ms": k2["settled"]["ms"], "plain_ms": k2["settled"]["plain_ms"],
         "bytes": k2["settled"]["bytes"], "bound_ms": k2["settled"]["bound_ms"],
         "bound_by": k2["settled"]["bound_by"], "bound_of": k2["settled"]["bound_by"],
         "share_of_bound": k2["settled"]["share_of_bound"], "ms_piled": k2["piled"]["ms"],
         "plain_ms_piled": k2["piled"]["plain_ms"], "bound_ms_piled": k2["piled"]["bound_ms"],
         "share_of_bound_piled": k2["piled"]["share_of_bound"], "library_ms": None,
         "library_note": NO_LIBRARY},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def ptxas_report(log: str):
    """One line per kernel from nvcc's ptxas output: its name, then its
    stack, spills, registers and shared memory."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            name = ("K2 compact" if "solve_kernelILb1" in fn else "K2 in place"
                    if "solve_kernel" in fn else "K1" if "cull" in fn else fn)
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def wide_problem(dev, num_worlds, replicate_state):
    """K2's operands at the largest shape the module makes: the slice world
    with 256 bodies, full_frame_world(2048, 0, 256, 0), its bodies piled up
    as in phase 4 (NB=256, C=7168), at `num_worlds` worlds."""
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world, pile_bodies

    _e, world, _r, _a, _p = full_frame_world(2048, 0, 256, 0)
    state = replicate_state(world.device_state(dev), num_worlds,
                            torch.Generator(device=dev).manual_seed(5))
    return world.modules["physics"].solver_problem(pile_bodies(state), DT)


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
    and checked, then the 3-frame compare against the CPU. The checks follow
    the world's modules: contacts where there is physics, characters where
    there is animation, particles where there is an emitter."""
    import torch

    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import solver as S

    engine, world = built[0], built[1]
    rm = world.modules["renderer"]
    has_physics, an = "physics" in world.modules, world.modules.get("animation")
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
    visible = rs.counters["visible_count"]
    alive = rs.counters["particles_alive"]
    n_inst = int((rm.statics().mi_slots >= 0).sum())
    facts = [f"{FRAMES} frames in {wall:.2f} s", f"launches {launches}", f"finite {finite}",
             f"visible min/mean {int(visible.min())}/{float(visible.float().mean()):.1f} of "
             f"{n_inst}"]
    if has_physics:
        active = state.modules["physics"].counters["active_contacts"]
        facts.append(f"active contacts {int(active.sum())} (worlds with contacts "
                     f"{int((active > 0).sum())})")
    n_char = 0
    if an is not None:
        ams = state.modules["animation"]
        animated = ams.counters["animated"]        # the animables, as the reference counts
        posed = (ams.pose_pos != 0).any(dim=-3).any(dim=-2).sum(dim=-1)  # pool columns written
        moved = _root_motion(world, start, state)
        n_char = len(an.animables) + len(an.animators)
        facts.append(f"characters animated min/max {int(posed.min())}/{int(posed.max())} "
                     f"(animables {int(animated.min())}); animators moved min/max "
                     f"{moved[0]:.3f}/{moved[1]:.3f} m")
    cap = sum(ps.caps[e] for _k, (_e, ps) in rm.particle_emitters.items() for e in ps.caps)
    if cap:
        facts.append(f"particles alive min/max {int(alive.min())}/{int(alive.max())} of {cap}")
    log(f"[5 {name}] W={num_worlds}: " + "; ".join(facts))
    expected = {"K1": FRAMES, "K2": FRAMES if has_physics else 0}
    if launches != expected:
        raise AssertionError(f"each kernel of the path must launch once per frame: {launches}")
    if not finite or (n_inst and int(visible.min()) <= 0):
        raise AssertionError("state is not finite, or no instance is visible")
    if has_physics and int(active.sum()) == 0:
        raise AssertionError("no contacts")
    if an is not None and not (bool((animated == len(an.animables)).all())
                               and bool((posed == n_char).all())):
        raise AssertionError(f"characters animated {posed.unique().tolist()} (expected {n_char};"
                             f" animables {animated.unique().tolist()})")
    if an is not None and len(an.animators) and not moved[2]:
        raise AssertionError(f"root motion did not move the animators: {moved}")
    if cap and not (int(alive.min()) > 0 and int(alive.max()) <= cap):
        raise AssertionError(f"particles alive {int(alive.min())}..{int(alive.max())} "
                             f"(capacity {cap})")
    del start
    ops = op_counts(world, state, dev)
    log(f"[5 {name}] torch ops dispatched in one frame at W={num_worlds} (views excluded, "
        f"K1/K2 launches not counted): {sum(ops.values())} = {ops}")
    if num_worlds >= 4:
        cmp_state = map_tensors(lambda t: t[:4].clone(), state)
    else:   # a one-world path: its end state tiled to 4 worlds, which diverge
        cmp_state = replicate_state(map_tensors(lambda t: t[0], state), 4,
                                    torch.Generator(device=dev).manual_seed(4))
    del state
    cmp = compare_with_plain(engine, world, cmp_state, step)
    log(f"[5 {name}] {n_char} characters; 3 frames at W={cmp_state.local.pos.shape[0]}, card vs "
        f"plain on the CPU: max abs err {cmp['errs']}, boundary flips {cmp['flips']}, kill flips "
        f"{cmp['kills']}")
    return {"ms": ms_frame, "worlds": num_worlds, "units": world.capacity, "unit": "entity",
            "launches": launches, "ops": sum(ops.values())}


def run_boxes(dev):
    """The 10k-box drop: two runs of BOX_STEPS steps on the card (the second
    timed with CUDA events), the certificates summed on the card and read
    once; the settle gate at the end; the ops of one step; 3 steps from step
    BOX_COMPARE_AT, card vs CPU."""
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import box_drop_pile

    step, (pos, rot, vel, ang, carry), consts = box_drop_pile(N_BOXES, device=dev)
    dt = torch.tensor(DT, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    drop, miss, max_cand, max_active = zero, zero, zero, zero
    walls = []
    for run in range(2):
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for i in range(BOX_STEPS):
            if run == 0 and i == BOX_COMPARE_AT:
                mid = (pos, rot, vel, ang, carry)  # the step makes new tensors: no copy needed
            pos, rot, vel, ang, ctr, carry = step(pos, rot, vel, ang, dt, carry, consts)
            drop = drop + ctr["slot_drop"]
            miss = miss + ctr["column_miss"]
            max_cand = torch.maximum(max_cand, ctr["max_candidates"])
            max_active = torch.maximum(max_active, ctr["active_contacts"])
        ev1.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            v2 = (vel * vel).sum(0) + (ang * ang).sum(0)
            half = {"ke": float(v2.sum()), "asleep": int((v2 == 0.0).sum()),
                    "lowest": float(pos[1].min()), "below": int((pos[1] < BOX_Y_MIN).sum())}
    ms = ev0.elapsed_time(ev1) / BOX_STEPS
    finite = all(bool(torch.isfinite(t).all()) for t in (pos, rot, vel, ang))
    v2 = (vel * vel).sum(0) + (ang * ang).sum(0)
    end = {"ke_end": float(v2.sum()), "sleeping_end": int((v2 == 0.0).sum())}
    y_min = float(pos[1].min())
    asleep = v2 == 0.0
    y_sleep = float(torch.where(asleep, pos[1], float("inf")).min())
    deep = pos[1] < BOX_Y_MIN
    n_deep, n_deep_awake = int(deep.sum()), int((deep & ~asleep).sum())
    log(f"[6 boxes] {N_BOXES} boxes, 2 x {BOX_STEPS} steps in {walls[0]:.2f} + {walls[1]:.2f} s "
        f"(timed run {ms:.3f} ms/step = {N_BOXES / (ms / 1e3):.4g} body-steps/s); at step "
        f"{BOX_STEPS}: {half}; at step {2 * BOX_STEPS}: slot_drop {int(drop)}, column_miss "
        f"{int(miss)}, finite {finite}, lowest centre {y_min:.4f} m (of a sleeping box "
        f"{y_sleep:.4f} m), boxes below {BOX_Y_MIN} m {n_deep} ({n_deep_awake} awake), max "
        f"candidates "
        f"{int(max_cand)}, active contacts at the end {int(ctr['active_contacts'])} (max "
        f"{int(max_active)}), sleeping {int(ctr['sleeping'])}; end state {end} (the "
        f"reference's recorded run: {BOX_REFERENCE_END})")
    if int(drop) or int(miss) or not finite:
        raise AssertionError("the box drop fired a certificate or is not finite")
    if not (y_sleep > BOX_SLEEP_Y_MIN and y_min > BOX_LOWEST_MIN and n_deep <= BOX_BELOW_MAX):
        raise AssertionError(f"a box sank to {y_min} m (limit {BOX_LOWEST_MIN}), a sleeping one "
                             f"to {y_sleep} m (limit {BOX_SLEEP_Y_MIN}); {n_deep} boxes below "
                             f"{BOX_Y_MIN} m (limit {BOX_BELOW_MAX})")
    if not (end["ke_end"] < BOX_KE_MAX and end["sleeping_end"] > BOX_ASLEEP_MIN * N_BOXES):
        raise AssertionError(f"the pile did not come to rest: {end}")
    _, n_ops = count_ops(lambda: step(*mid[:4], dt, mid[4], consts))
    # the step never waits for the card: any synchronizing call raises here
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*mid[:4], dt, mid[4], consts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"[6 boxes] torch ops dispatched in one step: {n_ops}; one step ran with every "
        f"synchronizing CUDA call an error")

    cpu_consts = step.init_consts("cpu")
    gpu, cpu = mid, _to_cpu(mid)
    errs = {}
    for _ in range(3):
        *gb, gctr, gcarry = step(*gpu[:4], dt, gpu[4], consts)
        *cb, cctr, ccarry = step(*cpu[:4], torch.tensor(DT, dtype=torch.float32), cpu[4],
                                 cpu_consts)
        gpu, cpu = (*gb, gcarry), (*cb, ccarry)
        for name, g, c, atol in zip(("pos", "rot", "vel", "angvel"), gb, cb,
                                    (BODY_POS_ATOL, BODY_POS_ATOL, BODY_VEL_ATOL,
                                     BODY_VEL_ATOL)):
            err = float((g.cpu() - c).abs().max())
            errs[name] = max(errs.get(name, 0.0), err)
            if not err <= atol:
                raise AssertionError(f"boxes {name}: card vs plain {err} > {atol}")
        certs = {k: (int(gctr[k]), int(cctr[k])) for k in ("slot_drop", "column_miss")}
        if any(a != b for a, b in certs.values()):
            raise AssertionError(f"boxes certificates differ, card vs CPU: {certs}")
    log(f"[6 boxes] 3 steps from step {BOX_COMPARE_AT}, card vs plain on the CPU: max abs err "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }, active contacts "
        f"{int(gctr['active_contacts'])} / {int(cctr['active_contacts'])}, certificates {certs}")
    return {"ms": ms, "ops": n_ops, **end}


def _to_cpu(tree):
    if isinstance(tree, tuple):
        return tuple(_to_cpu(t) for t in tree)
    return tree.cpu()


def count_ops(fn):
    """(fn(), the number of non-view torch ops it dispatched). Each is about
    one kernel launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        out = fn()
    return out, c.n


def op_counts(world, state, dev):
    """The torch ops one frame dispatches, per module phase, counted on the
    host as the phases of Engine.build_step run on `state`."""
    import torch

    from lumixengine_tpu_torch.ops import hierarchy as hier

    counts = {}
    dt = torch.tensor(DT, dtype=torch.float32, device=dev)

    def run(key, fn):
        out, n = count_ops(fn)
        if n:
            counts[key] = counts.get(key, 0) + n
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
    an = world.modules.get("animation")
    cpu_step = engine.build_step(world, "cpu", extra=rm.cull_pass)
    body = np.zeros(world.capacity, bool)
    if "physics" in world.modules:
        pst = world.modules["physics"].statics()
        body[pst.entity_slots[pst.dyn_mask]] = True
    mi_body = body[rm.statics().mi_slots.clip(0)]
    char = np.zeros(world.capacity, bool)
    for store in (an.animables, an.animators) if an is not None else ():
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
        tolerances = [(("pos", "rot"), "physics", BODY_POS_ATOL),
                      (("vel", "angvel", "lam_n", "lam_t1", "lam_t2"), "physics", BODY_VEL_ATOL),
                      (("an_time", "ctrl_clocks"), "animation", CLOCK_ATOL),
                      (("pose_pos", "pose_rot", "palette"), "animation", POSE_ATOL)]
        for fields, module, atol in tolerances:
            for f in fields if module in world.modules else ():
                k = f"modules.{module}.{f}"
                close(f"{module}.{f}", got[k], ref[k], atol)
        for k in ("modules.physics.sleep", "modules.physics.pair_key", "frame",
                  "modules.animation.counters.animated", "modules.renderer.prng"):
            if k in ref and not np.array_equal(got[k], ref[k]):
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

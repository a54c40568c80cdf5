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
     1024 worlds for FRAMES frames (hierarchy, 32 animables, 32 locomotion
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
     animators. K1 is then held bit for bit to its plain version on the
     operands the path's own cull pass gives it, at the path's W and K (the
     world camera and a random view per world). Then 3 frames at W=4 on the
     card against the plain versions
     on the CPU, animation and particle fields included (the storm's end
     state tiled to 4 worlds that diverge), and the threefry stream on the
     card against the CPU's, bit for bit. Two paths of the RenderModule's
     views follow: the headless demo tick headless_demo_world(2048) at
     W=4096 (BASELINE config 1, bench.py --config demo), and the render
     config, the full flagship at W=1024 with each frame followed by
     shadow_pass (4 cascades, LIGHT_DIR) and fill_clusters on every world
     (bench.py --config render), their caster counts, cluster counts and
     overflow summed and read. After the timed frames, one prepare_view in
     each sort mode (K1 once a call) with its draw order checked, and
     record_frame on world 0; the torch ops of prepare_view, the shadow pass
     and the cluster pass; the cluster pass timed against its bound (on
     both paths; the bound counts the live lights only). Each
     path's 3-frame compare also holds prepare_view (both sort modes), the
     caster masks and the cluster words, lists, counts and overflow to the
     CPU's outside their margins (the port's pipeline.DEPTH_EPS,
     shadows.SHADOW_MARGIN and clusters.CLUSTER_D2_EPS). Then a small crowd
     with two bone attachments, K1 against plain on its operands, 3 frames
     card vs CPU, each attachment at its bone's pose;
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
  7. the PhysicsModule beyond the flagship, each path with the launch counts
     set to 0 just before it and read just after: the nine committed
     goldens (tests/data/golden_*.npz) at W=1 for their full step counts,
     each held to the bounds of the JAX package's
     tests/test_golden_trajectories.py (capsule_stack, whose outcome
     rounding decides, as an ensemble of 64 starts held to the JAX
     package's count of worlds within the bounds), K2 launching once a
     step wherever there is a contact stream and held to its plain version
     on each world's last contact set; a world farm: hinge_pendulum and
     capsule_stack each replicated to 4096 diverging worlds for FARM_FRAMES frames
     (ms/frame, body-steps/s of the dynamic bodies, torch ops per frame, K2
     on the farm's contact set against plain, timed and against its bound);
     the banded branch, which `auto` picks above 256 actor slots: a
     10,000-box block on the bench's grid at 10,240 slots (sweep window 40),
     BANDED_STEPS steps at W=1
     (ms/step, the window certificate summed on the card: 0, finite, the
     lowest box centre), then a 1,000-box block 90 steps in, 3 steps on the
     card against the CPU; and ballistic and d6_slider on the card and on
     the CPU side by side for their full arcs: each physics field's largest
     gap, the first step past GAP_LIMIT, and the first torch op whose
     outputs differ (first_divergent_op); then the game content of
     models/physics_scenes.py: the props farm (hulls on boxes and hulls,
     SDF mesh colliders, CCD spheres at a thin slab and head-on, instanced
     cubes and hulls; W=4096), the drive farm (a four-wheel vehicle under
     throttle and steer, a walking character controller, 64 rays and 64
     sphere sweeps a world each frame; W=4096) and the terrain farm (a
     seeded 64 x 64 heightfield, dropped bodies, a walking controller;
     W=1024), each for its JAX tests' settle time with world 0 as built and
     the others perturbed: ms/frame, body-steps/s, torch ops a frame, K2
     launching once a frame and held to its plain version on the farm's
     end contact set (timed, against its bound), the scene's physical checks
     on every world (resting heights, no tunnelling through the thin mesh,
     the vehicle moving forward and turning, the controller grounded), the
     device time of the new layers (polytope SAT, SDF streams, CCD,
     heightfield, vehicles, queries) and 3 frames card vs CPU; and the
     banded props level, 1,024 random hulls in the JAX pile test's stacks
     of five over an SDF slab and the ground at 1,024 actor slots (`auto`
     picks the banded branch), BANDED_PROPS_STEPS steps at W=1 with every
     step's window certificate printed, that test's settle bounds hull by
     hull (at most BANDED_PROPS_UNSETTLED hulls outside them), and 3 steps
     card vs CPU on 4 of its stacks;
  8. timings with CUDA events: ms/frame and entity-steps/s of each path
     (demo and render included), the cluster pass against its bound
     (particle-steps/s of the storm, as bench.py counts it), body-steps/s
     of the boxes, of the farms, the game farms and the banded blocks, each kernel beside
     its plain version (plain, kernel, kernel, plain; K2 on the settled and
     the piled problem) and against its bound: the bytes it must move over
     3.35 TB/s or its operations over 67 TFLOP/s (fp32), whichever is
     longer; and the torch ops dispatched per frame or step.

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
# the main paths' depth: 50 frames (100 before the game content joined the script)
WORLDS, FRAMES, WARM_FRAMES, SETTLE_FRAMES = 1024, 50, 10, 240
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
# the PhysicsModule beyond the flagship: the goldens at W=1, two of them as a world farm,
# and a block of boxes on the banded branch (bench.py's grid, 10240 actor slots)
FARM_GOLDENS, FARM_WORLDS, FARM_FRAMES = ("hinge_pendulum", "capsule_stack"), 4096, 100
BANDED_BOXES, BANDED_CAPACITY, BANDED_STEPS = 10_000, 10_240, 120   # 300 before the game content
# the sweep window (sap_neighbors) of the banded block: over 300 steps of the 10k block the
# card's window certificate summed 1,602,273 at the module's default 16, 4,318 at 32 and 0 at
# 40 and 48 (tools/banded_window.py; at 1,000 boxes the JAX package on the CPU summed 8,206 at
# 16, 72 at 24 and 0 at 32): the narrowest window measured to hold every contact
BANDED_WINDOW = 40
BANDED_COMPARE_BOXES, BANDED_COMPARE_CAPACITY, BANDED_COMPARE_AT = 1000, 1024, 90
SANE_SPEED = 50.0        # m/s and rad/s: K2 is held to plain on farm worlds below it
# the game-content farms (models/physics_scenes.py) and the banded props level
GAME_WORLDS = {"props": 4096, "drive": 4096, "terrain": 1024}
# the banded props level: its hulls, and how many may end unsettled (physics_scenes.
# check_banded_props). The JAX pile test's bounds hold for its 5 hulls; on a pile of hundreds
# both packages leave a few hulls outside them at random: on the level scaled to 256 hulls
# (tools/banded_props_layouts.py on the CPU, seeds 7-12) the JAX package left 0-3 and the port
# 0-6, so the level allows the JAX package's worst share, 3 of 256
BANDED_PROPS_HULLS = 1024
BANDED_PROPS_UNSETTLED = 3 * BANDED_PROPS_HULLS // 256
# the card-vs-CPU compare: hulls (4 of the level's stacks, all on the slab), actor slots, steps
# before its 3 steps, when the stacks are falling onto each other
BANDED_PROPS_COMPARE = (20, 300, 60)
LAYER_REPS = 20
# the headless demo tick (bench.py --config demo at headless_demo_world's default, ~2k entities;
# bench.py's CLI default would build 10,240) at bench.py's default world count
DEMO_ENTITIES, DEMO_WORLDS = 2048, 4096
LIGHT_DIR = (0.3, -1.0, 0.2)   # bench.py --config render's shadow light
GAP_GOLDENS, GAP_LIMIT = ("ballistic", "d6_slider"), 1e-5   # the card-vs-CPU golden gap
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data")
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


def random_planes(num_worlds: int, dev, seed: int = 2):
    """A random perspective view per world: planes [W, 8, 4]."""
    import torch

    from lumixengine_tpu_torch.core import geometry as geom

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((num_worlds, 4), generator=g, device=dev)
    eye = torch.randn((num_worlds, 3), generator=g, device=dev) * 20.0
    return geom.perspective_frustum(eye, q / q.norm(dim=-1, keepdim=True),
                                    1.2, 16 / 9, 0.3, 150.0).planes.contiguous()


def k1_check(centers, radii, plane_sets):
    """K1 against its plain version over the same spheres, for each plane
    set [W, 8, 4]: (mismatches, max abs err, visible fraction of each set)."""
    import torch

    from lumixengine_tpu_torch.ops import culling as cull

    bad, err, fracs = 0, 0.0, []
    for planes in plane_sets:
        vk = cull.frustum_cull_cuda(centers, radii, planes)
        vp = cull.frustum_cull_plain(centers, radii, planes)
        torch.cuda.synchronize()
        bad += int((vk != vp).sum())
        err = max(err, max_err([vk.float()], [vp.float()]))
        fracs.append(float(vk.float().mean()))
    return bad, err, fracs


def k1_on_path(name, world, state):
    """K1 against its plain version on the operands the path's cull pass
    gives it at the path's own W and K: the world camera and a random view
    per world. Raises on a mismatch."""
    from lumixengine_tpu_torch.renderer import pipeline

    rm = world.modules["renderer"]
    frustum, centers, radii = pipeline.cull_operands(state, state.modules["renderer"], rm.statics())
    centers, radii = centers.contiguous(), radii.contiguous()
    w = centers.shape[0]
    bad, err, fracs = k1_check(centers, radii, (frustum.planes.contiguous(),
                                                random_planes(w, centers.device)))
    shape = list(centers.shape)
    log(f"[5 {name}] K1 on the path's own operands {shape}, world camera and random views: "
        f"{bad} mismatches with the plain version (visible fractions "
        f"{[float(f'{f:.4f}') for f in fracs]})")
    if bad:
        raise AssertionError(f"K1 is not bit-exact on the {name} path: {bad} mismatches")
    return {"mismatches": bad, "max_abs_err": err, "shape": shape}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
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
    k1_bad, k1_err, fracs = k1_check(centers, radii, (cam_planes, random_planes(W, dev)))
    log(f"[3 K1] [{W},3,{centers.shape[-1]}] world-camera and random views: "
        f"{k1_bad} mismatches with the plain version")
    if k1_bad:
        raise AssertionError(f"K1 is not bit-exact: {k1_bad} mismatches")
    if not all(0.0 < f < 1.0 for f in fracs):
        raise AssertionError(f"K1 check is degenerate: visible fractions {fracs}")

    # 4. K2 on the main path's shapes: settled contact sets, and the same worlds piled up
    settle = replicate_state(single, W, torch.Generator(device=dev).manual_seed(3))
    for _ in range(SETTLE_FRAMES):
        settle = step(settle, DT)
    piled = pile_bodies(settle)
    k2_err = 0.0
    problems = {}
    faults = {"one iteration short": 0.0, "one projection pass short": 0.0}
    wide = wide_problem(dev, W, replicate_state)
    k2_shapes = {}
    for name, s in (("settled", settle), ("piled", piled), ("piled NB=256", wide)):
        prob = pm.solver_problem(s, DT) if name != "piled NB=256" else s
        problems[name] = prob
        k2_shapes[f"phase 4 {name}"] = [prob.vel.shape[0], prob.vel.shape[-1], prob.act.shape[-1]]
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
    from lumixengine_tpu_torch.models.demo_scenes import headless_demo_world

    runs["demo"] = run_path("demo", headless_demo_world(DEMO_ENTITIES), DEMO_WORLDS, dev,
                            replicate_state, map_tensors, views=True)
    runs["render"] = run_path("render", flag, W, dev, replicate_state, map_tensors, views=True,
                              passes=True)
    attach = run_attachments(dev, replicate_state)

    # 6. the 10k-box drop
    boxes = run_boxes(dev)

    # 7. the PhysicsModule: the goldens, the farm, the banded branch
    goldens = run_goldens(dev)
    gaps = {name: golden_gap(name, dev) for name in GAP_GOLDENS}
    farms = {name: run_farm(name, dev, replicate_state) for name in FARM_GOLDENS}
    banded = run_banded(dev)
    game = {kind: run_game(kind, dev, card) for kind in GAME_WORLDS}
    banded_props = run_banded_props(dev, card)

    # 8. timings
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
        log(f"[8 K2] {card}: {name} W={w_} NB={nb} C={c} (active {n_active}): {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {nbytes} bytes, bound {bound_ms:.4f} ms ({by}), share of bound "
            f"{bound_ms / ms:.3f}")
    prob = problems["settled"]
    paths = "; ".join(
        f"{name} {r['ms']:.3f} ms/frame at W={r['worlds']} = "
        f"{r['worlds'] * r['units'] / (r['ms'] / 1e3):.4g} {r['unit']}-steps/s ({r['ops']} ops/frame)"
        for name, r in runs.items())
    log(f"[8 time] {card}: {paths}; boxes {boxes['ms']:.3f} ms/step at {N_BOXES} bodies = "
        f"{N_BOXES / (boxes['ms'] / 1e3):.4g} body-steps/s ({boxes['ops']} ops/step);"
        f" K1 [{W},3,{N_ENTITIES}] {k1_ms:.4f} ms (plain {k1_plain:.4f} ms, bound {k1_bound:.4f} ms);"
        f" K2 settled W={prob.vel.shape[0]} C={prob.act.shape[-1]} {k2['settled']['ms']:.4f} ms "
        f"(plain {k2['settled']['plain_ms']:.4f} ms, bound {k2['settled']['bound_ms']:.4f} ms)")

    log(f"[8 time] {card}: " + "; ".join(
        f"farm {name} {r['ms']:.3f} ms/frame at W={FARM_WORLDS} = {r['rate']:.4g} body-steps/s "
        f"({r['ops']} ops/frame)" for name, r in farms.items())
        + f"; banded {BANDED_BOXES} boxes {banded['ms']:.3f} ms/step = "
        f"{BANDED_BOXES / (banded['ms'] / 1e3):.4g} body-steps/s ({banded['ops']} ops/step)")
    for name in ("render", "demo"):
        cl = runs[name]["clusters"]
        log(f"[8 clusters] {card}: fill_clusters on the {name} path at W={cl['W']}, C={cl['C']}, "
            f"{cl['L_live']} lights in {cl['L']} slots (padded to {cl['L_pad']}): {cl['ms']:.4f} ms "
            f"a call on the card's clock (enqueue {cl['enqueue_ms']:.4f} ms), {cl['ops']} torch "
            f"ops; bound {cl['bound_ms']:.4f} ms ({cl['bound_by']}: {cl['bytes']} bytes, "
            f"{cl['flops']} float ops over the live lights), share of bound "
            f"{cl['bound_ms'] / cl['ms']:.6f}; over every padded light slot, as the pass computes "
            f"them: {cl['flops_padded']} float ops, {cl['bound_ms_padded']:.4f} ms, share "
            f"{cl['bound_ms_padded'] / cl['ms']:.6f}")
    k1_paths = {name: r["k1"] for name, r in runs.items()}
    k1_paths["attachments"] = attach["k1"]
    k1_bad += sum(r["mismatches"] for r in k1_paths.values())
    k1_err = max(k1_err, *(r["max_abs_err"] for r in k1_paths.values()))
    log(f"[8 goldens] card vs CPU over the full arcs: {gaps}")
    log(f"[8 time] {card}: " + "; ".join(
        f"{kind} {r['ms']:.3f} ms/frame at W={r['worlds']} = {r['rate']:.4g} body-steps/s "
        f"({r['ops']} ops/frame), K2 {r['k2']['ms']:.4f} ms (plain {r['k2']['plain_ms']:.4f}, "
        f"bound {r['k2']['bound_ms']:.4f})" for kind, r in game.items())
        + f"; banded props {BANDED_PROPS_HULLS} hulls {banded_props['ms']:.3f} ms/step = "
        f"{BANDED_PROPS_HULLS / (banded_props['ms'] / 1e3):.4g} body-steps/s "
        f"({banded_props['ops']} ops/step)")
    k2_shapes.update({f"farm {name}": [r["k2"]["W"], r["k2"]["NB"], r["k2"]["C"]]
                      for name, r in farms.items()})
    k2_shapes.update({kind: [r["k2"]["W"], r["k2"]["NB"], r["k2"]["C"]] for kind, r in game.items()})
    main_launches = runs["flagship"]["launches"]
    kernels = [
        {"name": "K1 frustum_cull", "route": "cuda", "source": "lumixengine_tpu_torch/csrc/cull.cu",
         "replaces": "lumixengine_tpu/ops/culling.py:54", "launches": main_launches["K1"],
         "launches_slice": runs["slice"]["launches"]["K1"],
         "launches_crowd": runs["crowd"]["launches"]["K1"],
         "launches_particles": runs["particles"]["launches"]["K1"],
         "launches_demo": runs["demo"]["launches"]["K1"],
         "launches_render": runs["render"]["launches"]["K1"],
         "launches_prepare_view": runs["render"]["view_launches"] + runs["demo"]["view_launches"],
         "launches_attachments": attach["launches"]["K1"],
         "launches_physics": goldens["launches"]["K1"] + banded["launches"]["K1"]
         + banded_props["launches"]["K1"] + sum(r["launches"]["K1"] for r in (*farms.values(),
                                                                              *game.values())),
         "max_abs_err": k1_err, "mismatches": k1_bad,
         "checked_shapes": {"phase 3": [W, 3, N_ENTITIES], **{
             name: r["shape"] for name, r in k1_paths.items()}},
         "ms": k1_ms, "plain_ms": k1_plain,
         "bytes": cull.k1_bytes(W, N_ENTITIES), "bound_ms": k1_bound, "bound_by": k1_by,
         "bound_of": k1_by, "share_of_bound": k1_bound / k1_ms, "library_ms": None,
         "library_note": NO_LIBRARY},
        {"name": "K2 solve_contacts_fused", "route": "cuda",
         "source": "lumixengine_tpu_torch/csrc/solver.cu",
         "replaces": "lumixengine_tpu/ops/solver_pallas.py:165", "launches": main_launches["K2"],
         "launches_slice": runs["slice"]["launches"]["K2"],
         "launches_render": runs["render"]["launches"]["K2"],
         "launches_goldens": goldens["launches"]["K2"],
         "launches_farm": {name: r["launches"]["K2"] for name, r in farms.items()},
         "launches_banded": banded["launches"]["K2"],
         "launches_game": {**{kind: r["launches"]["K2"] for kind, r in game.items()},
                           "banded_props": banded_props["launches"]["K2"]},
         "max_abs_err": max(k2_err, goldens["k2_err"], *(r["k2"]["max_abs_err"]
                                                          for r in (*farms.values(),
                                                                    *game.values()))),
         "checked_shapes": {"[W, NB, C]": k2_shapes},
         "ms": k2["settled"]["ms"], "plain_ms": k2["settled"]["plain_ms"],
         "bytes": k2["settled"]["bytes"], "bound_ms": k2["settled"]["bound_ms"],
         "bound_by": k2["settled"]["bound_by"], "bound_of": k2["settled"]["bound_by"],
         "share_of_bound": k2["settled"]["share_of_bound"], "ms_piled": k2["piled"]["ms"],
         "plain_ms_piled": k2["piled"]["plain_ms"], "bound_ms_piled": k2["piled"]["bound_ms"],
         "share_of_bound_piled": k2["piled"]["share_of_bound"],
         "farm": {name: r["k2"] for name, r in farms.items()},
         "game": {kind: r["k2"] for kind, r in game.items()}, "library_ms": None,
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


def run_path(name, built, num_worlds, dev, replicate_state, map_tensors, step=None, views=False,
             passes=False):
    """FRAMES frames of one path at `num_worlds` worlds on the card, timed
    and checked, then the 3-frame compare against the CPU. The checks follow
    the world's modules: contacts where there is physics, characters where
    there is animation, particles where there is an emitter. With `passes`
    each frame is followed by the shadow and cluster passes (the render
    config); with `views` prepare_view, record_frame and the passes are
    checked and counted after the timed frames and in the compare."""
    import torch

    engine, world = built[0], built[1]
    rm = world.modules["renderer"]
    has_physics, an = "physics" in world.modules, world.modules.get("animation")
    if step is None:
        step = engine.build_step(world, dev, extra=rm.cull_pass)
    frame = render_frame(step, rm) if passes else step
    state = replicate_state(world.device_state(dev), num_worlds,
                            torch.Generator(device=dev).manual_seed(0))
    start = state
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _zero_launches()
    t0 = time.perf_counter()
    for f in range(FRAMES):
        if f == WARM_FRAMES:
            ev0.record()
        state = frame(state, DT)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    ms_frame = ev0.elapsed_time(ev1) / (FRAMES - WARM_FRAMES)
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    rs = state.modules["renderer"]
    visible = rs.counters["visible_count"]
    alive = rs.counters["particles_alive"]
    n_inst = int((rm.statics().mi_slots >= 0).sum())
    facts = [f"{FRAMES} frames in {wall:.2f} s", f"launches {launches}", f"finite {finite}",
             f"visible min/mean {int(visible.min())}/{float(visible.float().mean()):.1f} of "
             f"{n_inst}"]
    if passes:
        facts.append(f"shadow casters + cluster lights + overflow summed over the frames "
                     f"{int(frame.probe)}")
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
    if passes and int(frame.probe) <= 0:
        raise AssertionError("the shadow and cluster passes found no caster and no light")
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
    k1 = k1_on_path(name, world, state)
    ops = op_counts(world, state, dev, passes=passes)
    log(f"[5 {name}] torch ops dispatched in one frame at W={num_worlds} (views excluded, "
        f"K1/K2 launches not counted): {sum(ops.values())} = {ops}")
    out = {"ms": ms_frame, "worlds": num_worlds, "units": world.capacity, "unit": "entity",
           "launches": launches, "ops": sum(ops.values()), "k1": k1}
    if views:
        out.update(view_checks(name, world, state, map_tensors))
        out["clusters"] = time_clusters(world, state)
    if num_worlds >= 4:
        cmp_state = map_tensors(lambda t: t[:4].clone(), state)
    else:   # a one-world path: its end state tiled to 4 worlds, which diverge
        cmp_state = replicate_state(map_tensors(lambda t: t[0], state), 4,
                                    torch.Generator(device=dev).manual_seed(4))
    del state
    cmp = compare_with_plain(engine, world, cmp_state, step, views=views)
    log(f"[5 {name}] {n_char} characters; 3 frames at W={cmp_state.local.pos.shape[0]}, card vs "
        f"plain on the CPU: max abs err {cmp['errs']}, boundary flips {cmp['flips']}, kill flips "
        f"{cmp['kills']}" + (f", view/shadow/cluster flips {cmp['view_flips']}" if views else ""))
    return out


def render_frame(step, rm):
    """`step` followed by the render config's two per-view passes on every
    world, as bench.py --config render runs them: 4 shadow cascades and the
    cluster pass. Their caster counts, cluster counts and overflow are
    summed into `frame.probe`, a device scalar read after the frames."""
    from lumixengine_tpu_torch.renderer import clusters, shadows

    statics = rm.statics()

    def frame(state, dt):
        state = step(state, dt)
        sv = shadows.shadow_pass(state, rm, light_dir=LIGHT_DIR, statics=statics)
        cl = clusters.fill_clusters(state, rm, statics=statics)
        frame.probe = frame.probe + (sv.caster_count.sum() + cl.count.sum() + cl.overflow.sum())
        return state

    frame.probe = 0
    return frame


def view_checks(name, world, state, map_tensors):
    """One prepare_view in each sort mode on the batch (K1 once each, with
    the launch counts set to 0 just before and read just after), the draw
    order checked on the card, record_frame on world 0, and the torch ops
    of prepare_view and shadow_pass at this W (the cluster pass's in
    time_clusters)."""
    import torch

    from lumixengine_tpu_torch.renderer import draw_stream, pipeline, shadows

    rm = world.modules["renderer"]
    torch.cuda.synchronize()
    _zero_launches()
    views = {mode: pipeline.prepare_view(state, rm, sort_mode=mode)
             for mode in (pipeline.SORT_MATERIAL, pipeline.SORT_DEPTH)}
    torch.cuda.synchronize()
    launches = _launches()
    if launches != {"K1": 2, "K2": 0}:
        raise AssertionError(f"prepare_view must launch K1 once a call: {launches}")
    for mode, v in views.items():
        order = v.order.long()
        hi, lo = v.sort_key.gather(-1, order), v.sort_key_lo.gather(-1, order)
        ascending = (hi[..., 1:] > hi[..., :-1]) | ((hi[..., 1:] == hi[..., :-1])
                                                   & (lo[..., 1:] >= lo[..., :-1]))
        rank = torch.arange(order.shape[-1], device=order.device)
        first = v.visible.gather(-1, order) == (rank < v.visible_count[..., None])
        if not (bool(ascending.all()) and bool(first.all()) and torch.equal(
                v.visible_count, state.modules["renderer"].counters["visible_count"])):
            raise AssertionError(f"prepare_view (sort mode {mode}): the draw order is not the keys'")
    stream = draw_stream.record_frame(map_tensors(lambda t: t[0], views[pipeline.SORT_MATERIAL]),
                                      state.modules["renderer"], rm)
    layers = {"prepare_view": lambda: pipeline.prepare_view(state, rm),
              "shadow_pass": lambda: shadows.shadow_pass(state, rm, LIGHT_DIR)}
    ops = {k: count_ops(fn)[1] for k, fn in layers.items()}
    ms = {k: float(f"{cuda_time(fn, 5):.4f}") for k, fn in layers.items()}
    log(f"[5 {name}] prepare_view in both sort modes: launches {launches}, draw order ascending "
        f"in its keys with the visible instances first; record_frame on world 0: "
        f"{len(stream.commands)} commands {[c.op for c in stream.commands]}; at "
        f"W={state.alive.shape[0]}, torch ops a call {ops}, ms a call {ms}")
    return {"view_launches": launches["K1"], "layer_ops": ops, "layer_ms": ms}


def time_clusters(world, state):
    """The cluster pass at the path's W on the card: ms a call (CUDA events
    over 5 calls), the host's enqueue time of one call, its torch ops, and
    its bound: the bytes it must move (camera, the live lights' positions
    and ranges and the light mask read once; lists, counts and overflow
    written once) over 3.35 TB/s, or its float operations (per world,
    cluster and live light: 3 axes of clamp (2), subtract, square, add, and
    the range compare) over 67 TFLOP/s, whichever is longer. A masked light
    slot's test is decided by the mask alone, so it needs no arithmetic;
    the pass as written computes every slot of the padded light axis, and
    that count is returned beside the bound (`flops_padded`)."""
    import torch

    from lumixengine_tpu_torch.renderer import clusters

    rm = world.modules["renderer"]
    st = rm.statics()

    def call():
        return clusters.fill_clusters(state, rm, statics=st)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    ms = cuda_time(call, 5)
    _, n_ops = count_ops(call)
    w = state.alive.shape[0]
    c = 1
    for n in clusters.GRID:
        c *= n
    n_l = rm.point_lights.capacity
    n_live = int(st.pl_mask.sum())
    l_pad = -(-n_l // clusters.WORD) * clusters.WORD
    k = clusters.MAX_LIGHTS_PER_CLUSTER
    nbytes = w * (7 + 4) * 4 + w * n_live * (3 + 1) * 4 + n_l + w * c * (k + 1) * 4 + w * 4
    flops, flops_padded = w * c * n_live * 16, w * c * l_pad * 16
    bound_ms, by = bound(nbytes, flops)
    return {"ms": ms, "enqueue_ms": enqueue_ms, "ops": n_ops, "W": w, "C": c, "L": n_l,
            "L_live": n_live, "L_pad": l_pad, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": by, "flops_padded": flops_padded,
            "bound_ms_padded": bound(nbytes, flops_padded)[0]}


def run_attachments(dev, replicate_state):
    """The skinned crowd at 4 characters with two bone attachments (a sword
    on bone 5 of an animable, a lamp with an offset rotation on bone 9 of an
    animator), replicated to 4 worlds: 3 frames on the card against the CPU;
    each attachment's local transform is its bone's pose ∘ offset."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.core import math as lm
    from lumixengine_tpu_torch.models.demo_scenes import skinned_crowd_world

    engine, world, _r, _a = skinned_crowd_world(4)
    rm, an = world.modules["renderer"], world.modules["animation"]
    parents = (int(an.animables.entity[an.animables.entity >= 0][0]),
               int(an.animators.entity[an.animators.entity >= 0][0]))
    offsets = (((0.0, 0.2, 0.0), (0.0, 0.0, 0.0, 1.0)),
               ((0.1, 0.0, -0.3), (0.0, float(np.sin(0.4)), 0.0, float(np.cos(0.4)))))
    attached = []
    for parent, bone, (op, orot) in zip(parents, (5, 9), offsets):
        e = world.create_entity()
        world.create_component(e, "bone_attachment", parent_entity=parent, bone=bone,
                               offset_pos=op, offset_rot=orot)
        attached.append(e)
    step = engine.build_step(world, dev, extra=rm.cull_pass)
    state = replicate_state(world.device_state(dev), 4, torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    _zero_launches()
    step(state, DT)
    torch.cuda.synchronize()
    launches = _launches()
    k1 = k1_on_path("attachments", world, state)
    cmp = compare_with_plain(engine, world, state, step)
    end, ams = cmp["state"], cmp["state"].modules["animation"]
    err = 0.0
    for e, parent, bone, (op, orot) in zip(attached, parents, (5, 9), offsets):
        col = (an.pool_col_animable(an.animables.slot_of(parent)) if parent in an.animables
               else an.pool_col_animator(an.animators.slot_of(parent)))
        bp, br = ams.pose_pos[..., :, bone, col], ams.pose_rot[..., :, bone, col]
        want_p = bp + lm.quat_rotate(br, torch.tensor(op, device=dev))
        want_r = lm.quat_mul(br, torch.tensor(orot, device=dev))
        slot = world.slot(e)
        err = max(err, max_err([end.local.pos[..., :, slot], end.local.rot[..., :, slot]],
                               [want_p, want_r]))
    log(f"[5 attachments] skinned_crowd_world(4) + 2 bone attachments at W=4: launches in a frame "
        f"{launches};"
        f" 3 frames card vs plain on the CPU: max abs err {cmp['errs']}; attachment local vs "
        f"bone pose ∘ offset on the card: {err:.3e}")
    if launches != {"K1": 1, "K2": 0} or not err <= TRANSFORM_ATOL:
        raise AssertionError(f"bone attachments: launches {launches}, pose error {err}")
    return {"launches": launches, "err": err, "k1": k1}


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


def _golden(name):
    import numpy as np

    with np.load(os.path.join(GOLDEN_DIR, f"golden_{name}.npz")) as f:
        return dict(f)


def _zero_launches():
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import solver as S

    cull.frustum_cull_cuda.launches = 0
    S.solve_cuda.launches = 0


def _launches():
    from lumixengine_tpu_torch.ops import culling as cull
    from lumixengine_tpu_torch.ops import solver as S

    return {"K1": cull.frustum_cull_cuda.launches, "K2": S.solve_cuda.launches}


def run_goldens(dev):
    """The nine committed goldens (tests/data/golden_*.npz) at W=1 on the
    card for their full step counts, each held to the bounds of the JAX
    package's tests/test_golden_trajectories.py, capsule_stack as the
    ensemble of physics_scenes.golden_ensemble (its outcome is decided by
    rounding, in the JAX package too). K2 launches once a step in every
    world that has a contact stream. Then K2 against its plain version on
    each such world's contact set at its last step."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import solver as S

    expected, k2_err, t0 = 0, 0.0, time.perf_counter()
    torch.cuda.synchronize()
    _zero_launches()
    finals = []
    for name in PS.GOLDEN_NAMES:
        g = _golden(name)
        engine, world, state, slots = PS.golden_world(g, dev)
        pm = world.modules["physics"]
        st = pm.statics()
        steps = int(g["steps"])
        state, traj = PS.run_recorded(engine.build_step(world, dev), state,
                                      slots[PS.GOLDEN_RECORD.get(name, 0)], steps)
        expected += steps * bool(st.ground_plane or len(st.pair_a))
        finals.append((name, g, pm, state, traj, slots))
    cap = _golden("capsule_stack")
    engine, world, ens, cap_slots = PS.golden_ensemble(cap, PS.CAPSULE_WORLDS, PS.CAPSULE_EPS,
                                                       dev)
    step = engine.build_step(world, dev)
    for _ in range(int(cap["steps"])):
        ens = step(ens, DT)
    expected += int(cap["steps"])
    torch.cuda.synchronize()
    launches, wall = _launches(), time.perf_counter() - t0
    for name, g, pm, state, traj, slots in finals:
        ms = state.modules["physics"]
        if name == "tumbling":
            got = PS.check_tumbling(g, ms.rot.cpu().numpy(), slots[0])
        elif name == "capsule_stack":
            pos = ms.pos.cpu().numpy()
            holds = PS.golden_passes(name, g, pos[None], ms.vel.cpu().numpy()[None], slots)
            got = {"holds": bool(holds[0]), "top": pos[:, slots[2]].round(4).tolist()}
        else:
            got = PS.check_golden(name, g, traj.cpu().numpy(), ms.pos.cpu().numpy(),
                                  ms.vel.cpu().numpy(), slots)
        err = None
        if pm.statics().ground_plane or len(pm.statics().pair_a):
            prob = pm.solver_problem(state, DT)
            err = max_err(S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS),
                          S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS))
            if not err <= S.K2_PLAIN_ATOL:
                raise AssertionError(f"K2 on golden {name}: {err} vs plain")
            k2_err = max(k2_err, err)
        shown = {k: (float(f"{v:.4g}") if isinstance(v, float) else v) for k, v in got.items()}
        how = ("held to the bounds as an ensemble below" if name == "capsule_stack" else
               "within the bounds of tests/test_golden_trajectories.py")
        log(f"[7 golden] {name}: {int(g['steps'])} steps at W=1, NB={ms.pos.shape[-1]}, {how}: "
            f"{shown}; K2 vs plain "
            f"{'no contact stream' if err is None else f'{err:.3e}'}")
    ms = ens.modules["physics"]
    pos = ms.pos.cpu().numpy()
    holds = PS.golden_passes("capsule_stack", cap, pos, ms.vel.cpu().numpy(), cap_slots)
    statics = np.asarray(cap["init_pos"][:2], np.float32).T
    moved = int((pos[:, :, cap_slots[:2]] != statics[None]).any(axis=(1, 2)).sum())
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(ens))
    need = PS.CAPSULE_REFERENCE_PASSES - PS.CAPSULE_PASS_MARGIN
    log(f"[7 golden] capsule_stack ensemble: {PS.CAPSULE_WORLDS} worlds, N(0, "
        f"{PS.CAPSULE_EPS:g}^2) m/s on the top capsule's start velocity (world 0 none): "
        f"{int(holds.sum())} within the bounds (world 0 {bool(holds[0])}; the JAX package "
        f"{PS.CAPSULE_REFERENCE_PASSES} on the CPU, at least {need} required), worlds with a "
        f"static moved {moved}, finite {finite}")
    log(f"[7 golden] nine goldens and the ensemble in {wall:.2f} s, launches {launches} "
        f"(K2 expected {expected})")
    if launches != {"K1": 0, "K2": expected}:
        raise AssertionError(f"the goldens' launches {launches}, expected K2 {expected}")
    if int(holds.sum()) < need or moved or not finite:
        raise AssertionError(f"capsule_stack ensemble: {int(holds.sum())} within the bounds, "
                             f"{moved} moved statics, finite {finite}")
    return {"launches": launches, "k2_err": k2_err}


def golden_gap(name, dev):
    """Golden `name` at W=1 stepped on the card and on the CPU side by side
    for its full arc: each physics field's largest gap, the first step where
    it passes GAP_LIMIT and the first step where the two differ at all; then
    that step again from the CPU's state before it on both devices, op by op
    (first_divergent_op), and K2 against the plain solve on its contact set
    there."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import solver as S

    g = _golden(name)
    engine, world, gpu, _slots = PS.golden_world(g, dev)
    pm = world.modules["physics"]
    gstep, cstep = engine.build_step(world, dev), engine.build_step(world, "cpu")
    cpu = gpu.to("cpu")
    fields = ("pos", "rot", "vel", "angvel")

    def rows(state):
        ph = state.modules["physics"]
        return torch.cat([getattr(ph, f).reshape(-1) for f in fields])

    cpu_states, grows, crows = [cpu], [], []
    for _ in range(int(g["steps"])):
        gpu, cpu = gstep(gpu, DT), cstep(cpu, DT)
        grows.append(rows(gpu))
        crows.append(rows(cpu))
        cpu_states.append(cpu)
    sizes = [getattr(cpu.modules["physics"], f).numel() for f in fields]
    diff = (torch.stack(grows).cpu() - torch.stack(crows)).abs()
    gap = torch.stack([d.amax(dim=-1) for d in diff.split(sizes, dim=-1)], dim=-1)  # [steps, fields]

    def first(mask):
        hit = torch.nonzero(mask).flatten()
        return int(hit[0]) + 1 if len(hit) else None

    out = {"steps": int(g["steps"]),
           "max_gap": {f: float(f"{float(gap[:, i].max()):.4g}") for i, f in enumerate(fields)},
           f"first_step_over_{GAP_LIMIT:g}": {f: first(gap[:, i] > GAP_LIMIT)
                                               for i, f in enumerate(fields)},
           "first_step_differing": first(gap.amax(dim=-1) > 0)}
    k = out["first_step_differing"]
    if k is not None:
        before = cpu_states[k - 1]
        out["first_op"] = first_divergent_op(cstep, gstep, before, dev)
        st = pm.statics()
        if st.ground_plane or len(st.pair_a):
            prob = pm.solver_problem(before.to(dev), DT)
            out["k2_vs_plain_there"] = max_err(
                [t.cpu() for t in S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)],
                S.solve_plain(pm.solver_problem(before, DT), ITERATIONS, POSITION_ITERATIONS))
    log(f"[7 gap] {name}: card vs CPU, {out}")
    return out


def first_divergent_op(cpu_step, gpu_step, state, dev):
    """One step from the same state on the CPU and on the card, each torch op
    recorded with its outputs: the first op whose outputs differ, where the
    port calls it, and by how much. Both sides take the plain contact solve
    here, so that the two op streams line up (K2 is one library call, not a
    torch op; its own gap is measured beside)."""
    import traceback

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from lumixengine_tpu_torch.ops import solver as S

    root = os.path.dirname(os.path.abspath(__file__))

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            # views, fresh allocations and host-to-device constant copies
            # (the card's step copies constants the CPU's uses in place)
            if not (getattr(func, "is_view", False) or "empty" in name
                    or name.startswith(("aten._to_copy", "aten.lift_fresh"))):
                where = next((f"{os.path.relpath(fr.filename, root)}:{fr.lineno}"
                              for fr in reversed(traceback.extract_stack())
                              if "lumixengine_tpu_torch" in fr.filename), "?")
                outs = [t.detach().cpu().clone() for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor)]
                self.ops.append((name, outs, where))
            return out

    solve = S.solve
    S.solve = S.solve_plain
    try:
        recs = []
        for step, where in ((cpu_step, "cpu"), (gpu_step, dev)):
            with Record() as rec:
                step(state.to(where), torch.tensor(DT, dtype=torch.float32, device=where))
            recs.append(rec.ops)
    finally:
        S.solve = solve
    def same(a, b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)

    for i, ((fc, tc, at), (fg, tg, _)) in enumerate(zip(*recs)):
        if fc != fg:
            return {"op_index": i, "streams_part": (fc, fg), "ops": len(recs[0])}
        for a, b in zip(tc, tg):
            if not same(a, b):
                d = (a.double() - b.double()).abs()
                return {"op_index": i, "op": fc, "at": at, "ops": len(recs[0]),
                        "max_abs_diff": float(d.max()), "elements_differing": int((d > 0).sum())}
    return {"op_index": None, "ops": len(recs[0])}


def run_farm(name, dev, replicate_state):
    """Golden `name` replicated to FARM_WORLDS diverging worlds, FARM_FRAMES
    frames timed with CUDA events; K2 on the farm's contact set against its plain
    version, timed beside it and against its bound (k2_on_state)."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS

    g = _golden(name)
    engine, world, state, _slots = PS.golden_world(g, dev)
    pm = world.modules["physics"]
    step = engine.build_step(world, dev)
    state = replicate_state(state, FARM_WORLDS, torch.Generator(device=dev).manual_seed(6))
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    for f in range(FARM_FRAMES):
        if f == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
    ev1.record()
    torch.cuda.synchronize()
    launches = _launches()
    ms = ev0.elapsed_time(ev1) / (FARM_FRAMES - WARM_FRAMES)
    phys = state.modules["physics"]
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    n_dyn = int(pm.statics().dyn_mask.sum())
    active = phys.counters["active_contacts"]
    _, n_ops = count_ops(lambda: step(state, DT))
    if launches != {"K1": 0, "K2": FARM_FRAMES} or not finite:
        raise AssertionError(f"farm {name}: launches {launches}, finite {finite}")
    # a capsule takes a sphere's inertia, as in the reference, and in a few
    # perturbed capsule worlds the top capsule spins up to hundreds of rad/s
    # (the JAX package too, from the same states): k2_on_state leaves out
    # the worlds where a body in contact moves above SANE_SPEED
    k2 = k2_on_state(pm, state, f"the {name} farm")
    rate = FARM_WORLDS * n_dyn / (ms / 1e3)
    log(f"[7 farm] {name}: W={FARM_WORLDS}, {n_dyn} dynamic bodies a world, {FARM_FRAMES} frames: "
        f"{ms:.3f} ms/frame = {rate:.4g} body-steps/s, {n_ops} torch ops/frame, launches "
        f"{launches}, finite {finite}, active contacts {int(active.sum())} (worlds with "
        f"contacts {int((active > 0).sum())}); K2 on its contact set W={k2['W']} NB={k2['NB']} "
        f"C={k2['C']} (active {k2['active']}): {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, "
        f"{k2['bytes']} bytes, bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}), max abs err vs "
        f"plain {k2['max_abs_err']:.3e} on the {k2['worlds_compared']} worlds without a body in "
        f"contact above {SANE_SPEED:g} m/s or rad/s")
    return {"ms": ms, "rate": rate, "ops": n_ops, "launches": launches, "k2": k2}


def run_banded(dev):
    """PhysicsModule's banded branch, which `auto` picks above 256 actor
    slots: BANDED_BOXES boxes on the bench's grid at BANDED_CAPACITY slots
    with a sweep window of BANDED_WINDOW,
    BANDED_STEPS steps at W=1, the window certificate summed on the card and
    read once (must be 0), the state finite, no box centre below
    BOX_LOWEST_MIN; then a block of BANDED_COMPARE_BOXES boxes run
    BANDED_COMPARE_AT steps on the card and 3 more on the card and on the
    CPU, within BODY_POS_ATOL / BODY_VEL_ATOL with equal certificates and
    active-contact counts."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.models import physics_scenes as PS

    engine, world = PS.box_block(BANDED_BOXES, BANDED_CAPACITY, neighbors=BANDED_WINDOW)
    pm = world.modules["physics"]
    if not pm.statics().sap:
        raise AssertionError("the box block did not take the banded branch")
    occ = torch.as_tensor(pm.statics().occupied, device=dev)
    step = engine.build_step(world, dev)
    state = world.device_state(dev)
    miss = torch.zeros((), dtype=torch.int32, device=dev)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    for i in range(BANDED_STEPS):
        if i == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
        miss = miss + state.modules["physics"].counters["sap_window_miss"]
    ev1.record()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launches()
    ms = ev0.elapsed_time(ev1) / (BANDED_STEPS - WARM_FRAMES)
    phys = state.modules["physics"]
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    lowest = float(phys.pos[1][occ].min())
    _, n_ops = count_ops(lambda: step(state, DT))
    log(f"[7 banded] {BANDED_BOXES} boxes at {BANDED_CAPACITY} actor slots, window "
        f"{BANDED_WINDOW}, {BANDED_STEPS} "
        f"steps at W=1 in {wall:.2f} s ({ms:.3f} ms/step), {n_ops} torch ops/step, launches "
        f"{launches}: sap_window_miss summed {int(miss)}, finite {finite}, lowest box centre "
        f"{lowest:.4f} m, active contacts at the end {int(phys.counters['active_contacts'])}")
    if int(miss) or not finite or not lowest > BOX_LOWEST_MIN:
        raise AssertionError(f"banded block: miss {int(miss)}, finite {finite}, lowest {lowest}")

    engine, world = PS.box_block(BANDED_COMPARE_BOXES, BANDED_COMPARE_CAPACITY,
                                  neighbors=BANDED_WINDOW)
    step = engine.build_step(world, dev)
    cpu_step = engine.build_step(world, "cpu")
    gpu = world.device_state(dev)
    for _ in range(BANDED_COMPARE_AT):
        gpu = step(gpu, DT)
    cpu, errs = gpu.to("cpu"), {}
    for _ in range(3):
        gpu, cpu = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu)
        for f, atol in (("pos", BODY_POS_ATOL), ("rot", BODY_POS_ATOL), ("vel", BODY_VEL_ATOL),
                        ("angvel", BODY_VEL_ATOL)):
            k = "modules.physics." + f
            errs[f] = max(errs.get(f, 0.0), float(np.abs(got[k] - ref[k]).max()))
            if not errs[f] <= atol:
                raise AssertionError(f"banded {f}: card vs plain {errs[f]} > {atol}")
        certs = {c: (int(got[f"modules.physics.counters.{c}"]),
                     int(ref[f"modules.physics.counters.{c}"]))
                 for c in ("sap_window_miss", "active_contacts")}
        if any(a != b for a, b in certs.values()):
            raise AssertionError(f"banded counters differ, card vs CPU: {certs}")
    same_rank = float(np.mean(got["modules.physics.sap_rank"] == ref["modules.physics.sap_rank"]))
    log(f"[7 banded] {BANDED_COMPARE_BOXES} boxes, 3 steps from step {BANDED_COMPARE_AT}, card "
        f"vs the CPU: max abs err {({k: float(f'{v:.3g}') for k, v in errs.items()})}, counters "
        f"(card, CPU) {certs}, sweep ranks equal {same_rank:.4f}")
    return {"ms": ms, "ops": n_ops, "launches": launches, "miss": int(miss), "lowest": lowest}


# -- game content: the props, drive and terrain farms and the banded props level --


def layer_time(fn, reps: int = LAYER_REPS):
    """(ms a call of fn() with CUDA events, ms a call of the card's kernels
    by torch.profiler, or None where the profiler reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_time(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    return ms, (total / 1e3 / reps if total > 0 else None)


def _show_layers(layers):
    return "; ".join(f"{name} {ms:.4f} ms a call (device {'not measured' if dev is None else f'{dev:.4f} ms'})"
                     for name, (ms, dev) in layers.items())


def k2_on_state(pm, state, label):
    """K2 against its plain version on the contact set `state` gives, on
    the worlds where no body with an active contact moves at SANE_SPEED or
    above before or after the solve (a CCD body clamped short of a surface
    keeps its speed and hovers without a contact, as in the JAX package);
    then both timed (plain, kernel, kernel, plain) and K2's bound over the
    active slots. Returns the record for the kernels line."""
    import torch

    from lumixengine_tpu_torch.ops import solver as S

    prob = pm.solver_problem(state, DT)
    plain = S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS)
    speed = torch.stack([t.abs().amax(dim=1) for t in (prob.vel, prob.angvel, *plain[:2])]
                        ).amax(dim=0)                                       # [W, NB]
    act = (prob.act != 0).to(torch.float32)
    touch = torch.zeros_like(speed).scatter_add_(1, prob.body_a.long(), act).scatter_add_(
        1, prob.body_b.long().clamp_min(0), act * (prob.body_b >= 0)) > 0
    sane = ~((speed >= SANE_SPEED) & touch).any(dim=1)
    sub = S.ContactProblem(**{k: v if k == "inv_mass" else v[sane].contiguous()
                              for k, v in prob.tensors().items()})
    err = max_err(S.solve_cuda(sub, ITERATIONS, POSITION_ITERATIONS),
                  S.solve_plain(sub, ITERATIONS, POSITION_ITERATIONS))
    k_ms, plain_ms = alternate(lambda: S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS),
                               lambda: S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS), 5)
    w_, _, nb = prob.vel.shape
    c = prob.act.shape[-1]
    n_act = int((prob.act != 0).sum())
    n_pair = int(((prob.act != 0) & (prob.body_b >= 0)).sum())
    nbytes = S.k2_bytes(w_, nb, c, n_act)
    bound_ms, by = bound(nbytes, S.k2_flops(w_, nb, c, n_act, n_pair, ITERATIONS,
                                            POSITION_ITERATIONS))
    if not err <= S.K2_PLAIN_ATOL or int(sane.sum()) < 0.99 * w_:
        raise AssertionError(f"K2 on {label}: {err} vs plain, {int(sane.sum())} of {w_} worlds "
                             f"below {SANE_SPEED}")
    return {"W": w_, "NB": nb, "C": c, "active": n_act, "max_abs_err": err,
            "worlds_compared": int(sane.sum()), "ms": k_ms, "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": by, "share_of_bound": bound_ms / k_ms}


def game_checks(kind, sc, state, trace, hits):
    """The scene's physical checks (models/physics_scenes.py: the JAX tests'
    bounds) on every world, raising on the first broken one; world 0 starts
    as built, the others perturbed (replicate_scene), where the props
    world's resting heights do not apply. Returns world 0's readings."""
    from lumixengine_tpu_torch.models import physics_scenes as PS

    ms = state.modules["physics"]
    pos, vel, ang = (getattr(ms, f).cpu().numpy() for f in ("pos", "vel", "angvel"))
    cpos, cgr = ms.ctrl_pos.cpu().numpy(), ms.ctrl_grounded.cpu().numpy()
    wpos = state.world.pos.cpu().numpy()
    st = sc.world.modules["physics"].statics()
    first = None
    for w in range(pos.shape[0]):
        if kind == "props":
            out = PS.check_props(sc, pos[w], vel[w], trace[:, w], resting=(w == 0))
        elif kind == "drive":
            out = PS.check_drive(sc, pos[w], ang[w], trace[:, w], cpos[w], cgr[w],
                                 float(wpos[w, 0, sc.world.slot(sc.ents["player"])]), int(hits[w]))
        else:
            out = PS.check_terrain(sc, pos[w], st.radius, cpos[w], cgr[w],
                                   wpos[w, :, sc.world.slot(sc.ents["walker"])])
        first = out if first is None else first
    return first


def game_layers(kind, sc, state):
    """The device time of the new layers on the scene's end state."""
    import torch

    from lumixengine_tpu_torch.ops import convex_ops as CV

    pm = sc.world.modules["physics"]
    st = pm.statics()
    ms = state.modules["physics"]
    d = st.on(ms.pos.device, pm.system)
    pos, rot = ms.pos, ms.rot
    layers = {}
    if len(st.conv_pair_a):
        layers["polytope SAT (convex pairs)"] = layer_time(lambda: CV.polytope_pair_contacts(
            pos, rot, d.poly_verts, d.poly_axes, d.poly_rad, d.conv_pair_a, d.conv_pair_b))
    if st.has_conv_gnd and len(st.conv_idx):
        layers["polytope ground"] = layer_time(lambda: CV.polytope_ground_contacts(
            pos, rot, d.conv_verts, d.conv_rad, d.conv_idx, pm.system.ground_y))
    if st.sdf_colliders:
        layers["SDF streams"] = layer_time(lambda: pm._sdf_streams(st, d, pos, rot))
    if st.has_ccd:
        moved = pos + ms.vel * DT
        layers["CCD clamp"] = layer_time(lambda: pm._ccd_clamp(st, d, pos, moved))
    if st.heightfield_terrain >= 0:
        layers["heightfield stream"] = layer_time(lambda: pm._ground_stream(st, d, pos, rot))
    if st.has_vehicles:
        dt = torch.tensor(DT, device=pos.device)
        layers["vehicles"] = layer_time(lambda: pm._update_vehicles(d, ms, pos, rot, ms.vel,
                                                                    ms.angvel, dt))
    if kind == "drive":
        from lumixengine_tpu_torch.models import physics_scenes as PS

        offs, dirs = (torch.as_tensor(a, device=pos.device) for a in PS.drive_rays())
        layers["queries (64 rays + 64 sweeps a world)"] = layer_time(
            lambda: PS.drive_queries(sc, state, offs, dirs))
    return layers


def compare_game(kind, sc, state, step):
    """3 frames from the first 4 worlds of `state` with the scene's host
    inputs, the card's step (K2) against the CPU's (plain), at
    BODY_POS_ATOL / BODY_VEL_ATOL (physics_scenes.state_gap), a body's
    sleep counter allowed to flip at the calm threshold. A frame that breaks
    them is explained from the CPU's state before it
    (physics_scenes.explain_break): the card's frame holds there (the
    devices' drift flipped a decision), or the card's and the CPU's contact
    sets differ only at ties or by rounding within CONTACT_TIE_ATOL (a hull
    rocking on coplanar contacts amplifies it) and the card's frame holds on
    the CPU's set. After a flip both go on from the CPU's state. Returns
    (max abs errors, [(frame, cause and what broke, margin)])."""
    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.engine.world import map_tensors
    from lumixengine_tpu_torch.models import physics_scenes as PS

    pm = sc.world.modules["physics"]
    gpu = map_tensors(lambda t: t[:4].clone(), state)
    dev = gpu.local.pos.device
    cpu, cpu_step = gpu.to("cpu"), sc.engine.build_step(sc.world, "cpu")
    frame0 = int(state.frame.reshape(-1)[0])
    errs, flips = {}, []

    def gap(got, ref):
        return PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL, sleep_flips=True)[:2]

    for f in range(3):
        gpu = PS.scene_inputs(kind, sc, gpu, frame0 + f)
        cpu = PS.scene_inputs(kind, sc, cpu, frame0 + f)
        gnext, cnext = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gnext), bridge.state_to_numpy(cnext)
        out, broke, woke = PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL, sleep_flips=True)
        if broke is not None:
            drift = max(gap(bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu))[0].values())
            cause, margin, out = PS.explain_break(
                step, cpu.to(dev), ref, gap, drift, pm,
                lambda c=cpu: pm._contact_stage(c, DT).contacts)
            flips.append((frame0 + f + 1, f"{cause} ({broke})", float(f"{margin:.3g}")))
        if woke.any():
            flips.append((frame0 + f + 1, "sleep counters", int(woke.sum())))
        if broke is not None or woke.any():
            gnext = cnext.to(dev)
        for k, v in out.items():
            k = k.replace(PS.PH, "")
            errs[k] = max(errs.get(k, 0.0), v)
        gpu, cpu = gnext, cnext
    return {k: float(f"{v:.3g}") for k, v in errs.items() if v}, flips


def run_game(kind, dev, card):
    """One game-content farm (models/physics_scenes.py) at GAME_WORLDS[kind]
    worlds, the scene's frame count with its host inputs (the drive farm's
    64 rays and 64 sweeps a world a frame inside the timed frames), timed
    with CUDA events; its physical checks on every world; K2 on its end
    contact set against plain, timed and against its bound; torch ops a
    frame; the device time of the new layers; 3 frames card vs CPU."""
    import torch

    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import solver as S

    builder = {"props": PS.props_world, "drive": PS.drive_world, "terrain": PS.terrain_world}[kind]
    frames = {"props": PS.PROPS_FRAMES, "drive": PS.DRIVE_FRAMES,
              "terrain": PS.TERRAIN_FRAMES}[kind]
    num_worlds = GAME_WORLDS[kind]
    sc = builder()
    pm = sc.world.modules["physics"]
    st = pm.statics()
    step = sc.engine.build_step(sc.world, dev)
    state = PS.replicate_scene(PS.start_state(sc, dev), num_worlds, 12)
    offs, dirs = (torch.as_tensor(a, device=dev) for a in PS.drive_rays())
    trace_idx = torch.as_tensor(sc.trace, dtype=torch.int64, device=dev)
    trace = []
    hits = torch.zeros((2, num_worlds), dtype=torch.int64, device=dev)   # rays, sweeps

    def frame(state, f):
        state = step(PS.scene_inputs(kind, sc, state, f), DT)
        if kind == "drive":
            (hit, _t, _i), (shit, _st, _si) = PS.drive_queries(sc, state, offs, dirs)
            return state, torch.stack([hit.sum(dim=-1), shit.sum(dim=-1)])
        return state, None

    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    for f in range(frames):
        if f == WARM_FRAMES:
            ev0.record()
        state, h = frame(state, f)
        if len(sc.trace):
            trace.append(state.modules["physics"].pos.index_select(-1, trace_idx))
        if h is not None:
            hits += h
    ev1.record()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launches()
    ms = ev0.elapsed_time(ev1) / (frames - WARM_FRAMES)
    finite = all(bool(torch.isfinite(t).all()) for t in _float_tensors(state))
    n_dyn = int(st.dyn_mask.sum())
    rate = num_worlds * n_dyn / (ms / 1e3)
    active = state.modules["physics"].counters["active_contacts"]
    tr = torch.stack(trace).cpu().numpy() if trace else None
    if launches != {"K1": 0, "K2": frames} or not finite:
        raise AssertionError(f"{kind} farm: launches {launches}, finite {finite}")
    first = game_checks(kind, sc, state, tr, hits[0].cpu().numpy())
    _, n_ops = count_ops(lambda: frame(state, frames))
    k2 = k2_on_state(pm, state, f"the {kind} farm")
    layers = game_layers(kind, sc, state)
    log(f"[7 {kind}] {card}: W={num_worlds}, {n_dyn} dynamic bodies a world (NB={st.nb}, "
        f"C={st.n_contact_slots}), {frames} frames in {wall:.2f} s: {ms:.3f} ms/frame = "
        f"{rate:.4g} body-steps/s, {n_ops} torch ops/frame, launches {launches}, finite "
        f"{finite}, active contacts {int(active.sum())} (worlds with contacts "
        f"{int((active > 0).sum())})" + (f", ray hits {int(hits[0].sum())}, sweep hits "
                                         f"{int(hits[1].sum())}" if kind == "drive" else ""))
    log(f"[7 {kind}] checks (the JAX tests' bounds) hold in all {num_worlds} worlds; world 0: "
        f"{first}")
    log(f"[7 {kind}] {card}: K2 on its contact set W={k2['W']} NB={k2['NB']} C={k2['C']} (active "
        f"{k2['active']}): {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, {k2['bytes']} bytes, "
        f"bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}), max abs err vs plain "
        f"{k2['max_abs_err']:.3e} (limit {S.K2_PLAIN_ATOL:g}; {k2['worlds_compared']} worlds)")
    log(f"[7 {kind}] {card}: new layers on the end state: {_show_layers(layers)}")
    errs, flips = compare_game(kind, sc, state, step)
    log(f"[7 {kind}] 3 frames at W=4, card vs plain on the CPU: max abs err {errs}; decisions "
        f"flipped (frame, cause and what broke, margin; or frame, 'sleep counters', bodies): "
        f"{flips}")
    return {"ms": ms, "rate": rate, "ops": n_ops, "launches": launches, "k2": k2,
            "layers": layers, "worlds": num_worlds}


def _runs(xs):
    """Run-length text of a sequence: '0x360' or '0x120, 3, 0x239'."""
    out, i = [], 0
    while i < len(xs):
        j = i
        while j < len(xs) and xs[j] == xs[i]:
            j += 1
        out.append(f"{xs[i]}x{j - i}" if j - i > 1 else f"{xs[i]}")
        i = j
    return ", ".join(out)


def run_banded_props(dev, card):
    """The banded props level: BANDED_PROPS_HULLS random hulls over the SDF
    slab and the ground at as many actor slots (`auto` picks the banded
    branch), BANDED_PROPS_STEPS steps at W=1 with the window certificate of
    every step, then the JAX pile test's bounds hull by hull
    (physics_scenes.check_banded_props: at most BANDED_PROPS_UNSETTLED
    hulls with a velocity component of 0.8 m/s or a vertex 2 cm deep in the
    ground or the slab), the device time of the banded polytope SAT and
    the SDF streams, and 3 steps card vs CPU on 4 of the level's stacks."""
    import torch

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.models import physics_scenes as PS
    from lumixengine_tpu_torch.ops import convex_ops as CV
    from lumixengine_tpu_torch.ops import physics_banded as PBD

    sc = PS.banded_props_level(hulls=BANDED_PROPS_HULLS, capacity=BANDED_PROPS_HULLS,
                               neighbors=PS.BANDED_PROPS_WINDOW)
    pm = sc.world.modules["physics"]
    st = pm.statics()
    if not st.sap:
        raise AssertionError("the banded props level did not take the banded branch")
    step = sc.engine.build_step(sc.world, dev)
    state = PS.start_state(sc, dev)
    misses = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    for i in range(PS.BANDED_PROPS_STEPS):
        if i == WARM_FRAMES:
            ev0.record()
        state = step(state, DT)
        misses.append(state.modules["physics"].counters["sap_window_miss"])
    ev1.record()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _launches()
    ms = ev0.elapsed_time(ev1) / (PS.BANDED_PROPS_STEPS - WARM_FRAMES)
    misses = torch.stack(misses).cpu().tolist()
    phys = state.modules["physics"]
    d = st.on(dev, pm.system)
    vw = CV.polytope_world_verts(phys.pos, phys.rot, d.poly_verts).cpu().numpy()
    slots = list(sc.slots.values())
    pen = PS.hull_penetration(vw[..., slots], st.poly_vert_valid[:, slots])
    pos, vel = phys.pos.cpu().numpy(), phys.vel.cpu().numpy()
    checks = PS.check_banded_props(sc, pos, vel, pen, unsettled_max=len(slots))   # the readings
    _, n_ops = count_ops(lambda: step(state, DT))
    # the banded SAT of one sweep order and the SDF streams, on the end state
    order = torch.argsort(phys.pos[0])
    K, k = pm.sap_neighbors, pm.points_per_pair

    def rk(x):
        return x.index_select(-1, order)

    layers = {"banded polytope SAT (one sweep)": layer_time(lambda: PBD.banded_polytope_grids(
        rk(phys.pos), rk(phys.rot), rk(d.poly_verts), rk(d.poly_axes), rk(d.poly_rad), K, k)),
        "SDF streams": layer_time(lambda: pm._sdf_streams(st, d, phys.pos, phys.rot))}
    log(f"[7 banded props] {card}: {BANDED_PROPS_HULLS} hulls at {st.nb} actor slots over the SDF "
        f"slab, window {PS.BANDED_PROPS_WINDOW}, {PS.BANDED_PROPS_STEPS} steps at W=1 in {wall:.2f} s "
        f"({ms:.3f} ms/step = {BANDED_PROPS_HULLS / (ms / 1e3):.4g} body-steps/s), {n_ops} torch "
        f"ops/step, launches {launches}; the JAX test's bounds hull by hull: {checks} (at most "
        f"{BANDED_PROPS_UNSETTLED} unsettled)")
    log(f"[7 banded props] window certificate (sap_window_miss) of each step: {_runs(misses)}; "
        f"summed {sum(misses)}")
    log(f"[7 banded props] {card}: {_show_layers(layers)}")
    PS.check_banded_props(sc, pos, vel, pen, unsettled_max=BANDED_PROPS_UNSETTLED)
    if launches != {"K1": 0, "K2": 0}:
        raise AssertionError(f"the banded branch launched {launches}")

    # the banded polytope SAT of the level's end state, one sweep order, on
    # the card against the CPU: equal but at ties (physics_scenes.contact_ties)
    grids = [PBD.banded_polytope_grids(*(rk(x).to(where) for x in (
        phys.pos, phys.rot, d.poly_verts, d.poly_axes, d.poly_rad)), K, k) for where in (dev, "cpu")]
    ties = PS.contact_ties(PS.grid_rows(grids[0]), PS.grid_rows(grids[1]))
    log(f"[7 banded props] the banded polytope SAT of the end state (one sweep, "
        f"{int(grids[1][3].sum())} active slots) on the card vs the CPU: equal but at "
        f"{len(ties)} ties (largest depth margin {max([m for *_x, m in ties] or [0.0]):.3g})")

    hulls, capacity, at = BANDED_PROPS_COMPARE
    sc = PS.banded_props_level(hulls=hulls, capacity=capacity, neighbors=PS.BANDED_PROPS_WINDOW)
    step, cpu_step = sc.engine.build_step(sc.world, dev), sc.engine.build_step(sc.world, "cpu")
    gpu = PS.start_state(sc, dev)
    for _ in range(at):
        gpu = step(gpu, DT)
    cpu, errs, flips = gpu.to("cpu"), {}, []
    own_sat = PBD.banded_polytope_grids

    def gap(got, ref):
        return PS.state_gap(got, ref, BODY_POS_ATOL, BODY_VEL_ATOL)[:2]

    def cpu_sat(*args):
        """The banded polytope SAT on the CPU, its grids on the card."""
        return tuple(x.to(dev) for x in own_sat(*(a.cpu() for a in args[:5]), *args[5:]))

    for i in range(3):
        gnext, cnext = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gnext), bridge.state_to_numpy(cnext)
        out, broke = gap(got, ref)
        if broke is not None:
            # from the CPU's own state: the devices' drift flipped a decision,
            # or the card's banded SAT differs from the CPU's only at ties
            drift = max(gap(bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu))[0].values())
            cause, margin, out = PS.explain_break(step, cpu.to(dev), ref, gap, drift,
                                                  ref_sat=cpu_sat)
            flips.append((at + i + 1, f"{cause} ({broke})", float(f"{margin:.3g}")))
            gnext = cnext.to(dev)
        for k, v in out.items():
            k = k.replace(PS.PH, "")
            errs[k] = max(errs.get(k, 0.0), v)
        gpu, cpu = gnext, cnext
    log(f"[7 banded props] {hulls} hulls in stacks at {capacity} slots, 3 steps from step {at}, "
        f"card vs the CPU: max abs err {({k: float(f'{v:.3g}') for k, v in errs.items() if v})}; "
        f"decisions flipped (step, cause and what broke, margin): {flips}")
    return {"ms": ms, "ops": n_ops, "launches": launches, "miss": sum(misses), "checks": checks,
            "layers": layers}


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


def op_counts(world, state, dev, passes=False):
    """The torch ops one frame dispatches, per module phase, counted on the
    host as the phases of Engine.build_step run on `state` (and with
    `passes`, the render config's shadow and cluster passes)."""
    import torch

    from lumixengine_tpu_torch.ops import hierarchy as hier
    from lumixengine_tpu_torch.renderer import clusters, shadows

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
    state = run("renderer.cull_pass", lambda: rm.cull_pass(state, dt))
    if passes:
        run("shadow_pass", lambda: shadows.shadow_pass(state, rm, LIGHT_DIR))
        run("fill_clusters", lambda: clusters.fill_clusters(state, rm))
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


def compare_with_plain(engine, world, state, step, views=False):
    """3 frames from the same W=4 state: the card's step (kernels) against the
    CPU step (plain versions), at the CPU parity tests' tolerances; with
    `views`, each frame's prepare_view (both sort modes), shadow and cluster
    passes too. Returns the errors, the flips and the card's end state."""
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
    errs, flips, kills, view_flips = {}, [], [], []
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
        if views:
            view_flips.append(compare_views(rm, gpu, cpu, margins, close))
    return {"errs": {k: float(f"{v:.3g}") for k, v in errs.items() if v}, "flips": flips,
            "kills": kills, "view_flips": view_flips, "state": gpu}


def compare_views(rm, gpu, cpu, margins, close):
    """prepare_view in both sort modes, shadow_pass and fill_clusters of
    the card's state against the CPU's: the visible and LOD masks equal
    outside the cull margins, the keys equal away from every margin and
    the depth rounding, the draw order and instance buffers equal in the
    worlds whose keys all agree; cascade geometry within 1e-5 of its
    largest magnitude, casters equal outside shadows.SHADOW_MARGIN; cluster
    words equal outside clusters.CLUSTER_D2_EPS, lists and counts equal in
    the clusters with no flipped test, overflow off by at most the flips.
    Returns the flips (instances at a margin, casters, cluster tests)."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.renderer import clusters, pipeline, shadows

    vis_m, lod_m, _light_m = margins
    depth_near = (pipeline.depth_margins(cpu, rm) < pipeline.DEPTH_EPS).numpy()
    out = {"view": 0}
    for mode in (pipeline.SORT_MATERIAL, pipeline.SORT_DEPTH):
        g = pipeline.prepare_view(gpu, rm, sort_mode=mode)
        c = pipeline.prepare_view(cpu, rm, sort_mode=mode)
        moved = g.visible.cpu().numpy() != c.visible.numpy()
        lod_off = g.lod.cpu().numpy() != c.lod.numpy()
        if np.any(moved & (np.abs(vis_m) >= MARGIN)) or np.any(lod_off & (np.abs(lod_m) >= MARGIN)):
            raise AssertionError(f"prepare_view {mode}: a mask differs away from its margin")
        moved |= lod_off | depth_near
        off = ((g.sort_key.cpu() != c.sort_key) | (g.sort_key_lo.cpu() != c.sort_key_lo)).numpy()
        if np.any(off & ~moved):
            raise AssertionError(f"prepare_view {mode}: a key differs away from every margin")
        same = torch.as_tensor(~off.any(-1))
        for f in ("order", "instance_model", "instance_slot", "visible_count"):
            if not torch.equal(getattr(g, f).cpu()[same], getattr(c, f)[same]):
                raise AssertionError(f"prepare_view {mode}: {f} differs in a world whose keys agree")
        for f in ("instance_pos", "instance_rot", "instance_scale"):
            close(f"view.{f}", getattr(g, f).cpu()[same].numpy(), getattr(c, f)[same].numpy(),
                  TRANSFORM_ATOL)
        out["view"] += int(off.sum())

    sg = shadows.shadow_pass(gpu, rm, LIGHT_DIR)
    sc = shadows.shadow_pass(cpu, rm, LIGHT_DIR)
    for f in ("splits", "center", "radius", "light_pos", "extent"):
        ref = getattr(sc, f).numpy()
        close(f"shadow.{f}", getattr(sg, f).cpu().numpy(), ref, 1e-5 * np.abs(ref).max())
    off = (sg.casters.cpu() != sc.casters).numpy()
    near = (shadows.caster_margins(cpu, rm, sc, LIGHT_DIR).abs() < shadows.SHADOW_MARGIN).numpy()
    counts = np.abs(sg.caster_count.cpu().numpy().astype(np.int64) - sc.caster_count.numpy())
    if np.any(off & ~near) or np.any(counts > off.sum(-1)):
        raise AssertionError("shadow casters differ away from a cascade plane")
    out["casters"] = int(off.sum())

    ig, ic = clusters.cluster_inputs(gpu, rm), clusters.cluster_inputs(cpu, rm)
    wg, wc = clusters._touch_words(*ig).cpu(), clusters._touch_words(*ic)
    off = clusters.unpack_words(wg ^ wc).numpy()
    if np.any(off & (clusters.touch_margins(*ic).numpy() >= clusters.CLUSTER_D2_EPS)):
        raise AssertionError("cluster words differ away from a light's range")
    lg, lc = clusters.fill_clusters(gpu, rm), clusters.fill_clusters(cpu, rm)
    same = torch.as_tensor(~off.any(-1))
    if not (torch.equal(lg.lights.cpu()[same], lc.lights[same])
            and torch.equal(lg.count.cpu()[same], lc.count[same])
            and int((lg.overflow.cpu() - lc.overflow).abs().max()) <= int(off.sum())):
        raise AssertionError("cluster lists, counts or overflow differ, card vs CPU")
    if int(lc.count.sum()) == 0:
        raise AssertionError("the cluster compare holds no light")
    out["cluster_tests"] = int(off.sum())
    return out


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

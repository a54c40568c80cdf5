#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

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
  5. the main path: full_frame_world(10240, 0, 64, 0) replicated to 1024
     worlds, 200 frames of Engine.build_step(extra=cull_pass) on the card,
     each kernel launched once per frame, a finite state, contacts and visible
     instances; then 3 frames at W=4 on the card against the plain versions on
     the CPU;
  6. timings with CUDA events: ms/frame, entity-steps/s, each kernel beside
     its plain version.

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

N_ENTITIES, N_BODIES = 10240, 64
WORLDS, FRAMES, WARM_FRAMES, SETTLE_FRAMES = 1024, 200, 10, 240
DT = 1.0 / 60.0
ITERATIONS, POSITION_ITERATIONS = 10, 3
TRANSFORM_ATOL = 1e-5    # entities the physics does not move
BODY_POS_ATOL = 1e-3
BODY_VEL_ATOL = 5e-3
MARGIN = 1e-4            # cull decisions this close to a threshold may flip
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

    engine, world, _renderer, _phys = full_frame_world(N_ENTITIES, 0, N_BODIES, 0)
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

    # 5. the main path
    state = replicate_state(single, W, torch.Generator(device=dev).manual_seed(0))
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
    active = state.modules["physics"].counters["active_contacts"]
    visible = state.modules["renderer"].counters["visible_count"]
    log(f"[5 main] full_frame_world({N_ENTITIES}, 0, {N_BODIES}, 0) x W={W}: {FRAMES} frames"
        f" in {wall:.2f} s; launches {launches}; finite {finite}; active contacts "
        f"{int(active.sum())} (worlds with contacts {int((active > 0).sum())}); visible "
        f"min/mean {int(visible.min())}/{float(visible.float().mean()):.1f}; pruned miss "
        f"{int(state.modules['physics'].counters['pruned_pair_miss'].sum())}")
    if launches != {"K1": FRAMES, "K2": FRAMES}:
        raise AssertionError(f"each kernel must launch once per frame: {launches}")
    if not finite or int(active.sum()) == 0 or int(visible.min()) <= 0:
        raise AssertionError("main path state is not finite, has no contacts or no visible instance")
    cmp = compare_with_plain(engine, world, map_tensors(lambda t: t[:4].clone(), state), step)
    log(f"[5 main] 3 frames at W=4, card vs plain on the CPU: max abs err {cmp['errs']}, "
        f"boundary flips {cmp['flips']}")

    # 6. timings
    k1_ms, k1_plain = alternate(lambda: cull.frustum_cull_plain(centers, radii, cam_planes),
                                lambda: cull.frustum_cull_cuda(centers, radii, cam_planes), 20)
    prob = problems["settled"]
    k2_ms, k2_plain = alternate(lambda: S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS),
                                lambda: S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS), 5)
    rate = W * N_ENTITIES / (ms_frame / 1e3)
    log(f"[6 time] {card}: main path {ms_frame:.3f} ms/frame at W={W} = {rate:.4g} entity-steps/s;"
        f" K1 [{W},3,{N_ENTITIES}] {k1_ms:.4f} ms (plain {k1_plain:.4f} ms);"
        f" K2 W={prob.vel.shape[0]} C={prob.act.shape[-1]} {k2_ms:.4f} ms (plain {k2_plain:.4f} ms)")

    kernels = [
        {"name": "K1 frustum_cull", "route": "cuda", "source": "lumixengine_tpu_torch/csrc/cull.cu",
         "replaces": "lumixengine_tpu/ops/culling.py:54", "launches": launches["K1"],
         "max_abs_err": k1_err, "mismatches": k1_bad, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 solve_contacts_fused", "route": "cuda",
         "source": "lumixengine_tpu_torch/csrc/solver.cu",
         "replaces": "lumixengine_tpu/ops/solver_pallas.py:165", "launches": launches["K2"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _float_tensors(state):
    import torch

    from lumixengine_tpu_torch.engine.world import map_tensors

    out = []
    map_tensors(lambda t: out.append(t) if t.is_floating_point() else None, state)
    return out


def compare_with_plain(engine, world, state, step):
    """3 frames from the same W=4 state: the card's step (kernels) against the
    CPU step (plain versions), at the CPU parity tests' tolerances."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch import bridge
    from lumixengine_tpu_torch.renderer import pipeline

    rm = world.modules["renderer"]
    cpu_step = engine.build_step(world, "cpu", extra=rm.cull_pass)
    pst = world.modules["physics"].statics()
    body = np.zeros(N_ENTITIES, bool)
    body[pst.entity_slots[pst.dyn_mask]] = True
    mi_body = body[rm.statics().mi_slots.clip(0)]
    gpu, cpu = state, state.to("cpu")
    errs, flips = {}, []

    def close(name, a, b, atol):
        err = float(np.abs(a - b).max(initial=0.0))
        errs[name] = max(errs.get(name, 0.0), err)
        if not err <= atol:
            raise AssertionError(f"{name}: card vs plain {err} > {atol}")

    for _ in range(3):
        gpu, cpu = step(gpu, DT), cpu_step(cpu, DT)
        got, ref = bridge.state_to_numpy(gpu), bridge.state_to_numpy(cpu)
        for xf in ("local", "world"):
            for f in ("pos", "rot", "scale"):
                k = f"{xf}.{f}"
                close(k, got[k][..., ~body], ref[k][..., ~body], TRANSFORM_ATOL)
                close(k + "[bodies]", got[k][..., body], ref[k][..., body], BODY_POS_ATOL)
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
        for k in ("modules.physics.sleep", "modules.physics.pair_key", "frame"):
            if not np.array_equal(got[k], ref[k]):
                raise AssertionError(f"{k}: card and plain differ")
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
    return {"errs": {k: float(f"{v:.3g}") for k, v in errs.items()}, "flips": flips}


if __name__ == "__main__":
    sys.exit(main())

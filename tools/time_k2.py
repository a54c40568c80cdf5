#!/usr/bin/env python
"""Time kernel K2 (the fused contact solve) as it ships, on the flagship's
contact sets, against its bound, and split a compact CTA's life into phases.

    python tools/time_k2.py [--worlds 1024] [--settle 240] [--reps 50]

The slice world full_frame_world(10240, 0, 64, 0) (the flagship's physics:
NB=64, C=1792) is replicated to --worlds worlds and stepped --settle frames
on the card; its contact set ("settled") and the same worlds piled up
("piled") are K2's operands, as in chip_smoke.py phase 4. For each problem
the script checks K2 against its plain version, times it with CUDA events
(two runs of --reps launches) and prints one JSON line with the card's name
and power limit: ms per launch; the bytes the function needs
(solver.k2_bytes, from the active count) and the bytes K2's kernels read and
write by their design (kernel_bytes); the bound at 3.35 TB/s and the share
of it; the worlds each of K2's kernels solves; and where a compact CTA's
time goes. For that, csrc/solver.cu is built again with -DLUMIX_K2_STAMPS
into lumixengine_tpu_torch/_build/stamps/: thread 0 of every compact CTA
stamps the card's global timer at each phase boundary of its world, which
gives the mean and 90th percentile of each phase in µs, a CTA's mean life
and the most CTAs alive at once per SM (measured, not the occupancy
calculator's answer). Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12
ITERATIONS, POSITION_ITERATIONS = 10, 3
STAMPS = 9                  # csrc/solver.cu kStamps
PHASES = ("act row", "count", "rows into records", "incidence lists", "warm start",
          "velocity passes", "lambdas, position passes", "bodies")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def flagship_problems(dev, worlds: int, settle: int):
    """K2's operands from the flagship's physics, the slice world
    full_frame_world(10240, 0, 64, 0) replicated to `worlds` worlds: after
    `settle` frames ("settled"), and the same worlds piled up ("piled")."""
    import torch

    from lumixengine_tpu_torch.models.demo_scenes import full_frame_world, pile_bodies
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    engine, world, *_ = full_frame_world(10240, 0, 64, 0)
    pm = world.modules["physics"]
    step = engine.build_step(world, dev, extra=world.modules["renderer"].cull_pass)
    s = replicate_state(world.device_state(dev), worlds, torch.Generator(device=dev).manual_seed(3))
    for _ in range(settle):
        s = step(s, 1.0 / 60.0)
    return {"settled": pm.solver_problem(s, 1.0 / 60.0),
            "piled": pm.solver_problem(pile_bodies(s), 1.0 / 60.0)}


def kernel_worlds(na, plan):
    """Masks of the worlds each of K2's kernels solves, in launch order: the
    compact tiers (a world goes to the first whose capacity holds its
    active count), then the in-place kernel."""
    import torch

    left = torch.ones_like(na, dtype=torch.bool)
    masks = []
    for cap in plan.caps:
        kept = left & (na <= cap) if cap else torch.zeros_like(left)
        masks.append(kept)
        left = left & ~kept
    return masks + [left]


def kernel_bytes(prob, plan) -> int:
    """Bytes K2's kernels read and write on `prob` by their design
    (csrc/solver.cu): every compact tier a world reaches reads its act row
    and body rows; the tier that keeps it reads the warm-start lambdas whole
    and, of the other 26 rows, the 32-byte sectors that hold an active slot
    (a row taken to start on a sector, as at C = 1792); the in-place kernel
    reads every row whole and each of a cluster's CTAs the body rows; every
    world's lambdas and bodies are written once; inv_mass is counted
    once."""
    import torch

    w, _, nb = prob.vel.shape
    c = prob.act.shape[-1]
    on = prob.act != 0
    na = on.sum(-1)
    sectors = torch.zeros((w, -(-c // 8) * 8), dtype=torch.bool, device=on.device)
    sectors[:, :c] = on
    sectors = sectors.view(w, -1, 8).any(-1).sum(-1)
    body = 9 * nb
    *tiers, in_place = kernel_worlds(na, plan)
    words = (3 * c + body) * torch.ones_like(na)   # written
    reached = torch.ones_like(on[:, 0])
    for cap, kept in zip(plan.caps, tiers):
        if cap:
            words += reached * (c + body) + kept * (3 * c + 26 * 8 * sectors)
            reached = reached & ~kept
    words += in_place * (30 * c + plan.cluster * body)
    return 4 * (int(words.sum()) + nb)


def stamped_library():
    """csrc/solver.cu built with -DLUMIX_K2_STAMPS, loaded."""
    from lumixengine_tpu_torch.ops import native

    out = native.BUILD_DIR / "stamps" / "libk2_stamps.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-DLUMIX_K2_STAMPS", "-o", str(out),
                    str(native.CSRC_DIR / "solver.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.lumix_solve_contacts.argtypes = native.library().lumix_solve_contacts.argtypes
    lib.lumix_solve_contacts.restype = ctypes.c_int
    lib.lumix_k2_set_stamps.argtypes = [ctypes.c_void_p]
    lib.lumix_k2_set_stamps.restype = ctypes.c_int
    return lib


def phases(lib, prob, plan, ref, nsm: int) -> dict:
    """One launch of the stamped build: each phase's mean and 90th
    percentile over the worlds a compact CTA solved, in µs."""
    import numpy as np
    import torch

    from lumixengine_tpu_torch.ops import native
    from lumixengine_tpu_torch.ops import solver as S

    w, _, nb = prob.vel.shape
    c = prob.act.shape[-1]
    dev = prob.vel.device
    t = prob.tensors()
    ptrs = [t[f.name].data_ptr() for f in dataclasses.fields(S.ContactProblem)]
    outs = [torch.empty_like(prob.vel) for _ in range(3)] + [torch.empty_like(prob.act)
                                                               for _ in range(3)]
    lists = torch.empty(2 + 2 * w, dtype=torch.int32, device=dev)
    stamps = torch.zeros((w, STAMPS), dtype=torch.int64, device=dev)
    native.check(lib.lumix_k2_set_stamps(stamps.data_ptr()), "lumix_k2_set_stamps")
    native.check(lib.lumix_solve_contacts(
        *ptrs, *[o.data_ptr() for o in outs], lists.data_ptr(), w, nb, c, ITERATIONS,
        POSITION_ITERATIONS, plan.cluster, plan.share, plan.threads, *plan.caps,
        S.K2_CAP_THREADS, native.stream_handle(dev)), "lumix_solve_contacts (stamped)")
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(outs, ref))
    solved = stamps[:, -1] > 0            # every stamp written: a compact CTA solved it
    a = stamps[solved]
    a = (a - a[:, 0].min()).cpu().numpy().astype(np.float64) / 1e3   # µs from the first start
    d = np.diff(a, axis=1)
    events = sorted([(x, 1) for x in a[:, 0]] + [(x, -1) for x in a[:, -1]])
    alive = most = 0
    for _, step in events:
        alive += step
        most = max(most, alive)
    return {"worlds_stamped": int(solved.sum()),
            "phase_mean_us": {k: float(d[:, j].mean()) for j, k in enumerate(PHASES)},
            "phase_p90_us": {k: float(np.percentile(d[:, j], 90)) for j, k in enumerate(PHASES)},
            "cta_life_us": float((a[:, -1] - a[:, 0]).mean()),
            "most_ctas_alive_per_sm": most / nsm, "span_us": float(a[:, -1].max()),
            "max_abs_err": err}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--worlds", type=int, default=1024)
    p.add_argument("--settle", type=int, default=240)
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_k2: no CUDA device", file=sys.stderr)
        return 2
    from lumixengine_tpu_torch.ops import solver as S

    card = card_line()
    dev = torch.device("cuda", 0)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = stamped_library()
    for name, prob in flagship_problems(dev, args.worlds, args.settle).items():
        w, _, nb = prob.vel.shape
        c = prob.act.shape[-1]
        plan = S.k2_plan(nb, c)
        ref = S.solve_plain(prob, ITERATIONS, POSITION_ITERATIONS)
        got = S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        runs = []
        for _ in range(2):
            S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.reps):
                S.solve_cuda(prob, ITERATIONS, POSITION_ITERATIONS)
            e1.record()
            torch.cuda.synchronize()
            runs.append(e0.elapsed_time(e1) / args.reps)
        ms = sum(runs) / len(runs)
        na = (prob.act != 0).sum(-1)
        n_active = int(na.sum())
        n_pair = int(((prob.act != 0) & (prob.body_b >= 0)).sum())
        need = S.k2_bytes(w, nb, c, n_active)
        flops = S.k2_flops(w, nb, c, n_active, n_pair, ITERATIONS, POSITION_ITERATIONS)
        bound_ms = max(need / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
        split = phases(lib, prob, plan, ref, nsm)
        print(json.dumps({
            "problem": name, "card": card, "W": w, "NB": nb, "C": c, "active": n_active,
            "pair_active": n_pair, "active_per_world_max": int(na.max()),
            "worlds_per_kernel": [int(m.sum()) for m in kernel_worlds(na, plan)],
            "bytes_needed": need, "bytes_kernel": kernel_bytes(prob, plan), "flops": flops,
            "bound_ms": bound_ms, "ms": ms, "runs_ms": runs, "share_of_bound": bound_ms / ms,
            "max_abs_err": err, "plan": dataclasses.asdict(plan), "stamped": split}), flush=True)
        if max(err, split["max_abs_err"]) > S.K2_PLAIN_ATOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err}, stamped "
                                 f"{split['max_abs_err']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

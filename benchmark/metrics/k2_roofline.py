"""k2_roofline: kernel K2's share of its roofline. The port's public solve
(ops/solver.py::solve, which launches K2 on the card) timed with CUDA events
on the contact problem of the window's last state (the physics module's
solver_problem); the work is the benchmark's frozen count over that
problem's active slots (harness/counts.py). None without physics or
without a contact stream."""
from lumixengine_tpu_torch.ops import solver

from benchmark.harness import counts


def read(run):
    pm = run.scene.world.modules.get("physics")
    if pm is None or not run.on_card:
        return None
    try:
        prob = pm.solver_problem(run.state, run.dt_tensor)
    except ValueError:
        return None
    it, pit = pm.solver_iterations, pm.position_iterations
    ms = run.time_ms(lambda: solver.solve(prob, it, pit))
    w, _, nb = prob.vel.shape
    c = prob.act.shape[-1]
    active = prob.act != 0
    n_act, n_pair = int(active.sum()), int((active & (prob.body_b >= 0)).sum())
    return counts.roofline_share(counts.k2_bytes(w, nb, c, n_act),
                                 counts.k2_flops(w, nb, c, n_act, n_pair, it, pit), ms / 1e3)

"""k1_roofline: kernel K1's share of its roofline. The port's public cull
entry (ops/culling.py::frustum_cull, which launches K1 on the card) timed
with CUDA events on the cull pass's own operands from the window's last
state; the work is the benchmark's frozen count (harness/counts.py)."""
from lumixengine_tpu_torch.ops import culling
from lumixengine_tpu_torch.renderer import pipeline

from benchmark.harness import counts


def read(run):
    rm = run.scene.renderer
    frustum, centers, radii = pipeline.cull_operands(run.state, run.state.modules[rm.name],
                                                     rm.statics())
    planes = frustum.planes
    ms = run.time_ms(lambda: culling.frustum_cull(centers, radii, planes))
    if ms is None:
        return None
    w, k = radii.shape[0], radii.shape[-1]
    return counts.roofline_share(counts.k1_bytes(w, k), counts.k1_flops(w, k), ms / 1e3)

"""hulls.sat_roofline: the banded polytope SAT's share of its roofline: the
least time the card's memory could move the stage's bytes in
(harness/hull_counts.py sat_bytes, at the peak of harness/counts.py) over
the device ms a frame of the span physics.banded_hulls (hulls.sat_ms). None
where the program has no such span or the world no hulls."""
from benchmark.harness import counts, hull_counts, spans


def read(run):
    ms = spans.device_ms(run, "physics.banded_hulls")
    if ms is None or not ms > 0:
        return None
    pm = run.scene.world.modules.get("physics")
    ph = run.state.modules.get("physics")
    if pm is None or ph is None or ph.sap_lam.dim() < 6 or not pm.statics().has_convex:
        return None
    st = pm.statics()
    w, sweeps, _c, k, window, nb = ph.sap_lam.shape
    nbytes = hull_counts.sat_bytes(w, nb, sweeps, k, window, st.poly_verts.shape[1],
                                   st.poly_axes.shape[1])
    return counts.roofline_share(nbytes, 0, ms / 1e3)

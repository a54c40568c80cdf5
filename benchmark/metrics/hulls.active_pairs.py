"""hulls.active_pairs: the physics state's counter hull_active in the
window's last state, the mean over its worlds: the active pair contact
slots that hold a hull, over the banded branch's sweeps. None where the
state has no such counter (no hulls, another branch, or a program without
it)."""


def read(run):
    ph = run.state.modules.get("physics")
    if ph is None or "hull_active" not in ph.counters:
        return None
    return float(ph.counters["hull_active"].double().mean())

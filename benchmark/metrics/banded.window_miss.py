"""banded.window_miss: the physics state's counter sap_window_miss in the
window's last state, the mean over its worlds: the window certificate:
bodies whose y-bound reaches past their K-th same-column successor in some
sweep (0: no contact was dropped). None where the state has no banded
warm-start carry (another branch) or no such counter."""


def read(run):
    ph = run.state.modules.get("physics")
    if ph is None or ph.sap_rank.numel() == 0 or "sap_window_miss" not in ph.counters:
        return None
    return float(ph.counters["sap_window_miss"].double().mean())

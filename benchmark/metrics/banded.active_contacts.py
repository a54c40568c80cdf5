"""banded.active_contacts: the physics state's counter active_contacts in the
window's last state, the mean over its worlds: the active contact points
(ground and pair slots) the banded branch solved. None where the state has
no banded warm-start carry (another branch) or no such counter."""


def read(run):
    ph = run.state.modules.get("physics")
    if ph is None or ph.sap_rank.numel() == 0 or "active_contacts" not in ph.counters:
        return None
    return float(ph.counters["active_contacts"].double().mean())

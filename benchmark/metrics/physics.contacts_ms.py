"""physics.contacts_ms: device time a frame of the physics contact stage
(the span physics.contacts around _contact_stage in physics/module.py's
update_parallel: broadphase, narrowphase, the contact set;
harness/spans.py)."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms(run, "physics.contacts")

"""Probe baking (counterpart of ``lumixengine_tpu/renderer/probes.py``): a
reflection or environment probe renders the scene six times from its
position into a cubemap [6, S, S, 3] of linear f32.

Each face is rastered on the host (``raster.py``) with a 90° camera whose
basis follows ``postprocess.cubemap_sky``'s texel → direction convention,
so a baked cubemap samples back through that pass (and the CubemapSky
plugin) with no seam remapping.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from lumixengine_tpu_torch.renderer import raster

# face → (axis, du, dv) of cubemap_sky's uv: direction(u, v) ∝ axis + u·du +
# v·dv, u and v in [-1, 1]; +X, -X, +Y, -Y, +Z, -Z
_FACES = [
    ((1, 0, 0), (0, 0, -1), (0, -1, 0)),
    ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),
    ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
    ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
    ((0, 0, 1), (1, 0, 0), (0, -1, 0)),
    ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),
]


def _quat_from_basis(x, y, z) -> np.ndarray:
    """Quaternion (x, y, z, w) of the rotation with world columns [x y z]."""
    m = np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64),
                  np.asarray(z, np.float64)], axis=1)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        q[3] = (m[k, j] - m[j, k]) / s
    return (q / np.linalg.norm(q)).astype(np.float32)


def face_rotations() -> list:
    """Six camera quaternions: -Z looks down each face axis, +Y up = -dv. A
    face seen from inside is the camera view's mirror image, so bake_probe
    flips each face's columns."""
    out = []
    for axis, _du, dv in _FACES:
        z = -np.asarray(axis, np.float32)
        y = -np.asarray(dv, np.float32)
        out.append(_quat_from_basis(np.cross(y, z), y, z))
    return out


def _scene_instances(runner, max_instances: int):
    """Every alive model instance (pos [N, 3], rot [N, 4], scale [N, 3],
    model [N]): probes see the whole scene, not one camera's culled set."""
    rmod = runner.world.modules["renderer"]
    st = rmod.statics()
    state = runner.state
    eidx = np.maximum(np.asarray(st.mi_slots), 0)
    alive = state.alive.cpu().numpy()[eidx] & np.asarray(st.mi_mask)
    sel = np.nonzero(alive)[0][:max_instances]
    e = eidx[sel]
    return (state.world.pos.cpu().numpy()[:, e].T, state.world.rot.cpu().numpy()[:, e].T,
            state.world.scale.cpu().numpy()[:, e].T, np.asarray(st.mi_model)[sel], rmod)


def bake_probe(runner, position, size: int = 64, max_instances: int = 2048) -> np.ndarray:
    """The scene from `position` as a [6, S, S, 3] f32 linear cubemap (the
    background 18/255 where nothing is hit)."""
    ipos, irot, iscale, models, rmod = _scene_instances(runner, max_instances)
    pos = np.asarray(position, np.float32)
    faces = np.zeros((6, size, size, 3), np.float32)
    for f, rot in enumerate(face_rotations()):
        fb = np.full((size, size, 3), 18.0, np.float32)
        zb = np.full((size, size), np.inf, np.float32)
        raster.raster_instances(fb, zb, ipos, irot, iscale, models, rmod.system.models, pos, rot,
                                np.pi / 2, size, size)
        faces[f] = fb[:, ::-1] / 255.0   # the inside view's mirror → texel layout
    return faces


def bake_all_probes(runner, size: int = 64) -> Dict[int, np.ndarray]:
    """Bake every reflection and environment probe; the cubemaps go to
    ``RendererSystem.probe_cubemaps[entity]`` and are returned."""
    rmod = runner.world.modules["renderer"]
    out = getattr(rmod.system, "probe_cubemaps", None)
    if out is None:
        out = rmod.system.probe_cubemaps = {}
    wpos = runner.state.world.pos.cpu().numpy()
    for store in (rmod.reflection_probes, rmod.environment_probes):
        for slot in range(store.capacity):
            e = int(store.entity[slot])
            if e >= 0:
                out[e] = bake_probe(runner, wpos[:, runner.world.slot(e)], size=size)
    return out

"""Kernel K1's plain version and the cull pass against the reference
(frustum_cull_pallas in interpret mode, frustum_cull_jnp, cull_pass)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.core import geometry as rgeom
from lumixengine_tpu.ops import culling as rcull
from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.ops import culling as cull
from test_torch_bridge import (DT, assert_masks_agree, cull_margins, port_world,
                               ref_to_numpy, settled_reference)

torch.set_num_threads(1)


def _scene(seed, n=3000):
    """A camera and spheres: random ones, plus spheres centred on each of the
    6 planes (radius 0) and spheres tangent to a plane from outside."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(0, np.pi)
    rot = np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]]).astype(np.float32)
    fr = rgeom.perspective_frustum(jnp.asarray(rng.uniform(-5, 5, 3).astype(np.float32)),
                                   jnp.asarray(rot), 1.2, 16 / 9, 0.3, 80.0)
    planes = np.asarray(fr.planes)
    centers = [rng.uniform(-80, 80, (3, n)).astype(np.float32)]
    radii = [rng.uniform(0, 4, n).astype(np.float32)]
    for p in range(6):
        x = rng.uniform(-60, 60, (3, 100))
        nrm, dd = planes[p, :3].astype(np.float64), float(planes[p, 3])
        on = x - np.outer(nrm, nrm @ x + dd)
        r = rng.uniform(0.1, 2.0, 100)
        centers += [on.astype(np.float32), (on - nrm[:, None] * r).astype(np.float32)]
        radii += [np.zeros(100, np.float32), r.astype(np.float32)]
    centers, radii = np.concatenate(centers, 1), np.concatenate(radii)
    margin = (planes[:6, :3].astype(np.float64) @ centers + planes[:6, 3:]).min(0) + radii
    return fr, planes, centers, radii, margin


@pytest.mark.parametrize("seed", range(4))
def test_plain_k1_matches_reference_kernel(seed):
    fr, planes, centers, radii, margin = _scene(seed)
    got = cull.frustum_cull_plain(torch.tensor(centers)[None], torch.tensor(radii)[None],
                                  torch.tensor(planes)[None])[0].numpy()
    pallas = np.asarray(rcull.frustum_cull_pallas(jnp.asarray(centers), jnp.asarray(radii), fr,
                                                  interpret=True))
    jnp_ref = np.asarray(rcull.frustum_cull_jnp(jnp.asarray(centers), jnp.asarray(radii), fr))
    assert 0 < got.sum() < got.size
    flips = [assert_masks_agree(name, got, ref, margin, boundary=1e-5)
             for name, ref in (("pallas", pallas), ("jnp", jnp_ref))]
    print(f"seed {seed}: boundary flips vs pallas/jnp {flips} of {got.size}")


def test_frustum_cull_batches_worlds_on_cpu():
    """The dispatcher flattens leading axes, takes the plain version for CPU
    tensors and never counts a kernel launch there."""
    scenes = [_scene(s, n=500) for s in range(3)]
    c = torch.tensor(np.stack([s[2] for s in scenes]))
    r = torch.tensor(np.stack([s[3] for s in scenes]))
    p = torch.tensor(np.stack([s[1] for s in scenes]))
    before = cull.frustum_cull_cuda.launches
    out = cull.frustum_cull(c[:, None], r[:, None], p[:, None])
    assert out.shape == r[:, None].shape and out.dtype == torch.bool
    for i in range(3):
        assert torch.equal(out[i, 0], cull.frustum_cull_plain(c[i:i + 1], r[i:i + 1], p[i:i + 1])[0])
    assert cull.frustum_cull_cuda.launches == before


def test_frustum_cull_refuses_other_devices():
    c = torch.zeros((1, 3, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cull.frustum_cull(c, torch.zeros((1, 8), device="meta"), torch.zeros((1, 8, 4), device="meta"))


@pytest.mark.parametrize("frames", [0, 120])
def test_cull_pass_matches_reference(frames):
    if frames:
        _e, rworld, rstate = settled_reference(frames)
    else:
        from test_torch_bridge import reference_world

        _e, rworld, _r, _p = reference_world()
        rstate = rworld.device_state()
    rmod = rworld.modules["renderer"]
    ref = ref_to_numpy(jax.jit(lambda s: rmod.cull_pass(s, jnp.float32(DT)))(rstate))
    _pe, pworld, _pr, _pp = port_world()
    state = bridge.state_from_numpy(ref_to_numpy(rstate), "cpu")
    got = bridge.state_to_numpy(pworld.modules["renderer"].cull_pass(state, torch.tensor(DT)))
    mi_m, lod_m, light_m = cull_margins(pworld, state)
    p = "modules.renderer."
    flips = [assert_masks_agree("mi_visible", got[p + "mi_visible"], ref[p + "mi_visible"], mi_m),
             assert_masks_agree("mi_lod", got[p + "mi_lod"], ref[p + "mi_lod"], lod_m),
             assert_masks_agree("pl_visible", got[p + "pl_visible"], ref[p + "pl_visible"], light_m)]
    print(f"frame {frames}: boundary flips {flips}")
    for counter, mask in (("visible_count", "mi_visible"), ("lights_visible", "pl_visible")):
        assert got[p + "counters." + counter] == got[p + mask].sum()
    assert abs(int(got[p + "counters.visible_count"]) - int(ref[p + "counters.visible_count"])) <= flips[0]
    assert 0 < got[p + "counters.visible_count"] < got[p + "mi_visible"].size

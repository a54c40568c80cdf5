"""A world whose model instances name FBX files, in the port and in the JAX
package: ``asset_scenes.asset_stress_scene`` at test size (the load-and-save
phase's stress scene with its models on the character, the box, the sphere
and the rock that ``asset_scenes.write_assets`` writes, the animables on the
character's take) instantiated in both packages gives equal worlds (the
report's counters among them: every FBX path a real model, the take a real
clip, no placeholder), and 3 Runner ticks agree within the load-and-save
tests' tolerances (tests/test_torch_instantiate.py), the skinned
characters' poses and palettes included."""
import numpy as np
import pytest

from lumixengine_tpu_torch import bridge
from lumixengine_tpu_torch.models import asset_scenes as A
from lumixengine_tpu_torch.models import host_scenes as H
from test_torch_bridge import ref_to_numpy
from test_torch_instantiate import _runner, assert_instances_equal, compare_frame, instantiate


@pytest.fixture(scope="module")
def asset_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("assets"))
    A.write_assets(d)
    H.write_stress_nav(d)
    return d


def scene():
    return A.asset_stress_scene(entities=300, bodies=16, agents=8)


def test_asset_scene_instantiates_equal_worlds(asset_dir):
    sc = scene()
    named = {mi["model"] for mi in sc["renderer"]["model_instances"]}
    assert named == {A.CHARACTER, *A.PROPS.values()}
    rinst, pinst = instantiate("jax", sc, (asset_dir,)), instantiate("torch", sc, (asset_dir,))
    assert_instances_equal(rinst, pinst)
    rep = pinst.report
    assert rep["model_fbx"] == len(named) and rep["clip_fbx"] == 1
    assert rep["model_placeholder"] == 0 and rep["clip_placeholder"] == 0
    models = pinst.world.modules["renderer"].system.models
    char = models.get(models.get_id(A.CHARACTER))
    assert char.skeleton.bone_count == 52 and len(char.vertex_positions) > 20_000
    rock = models.get(models.get_id(A.PROPS["rock"]))
    # the .meta: scale 0.5, origin at the bottom, three LODs
    assert abs(float(rock.vertex_positions[:, 1].min())) < 1e-6
    assert np.isfinite(rock.lod_distances[:3]).all() and np.isinf(rock.lod_distances[3])


def test_asset_scene_three_ticks_match_reference(asset_dir):
    sc = scene()
    rr, pr = _runner("jax", sc, asset_dir), _runner("torch", sc, asset_dir)
    assert pr.world.entity_count == rr.world.entity_count > 300
    errs, flips = {}, []
    for _ in range(3):
        rr.tick()
        pr.tick()
        got, ref = bridge.state_to_numpy(pr.state), ref_to_numpy(rr.state)
        assert set(got) == set(ref)
        flips.append(compare_frame(pr.world, pr.state, got, ref, errs))
    print("boundary flips", flips, "max abs err", {k: v for k, v in errs.items() if v > 0})
    assert int(got["frame"]) == 3
    pal = got["modules.animation.palette"]
    assert pal.shape[-1] >= 16 and np.abs(pal).max() > 0

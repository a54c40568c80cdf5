"""The binary FBX importer in the port (importers/fbx.py) against the JAX
package, on documents written by ``models/asset_scenes.py`` (the repository
ships no FBX file): the parsed node trees are equal for versions 7400 and
7500 with arrays raw and zlib-deflated, and so are every scalar and array
property type; ``to_model`` on a small skinned document (each UV mapping)
and on the character (52 bones, 22,568 control points), the props and
``to_clip`` of their takes agree: skeleton names, parents, triangles and
bone ids exactly, positions, UVs, weights, bind poses, radii and clip
tracks within ATOL; ``local_matrix`` under every rotation order with pivots,
offsets and pre- and post-rotation, and ``geometric_matrix``, within ATOL;
and the character meets the bounds the JAX package's tests hold the
reference's mixamo "Y bot" to (tests/test_fbx_import.py)."""
import numpy as np
import pytest

from lumixengine_tpu.importers import fbx as rfbx
from lumixengine_tpu_torch.core import host_math as hm
from lumixengine_tpu_torch.importers import fbx as pfbx
from lumixengine_tpu_torch.models import asset_scenes as A

ATOL = 1e-6        # both packages run the same float64 numpy chain; equal in practice


def assert_trees_equal(r, p, path="root"):
    assert p.name == r.name, path
    assert len(p.props) == len(r.props), path
    for i, (a, b) in enumerate(zip(r.props, p.props)):
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype, f"{path}.{i}"
            np.testing.assert_array_equal(b, a, err_msg=f"{path}.{i}")
        else:
            assert type(b) is type(a) and b == a, f"{path}.{i}"
    assert len(p.children) == len(r.children), path
    for k, (a, b) in enumerate(zip(r.children, p.children)):
        assert_trees_equal(a, b, f"{path}/{a.name}[{k}]")


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "zlib"])
@pytest.mark.parametrize("version", [7400, 7500])
def test_node_trees_equal(version, compress):
    data = A.skinned_fbx(3, version, compress)
    r, p = rfbx.parse_fbx(data), pfbx.parse_fbx(data)
    assert p.props == [version]
    assert_trees_equal(r, p)
    assert [c.name for c in p.children] == ["GlobalSettings", "Objects", "Connections"]


@pytest.mark.parametrize("version", [7400, 7500])
def test_every_property_type(version):
    rng = np.random.default_rng(4)
    props = [np.int16(-7), True, False, np.int32(-123456), np.float32(1.25), 2.5, 1 << 40,
             "name\x00\x01Model", b"\x00raw\xff",
             rng.random(5).astype(np.float32), rng.random(4), np.arange(-3, 3, dtype=np.int64),
             np.arange(7, dtype=np.int32), rng.random(9) > 0.5]
    nodes = [("Top", props, [("Child", [np.int32(1)], []), ("Leaf", [], [])]), ("Empty", [], [])]
    for compress in (False, True):
        data = A.fbx_bytes(nodes, version, compress)
        r, p = rfbx.parse_fbx(data), pfbx.parse_fbx(data)
        assert_trees_equal(r, p)
        got = p.children[0].props
        assert got[:9] == [-7, True, False, -123456, 1.25, 2.5, 1 << 40, "name\x00\x01Model",
                           b"\x00raw\xff"]
        for a, b in zip(got[9:], props[9:]):
            np.testing.assert_array_equal(a, b)


def test_not_an_fbx_raises_in_both():
    for mod in (rfbx, pfbx):
        with pytest.raises(ValueError, match="not a binary FBX"):
            mod.parse_fbx(b"; FBX 7.4.0 project file")


def assert_models_equal(rm, pm):
    assert pm.name == rm.name
    assert (pm.skeleton is None) == (rm.skeleton is None)
    if rm.skeleton is not None:
        rs, ps = rm.skeleton, pm.skeleton
        assert ps.bone_names == rs.bone_names
        np.testing.assert_array_equal(ps.bone_parent, rs.bone_parent)
        np.testing.assert_allclose(ps.bind_pos, rs.bind_pos, atol=ATOL, rtol=0)
        np.testing.assert_allclose(ps.bind_rot, rs.bind_rot, atol=ATOL, rtol=0)
    for k in ("vertex_positions", "vertex_uvs", "vertex_weights", "lod_distances"):
        a, b = getattr(rm, k), getattr(pm, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert b.dtype == a.dtype and b.shape == a.shape, k
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=0, err_msg=k)
    for k in ("vertex_triangles", "vertex_bones4", "vertex_bone"):
        a, b = getattr(rm, k), getattr(pm, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert b.dtype == a.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=k)
    assert abs(pm.bounding_radius - rm.bounding_radius) <= ATOL


def assert_clips_equal(rc, pc):
    assert (pc.name, pc.fps, pc.flags) == (rc.name, rc.fps, rc.flags)
    assert pc.pos.shape == rc.pos.shape and pc.rot.shape == rc.rot.shape
    np.testing.assert_allclose(pc.pos, rc.pos, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pc.rot, rc.rot, atol=ATOL, rtol=0)


def both_docs(data):
    return rfbx.FbxDoc(rfbx.parse_fbx(data)), pfbx.FbxDoc(pfbx.parse_fbx(data))


@pytest.mark.parametrize("uv_mode", ["control_point", "polygon_vertex", "indexed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_small_skinned_model_and_clip(seed, uv_mode):
    rdoc, pdoc = both_docs(A.skinned_fbx(seed, 7400 + 100 * seed, bool(seed), uv_mode))
    assert pdoc.scale == rdoc.scale
    assert sorted(pdoc.objects) == sorted(rdoc.objects)
    assert pdoc.parents == rdoc.parents and pdoc.children == rdoc.children
    rm, pm = rfbx.to_model(rdoc, name="s"), pfbx.to_model(pdoc, name="s")
    assert_models_equal(rm, pm)
    # "Armature" has no cluster: its bind pose is its transform chain's
    assert pm.skeleton.bone_names[0] == "Armature" and pm.skeleton.bone_count == 7
    rsk, pids, pbind = pfbx.build_skeleton(pdoc)
    _, rids, rbind = rfbx.build_skeleton(rdoc)
    assert pids == rids and sorted(pbind) == sorted(rbind)
    for k in rbind:
        np.testing.assert_allclose(pbind[k], rbind[k], atol=ATOL, rtol=0)
    assert_clips_equal(rfbx.to_clip(rdoc, rm.skeleton, name="t", fps=24.0, flags=3),
                       pfbx.to_clip(pdoc, pm.skeleton, name="t", fps=24.0, flags=3))


@pytest.fixture(scope="module")
def character():
    data = A.character_fbx(0)
    rdoc, pdoc = both_docs(data)
    return rdoc, pdoc, rfbx.to_model(rdoc, name="character"), pfbx.to_model(pdoc,
                                                                            name="character")


def test_character_model_and_take_equal(character):
    rdoc, pdoc, rm, pm = character
    assert_models_equal(rm, pm)
    rc, pc = rfbx.to_clip(rdoc, rm.skeleton, name="take"), pfbx.to_clip(pdoc, pm.skeleton,
                                                                        name="take")
    assert_clips_equal(rc, pc)
    assert pc.pos.shape == (31, 52, 3)               # 1 s at 30 fps
    assert np.ptp(pc.pos[:, 0, 2]) > 0.3            # the hips move 40 cm
    assert np.abs(pc.rot[1:] - pc.rot[:1]).max() > 0.05


def test_character_meets_the_ybot_bounds(character):
    """tests/test_fbx_import.py's bounds on the reference's ybot.fbx."""
    m = character[3]
    sk = m.skeleton
    assert sk.bone_count == 52
    assert sk.bone_names[0] == "mixamorig:Hips"
    assert (sk.bone_parent < np.arange(sk.bone_count)).all()
    gp = np.zeros((sk.bone_count, 3))
    gr = np.zeros((sk.bone_count, 4))
    for i in range(sk.bone_count):
        p = sk.bone_parent[i]
        if p < 0:
            gp[i], gr[i] = sk.bind_pos[i], sk.bind_rot[i]
        else:
            gp[i] = gp[p] + hm.quat_rotate(gr[p], sk.bind_pos[i])
            gr[i] = hm.quat_mul(gr[p], sk.bind_rot[i])
    assert 1.3 < gp[:, 1].max() < 2.0
    assert m.vertex_positions.shape[0] > 20_000
    assert 1.5 < m.bounding_radius < 2.5
    assert np.abs(m.vertex_weights.sum(1) - 1).max() < 1e-5
    assert m.vertex_bones4.max() < sk.bone_count
    # more than 4 influences on a vertex: to_model keeps the top 4
    assert (m.vertex_weights > 0).sum(1).max() == 4


@pytest.mark.parametrize("make", [A.box_fbx, A.sphere_fbx, A.rock_fbx],
                         ids=["box", "sphere", "rock"])
def test_props_equal(make):
    rdoc, pdoc = both_docs(make(2))
    rm, pm = rfbx.to_model(rdoc, name="p"), pfbx.to_model(pdoc, name="p")
    assert_models_equal(rm, pm)
    assert pm.skeleton is None and pm.vertex_uvs is not None
    with pytest.raises(ValueError, match="no animation stack"):
        pfbx.to_clip(pdoc, None)


@pytest.mark.parametrize("order", range(6))
def test_local_matrix_every_rotation_order(order):
    rng = np.random.default_rng(order)
    keys = ("Lcl Translation", "Lcl Rotation", "Lcl Scaling", "RotationOffset",
            "RotationPivot", "PreRotation", "PostRotation", "ScalingOffset", "ScalingPivot",
            "GeometricTranslation", "GeometricRotation", "GeometricScaling")
    for _ in range(20):
        props = {k: list(rng.uniform(-90, 90, 3)) for k in keys}
        props["Lcl Scaling"] = list(rng.uniform(0.5, 2.0, 3))
        props["GeometricScaling"] = list(rng.uniform(0.5, 2.0, 3))
        props["RotationOrder"] = [order]
        np.testing.assert_allclose(pfbx.local_matrix(props), rfbx.local_matrix(props),
                                   atol=ATOL, rtol=0)
        t, r, s = rng.uniform(-5, 5, 3), rng.uniform(-180, 180, 3), rng.uniform(0.5, 2, 3)
        np.testing.assert_allclose(pfbx.local_matrix(props, t=t, r=r, s=s),
                                   rfbx.local_matrix(props, t=t, r=r, s=s), atol=ATOL, rtol=0)
        np.testing.assert_allclose(pfbx.geometric_matrix(props), rfbx.geometric_matrix(props),
                                   atol=ATOL, rtol=0)
        m = rfbx.local_matrix(props)
        for a, b in zip(pfbx._mat_to_posquat(m, 0.01), rfbx._mat_to_posquat(m, 0.01)):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)

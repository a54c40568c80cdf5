"""The editor's edit model in the port (editor/commands.py,
editor/entity_folders.py, editor/gizmo.py) against the JAX package, on the
CPU. Each test runs one script through both packages' classes:

* every command's do, undo and redo as tests/test_editor.py's flows have
  them, with the edited worlds equal between the packages after each step
  (host rows and component records exactly; the undo snapshot of
  ``DestroyEntitiesCommand``, a world blob, byte for byte);
* entity folders: the tree, membership and the blob equal;
* gizmo picks equal and drags (translate, rotate, scale; global and local;
  with snapping) within GIZMO_ATOL of the reference on seeded rays.
"""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

PKG = {"jax": "lumixengine_tpu", "torch": "lumixengine_tpu_torch"}
GIZMO_ATOL = 1e-9       # the same float64 formulas; float32 where both cast


def mod(pkg, name):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def demo(pkg, n=64, spare_capacity=0):
    mod(pkg, "engine.reflection").register_builtin_components()
    engine, world, _ = mod(pkg, "models.demo_scenes").headless_demo_world(num_entities=n)
    if pkg == "torch":
        engine.device = torch.device("cpu")
    if spare_capacity:
        world = engine.create_world(capacity=spare_capacity)
    return engine, world


def host_rows(pkg, world):
    """The host world as the editor edits it: entity rows, names and every
    module's component records."""
    ser = mod(pkg, "engine.serialize")
    rows = {k: np.asarray(getattr(world, k)).copy()
            for k in ("alive", "parent", "local_pos", "local_rot", "local_scale")}
    rows["names"] = dict(world.names)
    rows["components"] = {n: ser._dump_module_components(m) for n, m in world.modules.items()}
    return rows


def assert_rows_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        else:
            assert b[k] == a[k], k


def run_both(script):
    """script(pkg) -> list of snapshots; the packages' lists must be equal."""
    out = {pkg: script(pkg) for pkg in ("jax", "torch")}
    assert len(out["jax"]) == len(out["torch"]) > 0
    for a, b in zip(out["jax"], out["torch"]):
        assert_rows_equal(a, b)
    return out


# -- commands -----------------------------------------------------------------------------

def test_property_undo_redo_and_merge():
    def script(pkg):
        C = mod(pkg, "editor.commands")
        reg = mod(pkg, "engine.reflection").registry
        engine, world = demo(pkg)
        stack = C.CommandStack(world)
        e = next(e for e in range(world.capacity)
                 if world.is_alive(e) and world.has_component(e, "point_light"))
        orig = float(reg.get_property(world, e, "point_light", "intensity"))
        snaps = [host_rows(pkg, world)]
        for v in (5.0, 6.0, 7.0):
            stack.execute(C.SetPropertyCommand(e, "point_light", "intensity", v))
        assert len(stack._undo) == 1
        assert float(reg.get_property(world, e, "point_light", "intensity")) == 7.0
        snaps.append(host_rows(pkg, world))
        stack.undo()
        assert float(reg.get_property(world, e, "point_light", "intensity")) == orig
        snaps.append(host_rows(pkg, world))
        stack.redo()
        assert float(reg.get_property(world, e, "point_light", "intensity")) == 7.0
        snaps.append(host_rows(pkg, world))
        return snaps

    run_both(script)


def test_transform_undo_redo_and_merge():
    def script(pkg):
        C = mod(pkg, "editor.commands")
        engine, world = demo(pkg, spare_capacity=16)
        e = world.create_entity(position=(1.0, 2.0, 3.0))
        c = world.create_entity(position=(0.5, 0.0, 0.0), parent=e)
        stack = C.CommandStack(world)
        snaps = []
        stack.execute(C.SetTransformCommand(e, position=(9.0, 9.0, 9.0)))
        stack.execute(C.SetTransformCommand(e, rotation=(0.0, 0.38268343, 0.0, 0.9238795)))
        assert len(stack._undo) == 1
        stack.execute(C.SetTransformCommand(c, scale=(2.0, 2.0, 2.0)))
        np.testing.assert_allclose(world.get_global_transform(e)[0], [9, 9, 9], atol=1e-5)
        snaps.append(host_rows(pkg, world))
        stack.undo()
        snaps.append(host_rows(pkg, world))
        stack.undo()
        np.testing.assert_allclose(world.get_global_transform(e)[0], [1, 2, 3], atol=1e-5)
        snaps.append(host_rows(pkg, world))
        stack.redo()
        stack.redo()
        snaps.append(host_rows(pkg, world))
        return snaps

    run_both(script)


def test_create_destroy_undo_restores_subtree_and_components():
    blobs = {}

    def script(pkg):
        C = mod(pkg, "editor.commands")
        engine, world = demo(pkg, spare_capacity=16)
        stack = C.CommandStack(world)
        cmd = C.CreateEntityCommand(position=(5.0, 0.0, 0.0), name="boss")
        stack.execute(cmd)
        boss = cmd.entity
        stack.execute(C.AddComponentCommand(boss, "point_light", intensity=3.0))
        child = world.create_entity(position=(5.5, 0.0, 0.0), name="minion")
        world.set_parent(child, boss)
        snaps = [host_rows(pkg, world)]
        destroy = C.DestroyEntitiesCommand([boss])
        stack.execute(destroy)
        blobs[pkg] = destroy._blob
        assert not world.is_alive(boss) and not world.is_alive(child)
        snaps.append(host_rows(pkg, world))
        stack.undo()
        assert world.is_alive(boss) and world.is_alive(child)
        assert world.get_parent(child) == boss
        assert world.has_component(boss, "point_light")
        assert world.get_entity_name(child) == "minion"
        snaps.append(host_rows(pkg, world))
        stack.redo()
        snaps.append(host_rows(pkg, world))
        stack.undo()
        stack.undo()
        assert not world.has_component(boss, "point_light")
        snaps.append(host_rows(pkg, world))
        stack.undo()
        assert not world.is_alive(boss)
        snaps.append(host_rows(pkg, world))
        stack.redo()
        snaps.append(host_rows(pkg, world))
        return snaps

    run_both(script)
    assert blobs["torch"] == blobs["jax"]


def test_destroy_an_entity_with_components_of_the_demo_world():
    """DestroyEntitiesCommand over a demo entity with a model instance and a
    parent chain: the undo snapshot equal byte for byte, the world restored."""
    blobs = {}

    def script(pkg):
        C = mod(pkg, "editor.commands")
        engine, world = demo(pkg)
        stack = C.CommandStack(world)
        kids = {int(p) for p in world.parent if p >= 0}
        victims = [e for e in sorted(kids)
                   if world.has_component(e, "model_instance")][:2]
        assert victims
        snaps = [host_rows(pkg, world)]
        cmd = C.DestroyEntitiesCommand(victims)
        stack.execute(cmd)
        blobs[pkg] = cmd._blob
        snaps.append(host_rows(pkg, world))
        stack.undo()
        snaps.append(host_rows(pkg, world))
        # restored: the same records, the store slots (record order) aside
        a, b = snaps[0], snaps[-1]
        assert_rows_equal({k: v for k, v in a.items() if k != "components"},
                          {k: v for k, v in b.items() if k != "components"})
        for m in a["components"]:
            key = (lambda r: (r["entity"], r["type"]))
            assert sorted(b["components"][m], key=key) == sorted(a["components"][m], key=key)
        return snaps

    run_both(script)
    assert blobs["torch"] == blobs["jax"]


def test_instantiate_prefab_and_spline_points():
    def script(pkg):
        C = mod(pkg, "editor.commands")
        ser = mod(pkg, "engine.serialize")
        engine = mod(pkg, "app").create_full_engine(**({"device": "cpu"} if pkg == "torch" else {}))
        world = engine.create_world(capacity=32)
        root = world.create_entity(position=(1.0, 2.0, 3.0), name="turret")
        world.create_entity(position=(0.0, 1.0, 0.0), parent=root, name="barrel")
        world.create_component(root, "point_light", intensity=4.0)
        track = world.create_entity(name="track")
        world.create_component(track, "spline", points=[[0, 0, 0], [2, 0, 0], [4, 1, 0]])
        blob = ser.make_prefab(world, [root])
        stack = C.CommandStack(world)
        snaps = []
        cmd = C.InstantiatePrefabCommand(blob, position=(3.0, 2.0, 3.0))
        stack.execute(cmd)
        assert len(cmd.created) == 2
        snaps.append(host_rows(pkg, world))
        stack.undo()
        snaps.append(host_rows(pkg, world))
        stack.redo()
        snaps.append(host_rows(pkg, world))
        pts = world.modules["core"].splines[track].copy()
        for i, dx in enumerate((0.5, 0.5, 0.25)):
            p = pts.copy()
            p[1, 0] += dx * (i + 1)
            stack.execute(C.SetSplinePointsCommand(track, p, merge_id=1))
        assert len(stack._undo) == 2
        stack.execute(C.SetSplinePointsCommand(track, pts[:2], merge_id=2))
        snaps.append(host_rows(pkg, world))
        stack.undo()
        snaps.append(host_rows(pkg, world))
        stack.undo()
        np.testing.assert_array_equal(world.modules["core"].splines[track], pts)
        snaps.append(host_rows(pkg, world))
        return snaps

    run_both(script)


# -- entity folders -----------------------------------------------------------------------

class _FakeWorld:
    pass


def _folder_rows(ef):
    return {"folders": {k: (f.id, f.name, f.parent, list(f.children), list(f.entities),
                            f.partition) for k, f in ef.folders.items()},
            "of": dict(ef.entity_folder),
            "selected": ef.selected_folder,
            "blob": ef.serialize()}


def test_entity_folders_match_reference():
    def script(pkg):
        F = mod(pkg, "editor.entity_folders")
        ef = F.EntityFolders(_FakeWorld())
        root = ef.get_root(0)
        out = [_folder_rows(ef)]
        ef.on_entity_created(10)
        props = ef.emplace_folder("props")
        ef.select_folder(props)
        for e in (11, 12, 13):
            ef.on_entity_created(e)
        deco = ef.emplace_folder("decoration", parent=props)
        ef.move_to_folder(12, deco)
        out.append(_folder_rows(ef))
        assert ef.folder_entities(props) == [11, 13]
        ef.rename_folder(deco, "deco2")
        ef.move_folder(deco, root)
        with pytest.raises(ValueError):
            ef.move_folder(root, deco)
        out.append(_folder_rows(ef))
        ef.destroy_folder(props)
        ef.on_entity_destroyed(11)
        assert ef.get_folder(11) == F.INVALID_FOLDER
        out.append(_folder_rows(ef))
        ef2 = F.EntityFolders(_FakeWorld())
        ef2.deserialize(ef.serialize(), entity_map={12: 120, 13: 130})
        assert ef2.get_folder(120) == deco
        out.append(_folder_rows(ef2))
        return out

    res = {pkg: script(pkg) for pkg in ("jax", "torch")}
    assert res["torch"] == res["jax"]


# -- gizmo ----------------------------------------------------------------------------------

def _gizmo_script(pkg, seed):
    G = mod(pkg, "editor.gizmo")
    hm = mod(pkg, "core.host_math")
    rng = np.random.default_rng(seed)
    out = []
    for mode in (G.Mode.TRANSLATE, G.Mode.ROTATE, G.Mode.SCALE):
        for coord in (G.CoordSystem.GLOBAL, G.CoordSystem.LOCAL):
            for step in (False, True):
                cfg = G.Config(mode=mode, coord_system=coord, is_step=step,
                               steps=(0.5, np.pi / 8, 0.25),
                               anisotropic_scale=bool(rng.integers(2)))
                pos = rng.uniform(-2, 2, 3)
                rot = hm.quat_from_axis_angle(
                    (rng.normal(size=3) / 1.7).astype(np.float32),
                    np.float32(rng.uniform(-1, 1)))
                rot = np.asarray(rot, np.float32)
                rot = rot / np.linalg.norm(rot)
                scale = rng.uniform(0.5, 2.0, 3)
                for handle in (G.Handle.X, G.Handle.Y, G.Handle.Z, G.Handle.XY,
                               G.Handle.XZ, G.Handle.YZ):
                    if mode != G.Mode.TRANSLATE and handle > G.Handle.Z:
                        continue
                    o = pos + rng.uniform(-0.8, 0.8, 3) + [0.0, 0.0, -5.0]
                    d = pos - o + rng.normal(size=3) * 0.1
                    d = d / np.linalg.norm(d)
                    out.append(("pick", int(G.pick(cfg, pos, rot, o, d))))
                    ds = G.start_drag(cfg, handle, pos, rot, scale, o, d)
                    for _ in range(3):
                        o2 = o + rng.uniform(-1.5, 1.5, 3)
                        p, r, s = G.drag(cfg, ds, o2, d)
                        out.append(("drag", np.asarray(p, np.float64),
                                    np.asarray(r, np.float64), np.asarray(s, np.float64)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gizmo_drags_match_reference(seed):
    ref = _gizmo_script("jax", seed)
    got = _gizmo_script("torch", seed)
    assert len(got) == len(ref)
    worst = 0.0
    for g, r in zip(got, ref):
        assert g[0] == r[0]
        if g[0] == "pick":
            assert g[1] == r[1]
            continue
        for a, b in zip(g[1:], r[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_allclose(a, b, rtol=0, atol=GIZMO_ATOL)
    print(f"seed {seed}: gizmo max abs err {worst:.3e}")


def test_gizmo_snapping_rounds_to_the_step():
    """tests/test_editor_tools.py's axis drag with snapping, in the port."""
    G = mod("torch", "editor.gizmo")
    ident = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
    cfg = G.Config(mode=G.Mode.TRANSLATE)
    ds = G.start_drag(cfg, G.Handle.X, np.zeros(3), ident, np.ones(3),
                      [0.5, 0.0, -5.0], [0.0, 0.0, 1.0])
    p, r, _ = G.drag(cfg, ds, [1.75, 0.0, -5.0], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(p, [1.25, 0.0, 0.0], atol=1e-5)
    cfg.is_step = True
    cfg.steps = (1.0, np.pi / 8, 1.0)
    p, _, _ = G.drag(cfg, ds, [1.75, 0.0, -5.0], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(p, [1.0, 0.0, 0.0], atol=1e-5)

"""The plain reference against the port's plain CPU path at small sizes:
the same scene from the same recipe and seed, the start and three frames
each from its own state, and frames of a pile of touching bodies stepped
from the port's state (the contact stage, the solve, the warm start)."""
import pytest
import torch

from benchmark.harness import check, tree
from benchmark.harness import scene as scenes
from benchmark.reference import model, recipe
from benchmark.tests.small import SEED, SMALL_ARGS

ATOL = 1e-5          # float32 paths of different code: rounding alone
CASES = [("full_frame", "models.demo_scenes.full_frame_world", SMALL_ARGS["full_frame"]),
         ("skinned_crowd", "models.demo_scenes.skinned_crowd_world", {"num_characters": 24,
                                                                      "animator_fraction": 0.5})]


def sides(config, seed=SEED):
    prog = scenes.build(config, seed, "cpu")
    return prog, model.Model(recipe.build(config, seed), "cpu")


def assert_close(got, want, margins=None, what=""):
    gaps = check.world_gaps(got, want, margins)
    for group, g in gaps.items():
        limit = 0 if group == "decisions" else ATOL
        assert float(g.max()) <= limit, (what, group, float(g.max()))
    return gaps


@pytest.mark.parametrize("name,builder,args", CASES, ids=[c[0] for c in CASES])
def test_the_reference_follows_the_port_from_its_own_start(name, builder, args):
    prog, ref = sides({"builder": builder, "args": args})
    step = prog.build_step()
    state = prog.start(3, SEED)
    mine = ref.start(3, torch.Generator().manual_seed(scenes.seed_of(SEED)))
    got = tree.flatten(state)
    for k, v in mine.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    groups = assert_close(got, mine, what="start")
    assert {"transform", "pose", "clock", "decisions"} <= set(groups)
    for frame in range(3):
        state = step(state, 1 / 60)
        mine = ref.frame(mine, 1 / 60)
        assert_close(tree.flatten(state), mine, ref.margins(mine), what=f"frame {frame + 1}")


def test_the_reference_solves_a_pile_as_the_port_does():
    """Every world's bodies moved into a pile (boxes and spheres touching
    each other and the ground); ten frames, the reference stepping from the
    port's state before each."""
    from lumixengine_tpu_torch.models.demo_scenes import pile_bodies

    prog, ref = sides({"builder": CASES[0][1], "args": CASES[0][2]})
    step = prog.build_step()
    state = pile_bodies(prog.start(3, SEED))
    for frame in range(10):
        before = tree.flatten(state)
        state = step(state, 1 / 60)
        mine = ref.frame(before, 1 / 60)
        gaps = assert_close(tree.flatten(state), mine, ref.margins(mine), what=f"frame {frame}")
        assert {"body", "lambda", "particle"} <= set(gaps)
    assert int(tree.flatten(state)["modules.physics.counters.active_contacts"].min()) > 100

"""The particle arm of the port against the JAX package: the script front
end (same AST), and ParticleSystem.step over 10 frames from the same states
and the same threefry keys, on the flagship's `storm` script and on a
two-emitter script with cross-emits.

Tolerances: alive masks and the int counters exact; channels and outputs
within ATOL (XLA fuses some multiply-adds, torch rounds each op: a few ulps
of values up to ~50 m over 10 frames; observed 3.8e-6 on storm, 1.2e-7 on
the cross-emit script). A third script is a ribbon emitter."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu.models.demo_scenes import PARTICLE_STRESS_SCRIPT as REF_STORM
from lumixengine_tpu.renderer import particle_compiler as rpc
from lumixengine_tpu.renderer.particle_system import ParticleSystem as RefSystem
from lumixengine_tpu_torch.core import random as prng
from lumixengine_tpu_torch.models.demo_scenes import PARTICLE_STRESS_SCRIPT
from lumixengine_tpu_torch.renderer import particle_compiler as ppc
from lumixengine_tpu_torch.renderer.particle_system import EmitterState, ParticleSystem
from test_particle_editor import SIMPLE
from test_particles import MINI

torch.set_num_threads(1)

DT = np.float32(1.0 / 60.0)
FRAMES = 10
ATOL = 1e-4   # positions up to ~50 m: 1 ulp is 3.8e-6

# two emitters: rockets that, falling early in a half-second cycle, emit a
# spark each and die; sparks take the rocket's position and a noise-driven
# velocity. Exercises emit(target) { in_x = ...; in_v.x = ...; }, kill(),
# if/else, &&, %, noise, mix, frac, min/max, a user fn, a global, swizzled
# reads and writes, emit_index, entity_position and capacity overflow.
CROSS = """
const DRAG = 0.5;
global wind : float3
fn wobble(x, k) {
    let s = noise(x * k);
    result = mix(-1, 1, s);
}
emitter rocket {
    emit_per_second 90
    init_emit_count 6
    max_particles 48
    var pos : float3
    var vel : float3
    var age : float
    fn emit() {
        age = 0;
        pos = entity_position + {random(-1, 1), 0, random(-1, 1)};
        vel = {random(-2, 2), random(-1, 3), random(-2, 2)};
    }
    fn update() {
        age = age + time_delta;
        vel.y = vel.y - 9.8 * time_delta;
        vel.xz = vel.xz + wind.xz * time_delta;
        pos = pos + vel * time_delta;
        if vel.y < 0 && age % 0.5 < 0.25 {
            emit(spark) { in_pos = pos; in_vel.x = wobble(age + pos.x, 3.0); in_vel.yz = {2, 0}; };
            kill();
        } else {
            if pos.y < -1 { kill(); }
        }
    }
}
emitter spark {
    max_particles 4
    in in_pos : float3
    in in_vel : float3
    var pos : float3
    var vel : float3
    var life : float
    out o_pos : float3
    out o_fade : float
    fn emit() {
        pos = in_pos;
        vel = in_vel + {random(-1, 1), random(-1, 1), random(-1, 1)} * 0.5;
        life = 0.3 + frac(emit_index * 0.37) % 0.2;
    }
    fn update() {
        life = life - time_delta;
        vel = vel - vel * DRAG * time_delta;
        pos = pos + vel * time_delta;
        if !(life > 0) { kill(); }
    }
    fn output() {
        o_pos = pos;
        o_fade = max(min(life / 0.5, 1), 0);
    }
}
"""

# a ribbon emitter: 3 ribbons of 4 slots, 2 ribbons × 3 particles alive at
# the start (emitted when the state is made), short lives
RIBBON = """
emitter trail {
    max_ribbons 3
    max_ribbon_length 4
    init_ribbons_count 2
    init_emit_count 3
    emit_per_second 30
    var pos : float3
    var life : float
    out o_pos : float3
    fn emit() {
        pos = entity_position + {ribbon_index, emit_index * 0.5, random(0, 1)};
        life = 0.05 + emit_index * 0.02;
    }
    fn update() {
        life = life - time_delta;
        pos.y = pos.y + time_delta;
        if life < 0 { kill(); }
    }
    fn output() { o_pos = pos; }
}
"""


def ast_tree(node):
    """A parsed program as nested tuples of (class name, fields): the same
    for both packages when their parsers agree."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,
                tuple((f.name, ast_tree(getattr(node, f.name))) for f in dataclasses.fields(node)))
    if isinstance(node, dict):
        return tuple((k, ast_tree(v)) for k, v in node.items())
    if isinstance(node, (list, tuple)):
        return tuple(ast_tree(v) for v in node)
    return node


@pytest.mark.parametrize("name", ["storm", "MINI", "SIMPLE", "cross", "ribbon"])
def test_parser_gives_the_reference_ast(name):
    src = {"storm": PARTICLE_STRESS_SCRIPT % {"cap": 2048}, "MINI": MINI, "SIMPLE": SIMPLE,
           "cross": CROSS, "ribbon": RIBBON}[name]
    ref = ast_tree(rpc.Parser(src).parse_program())
    got = ast_tree(ppc.Parser(src).parse_program())
    assert got == ref
    assert len(ref) > 0


def test_the_flagship_script_is_the_reference_s():
    assert PARTICLE_STRESS_SCRIPT == REF_STORM


@pytest.mark.parametrize("src", ["emitter x { out broken }", "const x = ;",
                                 "emitter x { var v : float5 }", "import missing;"])
def test_compile_errors_match(src):
    with pytest.raises((rpc.CompileError, rpc.TokenizeError)):
        rpc.compile_source(src)
    with pytest.raises((ppc.CompileError, ppc.TokenizeError)):
        ppc.compile_source(src)


def _ref_states(rsys, worlds):
    st = rsys.device_state()
    if worlds:
        st = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (worlds,) + x.shape), st)
    return st


def _to_port(rstates):
    return {n: EmitterState(**{f.name: torch.tensor(np.asarray(getattr(s, f.name)))
                               for f in dataclasses.fields(EmitterState)})
            for n, s in rstates.items()}


def _run_both(src, worlds, system, warm=0, seed=0):
    """`warm` reference-only frames, then FRAMES frames in both packages from
    the same states and keys; yields (frame, reference states, port states)."""
    rsys, psys = RefSystem.from_source(src), ParticleSystem.from_source(src)
    sys_j = {k: jnp.asarray(v) for k, v in system.items()}

    def one(s, t, k, sysv):
        return rsys.step(s, DT, t, k, system=sysv)

    step = jax.jit(jax.vmap(one) if worlds else one)

    def rstep(s, t, k):
        return step(s, t, k, sys_j)

    base = jax.random.PRNGKey(seed)
    keys = np.stack([np.asarray(jax.random.fold_in(base, w)) for w in range(max(worlds, 1))])
    keys = keys if worlds else keys[0]
    rst = _ref_states(rsys, worlds)
    tshape = (worlds,) if worlds else ()

    def ref_frame(f):
        k = jax.vmap(lambda kk: jax.random.fold_in(kk, f))(keys) if worlds else \
            jax.random.fold_in(keys, f)
        return k, jnp.full(tshape, f * DT, jnp.float32)

    for f in range(warm):
        rst = rstep(rst, *ref_frame(f)[::-1])
    pst = _to_port(rst)
    psystem = {k: torch.tensor(v) for k, v in system.items()}
    for f in range(warm, warm + FRAMES):
        k, t = ref_frame(f)
        rst = rstep(rst, t, k)
        pkey = prng.fold_in(torch.tensor(keys), f)
        pst = psys.step(pst, torch.tensor(DT), torch.full(tshape, float(f * DT)), pkey,
                        system=psystem)
        yield f, rst, pst


def _compare(rst, pst, atol, errs):
    for name, r in rst.items():
        p = pst[name]
        for f in ("alive", "emitted", "killed", "overflow"):
            np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(r, f)),
                                          err_msg=f"{name}.{f}")
        for f in ("channels", "outs", "emit_acc"):
            a, b = getattr(p, f).numpy(), np.asarray(getattr(r, f))
            errs[f"{name}.{f}"] = max(errs.get(f"{name}.{f}", 0.0),
                                      float(np.abs(a - b).max(initial=0.0)))
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{name}.{f}")


@pytest.mark.parametrize("worlds", [0, 3])
def test_storm_ten_frames(worlds):
    """The flagship emitter from 118 frames in: the first particles reach
    the ground, so kills and refills happen in the compared frames."""
    src = PARTICLE_STRESS_SCRIPT % {"cap": 256}
    ep = np.zeros((worlds, 3) if worlds else (3,), np.float32)
    errs, killed = {}, []
    for f, rst, pst in _run_both(src, worlds, {"entity_position": ep}, warm=118):
        _compare(rst, pst, ATOL, errs)
        killed.append(int(pst["storm"].killed.sum()))
    print("storm", worlds, errs, "killed", killed)
    assert killed[-1] > killed[0]
    assert bool(pst["storm"].alive.all())


@pytest.mark.parametrize("worlds", [0, 4])
@pytest.mark.parametrize("script", ["cross", "ribbon"])
def test_script_ten_frames(script, worlds):
    src = {"cross": CROSS, "ribbon": RIBBON}[script]
    for (n, p), (rn, r) in zip(ParticleSystem.from_source(src).device_state("cpu").items(),
                               RefSystem.from_source(src).device_state().items()):
        assert n == rn
        for f in dataclasses.fields(EmitterState):
            np.testing.assert_array_equal(getattr(p, f.name).numpy(), np.asarray(getattr(r, f.name)))
    rng = np.random.default_rng(4)
    shape = (worlds, 3) if worlds else (3,)
    system = {"entity_position": rng.normal(size=shape).astype(np.float32),
              "wind": rng.normal(size=shape).astype(np.float32)}
    errs = {}
    for f, rst, pst in _run_both(src, worlds, system, seed=7):
        _compare(rst, pst, ATOL, errs)
    print(script, worlds, errs)
    if script == "cross":
        spark, rocket = pst["spark"], pst["rocket"]
        assert int(spark.emitted.sum()) > 0 and int(rocket.killed.sum()) > 0
        assert int(spark.overflow.sum()) > 0          # more requests than the 4 spark slots
        assert 0 < int(spark.alive.sum()) <= 4 * max(worlds, 1)
        assert not bool(rocket.alive.all())
    else:
        trail = pst["trail"]
        assert int(trail.killed.sum()) > 0 and int(trail.emitted.sum()) > 0


def test_zero_capacity_becomes_one_slot():
    ps = ParticleSystem.from_source(PARTICLE_STRESS_SCRIPT % {"cap": 0})
    ref = RefSystem.from_source(REF_STORM % {"cap": 0})
    assert ps.caps == ref.caps == {"storm": 1}
    st = ps.device_state("cpu")["storm"]
    assert st.channels.shape == (7, 1) and st.outs.shape == (8, 1)

"""The port's ScriptModule against the JAX package's on the CPU: the copied
Lua interpreter, the fast path's compile decisions, the compiled update()
groups frame by frame, the host interpreter fallback, the scripts' pending
writes on every world of a batch, the six flows of tests/test_lua_fastpath.py
through the port's Runner, and script_stress_world at W=3.

Tolerances: FAST_ATOL between the two fast paths (the same float32 formulas;
cos/sin/pow/exp differ by an ulp or two between XLA and torch, so 1e-6 is
expected, FAST_RTOL for values that grow), HOST_ATOL = 2e-4 between the fast
path and the host interpreter (which computes in Python floats), as in the
JAX test. The largest errors are printed (pytest -s)."""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lumixengine_tpu_torch import bridge
from test_lua_fastpath import BRANCH_LUA, HOST_ONLY_LUA, MOVE_LUA
from test_torch_bridge import ref_to_numpy
from test_torch_nav_gui_audio import _pkg, ref_stepper, replicate_ref

torch.set_num_threads(1)

FAST_ATOL = 1e-5
FAST_RTOL = 1e-5
HOST_ATOL = 2e-4
DT = 1.0 / 60.0


# -- the interpreter ----------------------------------------------------------------------------

CHUNKS = {
    "core_language": """
local t = {}
for i = 1, 5 do table.insert(t, i * 2) end
print(#t, t[1], t[5])
local s = 0
for _, v in ipairs(t) do s = s + v end
print(s)
local function fact(n) if n <= 1 then return 1 end return n * fact(n - 1) end
print(fact(6))
print("Score: " .. tostring(100))
local q = {x = 1, ["y"] = 2}
print(q.x + q.y)
local i = 0
while i < 3 do i = i + 1 end
repeat i = i - 1 until i == 0
print(i)
""",
    "closures_varargs_multret": """
local function counter()
  local n = 0
  return function() n = n + 1 return n end
end
local c = counter()
c() c()
print(c())
local function mr() return 1, 2, 3 end
local a, b, c2 = mr()
print(a + b + c2)
local function va(...) return select("#", ...) end
print(va(10, 20, 30))
local ok, err = pcall(function() error("boom") end)
print(ok, err)
""",
    "luau_extensions": """
local function f(x: number): number
  local acc = 0
  acc += x
  acc *= 2
  return acc
end
print(f(21))
local s : string = "typed"
print(s)
""",
    "coroutines": """
local co = coroutine.create(function(a)
  local x = coroutine.yield(a + 1)
  return x * 2
end)
print(select(2, coroutine.resume(co, 10)))
print(select(2, coroutine.resume(co, 5)))
print(coroutine.status(co))
""",
    "arithmetic": """
print(7 % 3, -7 % 3, 7 % -3, 7.5 % 2, -7.5 % 2)
print(7 // 2, -7 // 2, 7.5 // 2, 2 ^ 10, (-8) ^ (1 / 3))
print(math.fmod(7, 3), math.fmod(-7, 3), math.floor(-1.5), math.ceil(-1.5))
print(math.min(3, 1, 2), math.max(3, 1, 2), math.abs(-2), math.sqrt(16))
print(1 / 0, -1 / 0, math.huge, math.pi)
print(("ab"):rep(3), #"hello")
print(tostring(true), tonumber("0x10"), tonumber("12.5"))
""",
    "tables_and_strings": """
local t = {3, 1, 2}
table.sort(t)
print(table.concat(t, ","))
local m = setmetatable({}, {__index = function(_, k) return k .. "!" end})
print(m.hey)
print(string.upper("abc"), string.sub("hello", 2, 3))
local n = 0
for k, v in pairs({a = 1, b = 2}) do n = n + v end
print(n)
""",
    "move_lua": MOVE_LUA + "\nprint(t, #pos)\n",
    "branch_lua": "this = {}\n" + BRANCH_LUA + "\nupdate(0.3) update(0.3) print(t, dir, this.position[1])\n",
    "string_format": 'print(string.format("%.3f %d %s", 1.23456, 42, "x"))\n',
    "tostring_nil": "print(tostring(nil))\n",
    "runtime_error": "local t = nil\nprint(t.x)\n",
    "error_call": "error('custom failure')\n",
    "error_table_value": "local ok, e = pcall(error, {code = 7})\nprint(ok, type(e), e.code)\n"
                         "error({code = 7})\n",
    "arith_on_nil": "local a = 1 + nil\n",
    "call_nil": "undefined_fn(1)\n",
    "syntax_error": "local x = = 1\n",
    "unclosed_block": "function f()\n  return 1\n",
}


def run_chunk(package, src):
    """(printed lines, error type name and message or None) of one chunk."""
    lua = _pkg("script.lua")[package]
    it = lua.Interpreter()
    out = []
    it.print_fn = out.append
    try:
        it.run(src, "test")
        return out, None
    except Exception as ex:   # LuaError, LuaSyntaxError: compared by name and text
        return out, (type(ex).__name__, re.sub(r"0x[0-9a-f]+", "0x?", str(ex)))


@pytest.mark.parametrize("name", sorted(CHUNKS))
def test_interpreter_matches_reference(name):
    ref = run_chunk(0, CHUNKS[name])
    got = run_chunk(1, CHUNKS[name])
    assert got == ref
    if name in ("runtime_error", "error_call", "arith_on_nil", "call_nil", "syntax_error",
                "unclosed_block", "error_table_value"):
        assert got[1] is not None
    elif name not in ("string_format", "tostring_nil"):   # there the copy does what the reference does
        assert got[1] is None and got[0]


# -- compile decisions --------------------------------------------------------------------------

STATE = """
local t = 0.25
local v = {1, 2, 3}
local q = {0.5, -1.5}
local w4 = {1, 2, 3, 4}
local big = {1, 2, 3, 4, 5}
local one = {7}
local s = "text"
local function helper() return 1 end
function update(dt)
%s
end
"""
MATH1 = ("sin", "cos", "tan", "asin", "acos", "sqrt", "abs", "floor", "ceil", "exp", "log",
         "rad", "deg")
MATH2 = ("atan", "min", "max", "fmod", "pow")


def _corpus():
    bodies = {}
    for fn in MATH1:
        bodies[f"math.{fn}/1"] = f"t = math.{fn}(t * 0.5)"
        bodies[f"math.{fn}/0"] = f"t = math.{fn}()"
        bodies[f"math.{fn}/2"] = f"t = math.{fn}(t, 0.5)"
    for fn in MATH2:
        bodies[f"math.{fn}/2"] = f"t = math.{fn}(t, 0.7)"
        bodies[f"math.{fn}/1"] = f"t = math.{fn}(t)"
        bodies[f"math.{fn}/3"] = f"t = math.{fn}(t, 0.7, 0.2)"
    bodies.update({
        "math.pi and huge": "t = t + math.pi - math.huge * 0 + dt",
        "math.pi()": "t = math.pi()",
        "math.sin as value": "t = math.sin",
        "math.unknown": "t = math.clamp(t, 0, 1)",
        "mod": "t = t % 2 + (t - 3) % 2 + t % -2",
        "mod by zero": "t = t % 0",
        "mod negative": "t = (-t - 5) % 3",
        "floor div": "t = t // 0.3 + (-t) // 0.3",
        "floor div by zero": "t = (t - 0.25) // 0",
        "pow": "t = (t - 1) ^ 2 + t ^ 0 + 0 ^ 0",
        "pow negative base": "t = (-t) ^ 0.5",
        "unary minus": "t = -t + dt",
        "compound": "t += dt\nt *= 1.5\nt -= 0.1\nt /= 2",
        "if elseif else": "if t > 1 then t = 0 elseif t < -1 then t = 1 else t = t + dt end",
        "not": "if not (t > 1) then t = t + dt end",
        "and or": "if t > 0 and t < 1 or dt < 0 then t = t + dt end",
        "literal true": "if true then t = t + dt end",
        "literal false, divide by zero untaken": "if false then t = 1 / 0 else t = t + dt end",
        "not true": "if not true then t = 0 else t = t + dt end",
        "non-boolean if": "if t then t = 0 end",
        "non-boolean and": "local u = t and 1\nt = u",
        "equality": "if t == 0.25 then t = 0.5 end\nif t ~= 0.5 then t = 1 end",
        "table of 3": "v = {v[1] + dt, v[2] * 2, v[3]}",
        "table of 2": "q = {q[2], q[1]}",
        "table of 4": "w4[4] = w4[4] + dt",
        "table element": "v[2] = t",
        "table of 1": "v = {1}",
        "table of 5": "v = {1, 2, 3, 4, 5}",
        "keyed table": "v = {x = 1, y = 2}",
        "position": "this.position = {v[1], v[2], t}",
        "position read": "local p = this.position\nthis.position = {p[1] + dt, p[2], p[3] * 2}",
        "position of 2": "this.position = q",
        "position of 3 table var": "this.position = v",
        "global write": "g = t",
        "local declares a state name": "local t = 1",
        "local shadows state": "local t = t + 1",
        "local no value": "local u\nu = t * 2\nt = u",
        "local pair": "local a, b = t, 2\nt = a + b",
        "multi assign": "t, v[1] = v[1], t",
        "multi assign arity": "t, v[1] = v[1]",
        "while": "while t < 1 do t = t + 1 end",
        "numeric for": "for i = 1, 2 do t = t + i end",
        "call print": "print(t)",
        "engine write": "this.name = 'x'",
        "engine read": "t = this.rotation[1]",
        "final return": "t = t + dt\nreturn",
        "valued return": "return t",
        "early return": "if t > 1 then return end\nt = 0",
        "do block": "do local u = t t = u + 1 end",
        "state shape change": "t = v",
        "local shape change": "local u = 1\nu = v\nt = u[1]",
        "branch local": "if t > 1 then local u = 2 t = u end",
        "bool local": "local flag = t > 1\nif flag then t = 0 end",
        "bool merge": "local flag = t > 1\nif dt > 0 then flag = t < 0 end\nif flag then t = 0 end",
        "bool into state": "t = t == 1",
        "length": "t = #v",
        "concat": "t = 'a' .. 'b'",
        "nil": "t = nil",
        "big table state": "big[1] = t",
        "one table state": "one[1] = t",
        "string state": "t = t + #s",
        "function upvalue": "t = helper()",
        "index out of range": "t = v[4]",
        "index assign out of range": "v[5] = 1",
        "dt only": "this.position = {dt, dt, dt}",
    })
    sources = {k: STATE % b for k, b in bodies.items()}
    sources["two parameters"] = "local t = 0\nfunction update(dt, x) t = t + dt end\n"
    sources["update not a function"] = "update = 5\n"
    sources["no update"] = "local t = 0\n"
    sources["chunk error"] = "local t = 0\nfunction update(dt) t = t + dt end\nerror('x')\n"
    sources["no state"] = "function update(dt) this.position = {1, 2, 3} end\n"
    return sources


CORPUS = _corpus()


def _engine(package, n):
    app = _pkg("app")[package]
    kw = {} if package == 0 else {"device": "cpu"}
    return app.create_full_engine(model_instances=n + 8, **kw)


def corpus_worlds(sources, child=False):
    """Each package's world with one root entity per source (or, with
    `child`, each entity under an identity parent), scripts attached and
    started. Returns [(engine, world, {name: env})] for (reference, port)."""
    out = []
    for package in (0, 1):
        engine = _engine(package, 2 * len(sources))
        world = engine.create_world(capacity=2 * len(sources) + 8)
        sm = world.modules["script"]
        envs = {}
        for i, (name, src) in enumerate(sources.items()):
            e = world.create_entity(position=(0.5 * i, 1.0, -0.25 * i), name=name)
            if child:
                root = world.create_entity(position=(0.0, 0.0, 0.0))
                world.set_parent(e, root)
            envs[name] = sm.attach_lua_script(e, source=src)
        engine.start_game(world)
        out.append((engine, world, envs))
    return out


def test_compile_decisions_equal_the_reference_on_the_corpus():
    (_re, rw, renvs), (_pe, pw, penvs) = corpus_worlds(CORPUS)
    rfp, pfp = _pkg("script.lua_fastpath")
    decisions = {}
    for name in CORPUS:
        assert (renvs[name].error is None) == (penvs[name].error is None), name
        r = rfp.try_compile(renvs[name], rw)
        p = pfp.try_compile(penvs[name], pw)
        assert (p is None) == (r is None), (name, r is not None)
        if p is not None:
            assert p.layout == r.layout and p.nslots == r.nslots, name
            np.testing.assert_array_equal(p.init_rows[0], r.init_rows[0])
        decisions[name] = p is not None
    compiled = sorted(k for k, v in decisions.items() if v)
    print(f"{len(compiled)} of {len(decisions)} compile:", compiled)
    # the arity rule: exactly one arity per math function compiles
    for fn in MATH1:
        assert decisions[f"math.{fn}/1"] and not decisions[f"math.{fn}/0"] \
            and not decisions[f"math.{fn}/2"]
    for fn in MATH2:
        assert decisions[f"math.{fn}/2"] and not decisions[f"math.{fn}/1"] \
            and not decisions[f"math.{fn}/3"]
    for name in ("global write", "local shadows state", "while", "non-boolean if",
                 "table of 5", "position of 2", "bool merge", "valued return"):
        assert not decisions[name], name
    for name in ("mod by zero", "floor div by zero", "literal false, divide by zero untaken",
                 "if elseif else", "and or", "table of 4", "no state"):
        assert decisions[name], name


def test_child_entities_do_not_compile():
    srcs = {"mover": MOVE_LUA, "branch": BRANCH_LUA}
    (_re, rw, renvs), (_pe, pw, penvs) = corpus_worlds(srcs, child=True)
    rfp, pfp = _pkg("script.lua_fastpath")
    for name in srcs:
        assert rfp.try_compile(renvs[name], rw) is None
        assert pfp.try_compile(penvs[name], pw) is None


COMPILED = [k for k in CORPUS if k not in (
    "two parameters", "update not a function", "no update", "chunk error")]


def test_corpus_fast_path_matches_reference_frame_by_frame():
    """Every compiled corpus script in one world, 60 frames at W=3 in both
    packages: each group's rows and each entity's position."""
    pfp = _pkg("script.lua_fastpath")[1]
    (re_, rw, renvs), (pe, pw, penvs) = corpus_worlds(CORPUS)
    names = [k for k in CORPUS if pfp.try_compile(penvs[k], pw) is not None]
    rstep = ref_stepper(re_, rw, 3)
    pstep = pe.build_step(pw, "cpu")
    sm = pw.modules["script"]
    assert len(sm._fast_groups) == len(names) == len(rw.modules["script"]._fast_groups)
    r0 = rw.device_state()
    ref, got = ref_to_numpy(r0), bridge.state_to_numpy(pw.device_state("cpu"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rs = replicate_ref(r0, 3)
    ps = bridge.state_from_numpy(ref_to_numpy(rs), "cpu")
    worst = {}
    for _ in range(60):
        rs, ps = rstep(rs, jnp.float32(DT)), pstep(ps, DT)
        ref, got = ref_to_numpy(rs), bridge.state_to_numpy(ps)
        for k in [k for k in ref if k.startswith("modules.script.")] + ["local.pos", "world.pos"]:
            g, r = got[k], ref[k]
            fin = np.isfinite(r)
            np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
            np.testing.assert_array_equal(g[~fin], r[~fin], err_msg=k)
            np.testing.assert_allclose(g[fin], r[fin], atol=FAST_ATOL, rtol=FAST_RTOL, err_msg=k)
            if fin.any():
                err = np.abs(g[fin] - r[fin]) / np.maximum(1.0, np.abs(r[fin]))
                worst[k] = max(worst.get(k, 0.0), float(err.max()))
    print("fast path vs reference, largest error (relative above 1):",
          {k: v for k, v in worst.items() if v > 0})


# -- the Runner flows (tests/test_lua_fastpath.py) ---------------------------------------------

def make_runner(source, n_entities=1, package=1):
    app = _pkg("app")[package]
    engine = _engine(package, n_entities)
    world = engine.create_world(capacity=n_entities + 8)
    sm = world.modules["script"]
    ents = []
    for i in range(n_entities):
        e = world.create_entity(position=(float(i), 1.0, 0.0), name=f"mover{i}")
        env = sm.attach_lua_script(e, source=source)
        assert env.error is None
        ents.append(e)
    runner = app.Runner([], engine=engine)
    runner.use_world(world)
    runner.start()
    return runner, world, sm, ents


def _pos(runner, world, ents):
    return runner.state.world.pos[:, [world.slot(e) for e in ents]].numpy()


def test_move_lua_compiles_and_matches_interpreter():
    runner, world, sm, ents = make_runner(MOVE_LUA, n_entities=3)
    assert runner.device == torch.device("cpu")
    assert len(sm._fast_groups) == 1 and len(sm._fast_groups[0].entities) == 3
    runner.run(60)
    t = 60 * (1 / 60)
    pos = _pos(runner, world, ents)
    for i in range(3):
        np.testing.assert_allclose(pos[:, i], [float(i) + np.cos(t) * 3, 1.0, np.sin(t) * 3],
                                   atol=HOST_ATOL)


def _host_runner(source, package=1):
    """The same script forced onto the host interpreter: its entity has a
    parent (the fast path takes roots only)."""
    app = _pkg("app")[package]
    engine = _engine(package, 1)
    world = engine.create_world(capacity=8)
    root = world.create_entity(position=(0.0, 0.0, 0.0), name="root")
    e = world.create_entity(position=(0.0, 1.0, 0.0), name="mover")
    world.set_parent(e, root)
    world.modules["script"].attach_lua_script(e, source=source)
    runner = app.Runner([], engine=engine)
    runner.use_world(world)
    runner.start()
    assert not world.modules["script"]._fast_groups
    return runner, world, e


@pytest.mark.parametrize("name,source", [("move", MOVE_LUA), ("branch", BRANCH_LUA)])
def test_fastpath_matches_host_interpreter(name, source):
    """Frame by frame for 30 frames: the compiled script (a root mover at
    (0, 1, 0)) against the same script on the host interpreter (a mover at
    (0, 1, 0) under an identity parent)."""
    r1, w1, _sm, (e1,) = make_runner(source)
    r2, w2, e2 = _host_runner(source)
    err = 0.0
    for _ in range(30):
        r1.tick()
        r2.tick()
        a = r1.state.world.pos[:, w1.slot(e1)].numpy()
        b = r2.state.world.pos[:, w2.slot(e2)].numpy()
        err = max(err, float(np.abs(a - b).max()))
    print(f"{name}: fast path vs host interpreter, largest error {err:.3e}")
    assert err <= HOST_ATOL


def test_fastpath_matches_host_interpreter_bitwise_semantics():
    """tests/test_lua_fastpath.py's flow: the device run and the host run of
    MOVE_LUA from the same spot agree after 30 frames."""
    r1, w1, sm1, (e1,) = make_runner(MOVE_LUA)
    assert sm1._fast_groups
    r1.run(30)
    r2, w2, e2 = _host_runner(MOVE_LUA)
    r2.run(30)
    p_dev = r1.state.world.pos[:, w1.slot(e1)].numpy()
    p_host = r2.state.world.pos[:, w2.slot(e2)].numpy()
    # MOVE_LUA moves relative to the start: the runs start at (0,1,0) both
    np.testing.assert_allclose(p_dev, p_host, atol=HOST_ATOL)


def test_branchy_script_compiles_with_where_merges():
    runner, world, sm, (e,) = make_runner(BRANCH_LUA)
    assert sm._fast_groups
    xs = []
    for _ in range(120):
        runner.tick()
        xs.append(float(runner.state.world.pos[0, world.slot(e)]))
    assert all(-0.55 <= x <= 0.55 for x in xs)
    assert max(xs) > 0.45 and min(xs) < -0.45        # it really ping-pongs


def test_unsupported_script_falls_back_to_host():
    runner, world, sm, (e,) = make_runner(HOST_ONLY_LUA)
    assert not sm._fast_groups
    runner.run(2)
    assert world.names[e] == "renamed"


def test_state_writes_back_to_lua_scope():
    runner, world, sm, (e,) = make_runner(MOVE_LUA)
    runner.run(45)
    world.load_state(runner.state)
    fn = sm.lua_envs[e][0].env.get("update")
    np.testing.assert_allclose(fn.scope.lookup("t").vars["t"], 45 / 60, atol=1e-5)
    pos = fn.scope.lookup("pos").vars["pos"]
    assert [pos.get(i) for i in (1, 2, 3)] == [0.0, 1.0, 0.0]   # the table row, written back


def test_write_back_reads_world_zero_of_a_batch():
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    runner, world, sm, (e,) = make_runner(MOVE_LUA)
    state = replicate_state(runner.state, 3)
    rows = state.modules["script"]["fast"]["0"].clone()
    rows[1:] = 99.0
    rows[0, :, 0] = 0.5
    sm.load_state({**state.modules["script"], "fast": {"0": rows}})
    fn = sm.lua_envs[e][0].env.get("update")
    g = sm._fast_groups[0]
    t_col = next(o for n, o, s in g.layout if n == "t")
    assert fn.scope.lookup("t").vars["t"] == float(rows[0, 0, t_col])


def test_fastpath_runs_across_worlds():
    """The compiled phase on a world batch (the bench path)."""
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    runner, world, sm, ents = make_runner(MOVE_LUA, n_entities=2)
    step = runner.engine.build_step(world, "cpu")
    state = replicate_state(world.device_state("cpu"), 4)
    for _ in range(10):
        state = step(state, 1 / 60)
    t = 10 / 60
    pos = state.world.pos[:, :, [world.slot(e) for e in ents]].numpy()
    for wi in range(4):
        np.testing.assert_allclose(pos[wi, 0, 0], np.cos(t) * 3, atol=HOST_ATOL)


def test_fast0_group_without_state():
    src = "function update(dt) this.position = {1, 2, 3} end\n"
    runner, world, sm, ents = make_runner(src, n_entities=2)
    assert len(sm._fast_groups) == 1 and sm._fast_groups[0].nslots == 0
    ss = runner.state.modules["script"]
    assert ss["fast"] == {} and tuple(ss["fast0"]["0"].shape) == (2, 0)
    runner.run(2)
    np.testing.assert_array_equal(_pos(runner, world, ents), [[1, 1], [2, 2], [3, 3]])


# -- apply_pending on every world ---------------------------------------------------------------

PENDING_LUA = """
function update(dt)
    this.name = "host"
end
"""


def _pending_world(package):
    """A scene where host scripts queue every kind of device write: a
    transform, a body's force and a teleport, a GUI toggle, a navigation
    request and a sound."""
    engine = _engine(package, 8)
    asys = engine.system_manager.get_system("audio_system")
    au = _pkg("audio.module")[package]
    asys.add_clip(au.AudioClip.sine("hum", seconds=0.1))
    world = engine.create_world(capacity=24)
    mover = world.create_entity(position=(1.0, 2.0, 3.0), name="mover")
    body = world.create_entity(position=(0.0, 5.0, 0.0), name="body")
    world.create_component(body, "rigid_actor", motion=2, shape=0, radius=0.5, mass=2.0)
    ui = world.create_entity(name="ui")
    world.create_component(ui, "gui_rect")
    agent = world.create_entity(position=(2.0, 0.0, 2.0), name="agent")
    world.create_component(agent, "nav_agent", speed=3.0)
    lis = world.create_entity(name="listener")
    world.create_component(lis, "listener")
    snd = world.create_entity(position=(1.0, 0.0, 0.0), name="sound")
    world.create_component(snd, "ambient_sound", clip="hum", autoplay=False)
    for e in (mover, body, ui, agent, snd):
        world.modules["script"].attach_lua_script(e, source=PENDING_LUA)
    engine.start_game(world)
    world.modules["script"].prepare_statics()
    return engine, world, (mover, body, ui, agent, snd)


def _queue_writes(world, ents):
    mover, body, ui, agent, snd = ents
    sm = world.modules["script"]
    rt = sm.lua_runtime()
    rt.write_transform(mover, position=np.asarray([4.0, 5.0, 6.0], np.float32))
    rt.apply_force(body, np.asarray([2.0, 0.0, 0.0], np.float32), impulse=True)
    rt.apply_force(body, np.asarray([0.0, 0.0, 60.0], np.float32), impulse=False)
    rt.set_gui_enabled(ui, False)
    rt.navigate(agent, np.asarray([10.0, 0.0, 10.0], np.float32), 2.5, 0.5)
    rt.play_sound(snd, "hum")


def test_apply_pending_writes_every_world():
    """The same host edits through the reference's apply_pending (one
    world) and the port's (one world, and a batch of 3): equal fields, and
    the batch carries the edit in every world."""
    from lumixengine_tpu_torch.parallel.mesh import replicate_state

    (re_, rw, rents), (pe, pw, pents) = _pending_world(0), _pending_world(1)
    r0 = rw.device_state()
    before = ref_to_numpy(r0)      # copied now: jnp.asarray may alias the host stores
    before = {k: v.copy() for k, v in before.items()}
    p0 = bridge.state_from_numpy(before, "cpu")
    _queue_writes(rw, rents)
    _queue_writes(pw, pents)
    rs = rw.modules["script"].apply_pending(r0, DT)
    pb = replicate_state(p0, 3)
    ps = pw.modules["script"].apply_pending(p0, DT)
    _queue_writes(pw, pents)
    pbs = pw.modules["script"].apply_pending(pb, DT)
    ref, got, gotb = ref_to_numpy(rs), bridge.state_to_numpy(ps), bridge.state_to_numpy(pbs)
    changed = sorted(k for k in ref if not np.array_equal(ref[k], before[k]))
    assert {"local.pos", "modules.physics.vel", "modules.gui.enabled",
            "modules.navigation.speed", "modules.navigation.waypoints",
            "modules.audio.playing"} <= set(changed), changed
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)
        for w in range(3):
            np.testing.assert_allclose(gotb[k][w], ref[k], atol=1e-6, rtol=0,
                                       err_msg=f"{k} world {w}")


# -- script_stress_world -------------------------------------------------------------------------

def test_script_stress_world_matches_reference_at_w3():
    """bench.py --config scripts at test size: script_stress_world(8) in both
    packages, start_game and prepare_statics, equal device states, then 30
    frames of build_step(extra=cull_pass) at W=3, every field."""
    rds, pds = _pkg("models.demo_scenes")
    from test_torch_bridge import reference_step

    (re_, rw, _), (pe, pw, _) = rds.script_stress_world(8), pds.script_stress_world(8, device="cpu")
    for engine, world in ((re_, rw), (pe, pw)):
        engine.start_game(world)
        world.modules["script"].prepare_statics()
    groups = pw.modules["script"]._fast_groups
    assert len(groups) == 7 and sum(len(g.entities) for g in groups) == 8
    assert [g.entities for g in groups] == [g.entities for g in rw.modules["script"]._fast_groups]
    rstep = reference_step(re_, rw, batched=True)
    pstep = pe.build_step(pw, "cpu", extra=pw.modules["renderer"].cull_pass)
    r0 = rw.device_state()
    ref, got = ref_to_numpy(r0), bridge.state_to_numpy(pw.device_state("cpu"))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rs = replicate_ref(r0, 3)
    ps = bridge.state_from_numpy(ref_to_numpy(rs), "cpu")
    worst = {}
    for _ in range(30):
        rs, ps = rstep(rs, jnp.float32(DT)), pstep(ps, DT)
        ref, got = ref_to_numpy(rs), bridge.state_to_numpy(ps)
        for k, r in ref.items():
            if r.dtype.kind == "f":
                np.testing.assert_allclose(got[k], r, atol=FAST_ATOL, rtol=FAST_RTOL, err_msg=k)
                worst[k] = max(worst.get(k, 0.0), float(np.abs(got[k] - r).max()) if r.size else 0)
            else:
                np.testing.assert_array_equal(got[k], r, err_msg=k)
    print("script_stress_world W=3, largest error:", {k: v for k, v in worst.items() if v > 0})
    assert got["frame"].tolist() == [30, 30, 30]


# -- the engine's game hooks ---------------------------------------------------------------------

PY_SCRIPT = """
frames = 0
def start():
    this.position = (1.0, 2.0, 3.0)
def update(dt):
    global frames
    frames += 1
def stop():
    this.position = (0.0, 0.0, 0.0)
"""


def test_pause_next_frame_and_game_hooks_match_reference():
    """Engine.pause/next_frame in update_host's dt, start_game/stop_game
    reaching the modules (a Python inline script and a Lua script), and
    init_systems, in both packages."""
    out = []
    for package in (0, 1):
        engine = _engine(package, 4)
        engine.init_systems()
        world = engine.create_world(capacity=8)
        e = world.create_entity(name="py")
        env = world.create_component(e, "inline_script", source=PY_SCRIPT)
        lua = world.modules["script"].attach_lua_script(
            world.create_entity(name="lua"),
            source="started = 0\nfunction start() started = started + 1 end\n"
                   "function onDestroy() started = -1 end\n")
        dts = [engine.update_host(1 / 60)]
        engine.pause(True)
        dts.append(engine.update_host(1 / 60))
        engine.next_frame()
        dts.append(engine.update_host(1 / 60))
        dts.append(engine.update_host(1 / 60))
        engine.start_game(world)
        started = (engine.game_running, lua.env.get("started"),
                   world.get_global_transform(e)[0].tolist())
        world.modules["script"].update_host(1 / 60)
        engine.stop_game(world)
        out.append((dts, started, env.globals["frames"], engine.game_running,
                    lua.env.get("started"), world.get_global_transform(e)[0].tolist()))
    assert out[1] == out[0]
    assert out[1][0][1] == 0.0 and out[1][0][3] == 0.0 and out[1][0][2] > 0.0
    assert out[1][1] == (True, 1.0, [1.0, 2.0, 3.0])
    assert out[1][2:] == (1, False, -1.0, [0.0, 0.0, 0.0])

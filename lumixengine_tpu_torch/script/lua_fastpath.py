"""Restricted-Lua → torch fast path for per-frame ``update`` bodies
(counterpart of ``lumixengine_tpu/script/lua_fastpath.py``).

The Lua interpreter (script/lua/interp.py) is a host-serial tree-walker. Most
per-frame scripts are tiny numeric kinematics (the demo's move.lua:
``t += dt; this.position = {pos[1]+cos(t)*3, ...}``); those run inside the
frame step on the device instead, for every instance of a script and every
world of the batch at once.

The JAX package turns an ``update()`` body into a function on one instance's
scalars and vmaps it over instances and worlds. Here the same AST is
evaluated once per group of instances, on tensors of shape ``[..., NI]``
(leading world axis, instances): each Lua number is one such tensor and each
2-4 vector a tuple of them. Whatever the JAX package computes per instance is
computed here elementwise, with the same formulas in float32:
``a % b = a - floor(a / b) * b``, ``math.fmod(a, b) = a - trunc(a / b) * b``,
``a // b = floor(a / b)``, ``^`` is pow, and constants are float32.

SUPPORTED SUBSET (anything else keeps the host interpreter, per script —
``try_compile`` returns None), exactly the JAX package's:
  * chunk-local state: numbers and tables of 2..4 numbers (captured after
    ``start()`` ran; they become columns of a per-instance f32 row)
  * update(dt) bodies made of local declarations, assignments and compound
    assignments to state, locals and table elements (constant indices),
    ``this.position`` read and write (root entities only: the device writes
    LOCAL transforms), if/elseif/else on boolean conditions (both arms are
    evaluated and merged with ``torch.where``), arithmetic (+ - * / % // ^,
    unary -), not/and/or on booleans, and math.* (sin cos tan asin acos
    atan(y, x) sqrt abs floor ceil exp log min(a, b) max(a, b) fmod pow rad
    deg, pi huge), each at the one arity the JAX function accepts.
  * no loops, no engine API calls, no strings, no nil checks.

The compile check — ``jax.eval_shape`` in the JAX package — runs the body
once on zero tensors on the CPU.

Host/device ownership: once a script instance compiles, its ``update`` no
longer runs on the host; its chunk locals live in the device state
(``state.modules["script"]``) and are written back to the Lua scope by
``ScriptModule.load_state`` (``write_back``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


class Unsupported(Exception):
    pass


def _fmod(a, b):
    return a - torch.trunc(a / b) * b


# math.* name -> (torch function, the one arity the JAX function takes)
_MATH_FNS = {
    "sin": (torch.sin, 1), "cos": (torch.cos, 1), "tan": (torch.tan, 1),
    "asin": (torch.asin, 1), "acos": (torch.acos, 1), "atan": (torch.atan2, 2),
    "sqrt": (torch.sqrt, 1), "abs": (torch.abs, 1), "floor": (torch.floor, 1),
    "ceil": (torch.ceil, 1), "exp": (torch.exp, 1), "log": (torch.log, 1),
    "min": (torch.minimum, 2), "max": (torch.maximum, 2), "fmod": (_fmod, 2),
    "pow": (torch.pow, 2), "rad": (torch.deg2rad, 1), "deg": (torch.rad2deg, 1),
}
_MATH_CONSTS = {"pi": np.pi, "huge": np.inf}

_THIS = ("__this__",)
_MATH = ("__math__",)


class _Consts:
    """Constant tensors by (value, device), made once: a frame after the
    first copies nothing from the host."""

    def __init__(self):
        self._cache: Dict[tuple, torch.Tensor] = {}

    def get(self, value, device) -> torch.Tensor:
        dtype = torch.bool if isinstance(value, bool) else torch.float32
        key = (value, dtype, str(device))
        t = self._cache.get(key)
        if t is None:
            v = value if dtype == torch.bool else float(np.float32(value))
            t = self._cache[key] = torch.tensor(v, dtype=dtype, device=device)
        return t


@dataclass
class FastUpdate:
    """One compiled script source: the state layout and the group's run."""

    source_key: str
    layout: List[Tuple[str, int, int]]        # (name, offset, size)
    nslots: int
    fn: Callable             # (rows [..., NI, K], pos [..., 3, NI], dt) -> (rows', pos')
    entities: List[int] = field(default_factory=list)
    init_rows: List[np.ndarray] = field(default_factory=list)
    envs: List[object] = field(default_factory=list)
    slots: Optional[np.ndarray] = None
    _slot_index: Dict[str, torch.Tensor] = field(default_factory=dict)

    def slot_index(self, device) -> torch.Tensor:
        """The group's entity slots as an index tensor on `device` (cached)."""
        key = str(device)
        if key not in self._slot_index:
            self._slot_index[key] = torch.as_tensor(np.asarray(self.slots, np.int64),
                                                    device=device)
        return self._slot_index[key]


class _Ctx:
    """Evaluation environment: name → ('s', tensor) | ('v', tuple) | ('b', ...),
    the special position vector and the dt parameter."""

    def __init__(self, state_vals, pos, dt_name, dt, consts: _Consts, device):
        self.vars: Dict[str, tuple] = dict(state_vals)
        self.pos = pos                        # tuple of 3 tensors
        self.state_names = set(state_vals.keys())
        if dt_name:
            self.vars[dt_name] = ("s", dt)
        self.locals: set = set()
        self.consts = consts
        self.device = device

    def copy(self):
        c = _Ctx.__new__(_Ctx)
        c.vars = dict(self.vars)
        c.pos = self.pos
        c.state_names = self.state_names
        c.locals = set(self.locals)
        c.consts = self.consts
        c.device = self.device
        return c

    def const(self, value) -> torch.Tensor:
        return self.consts.get(value, self.device)

    def as_bool(self, b) -> torch.Tensor:
        """A boolean as a tensor: a literal true/false is a Python bool."""
        return self.const(b) if isinstance(b, bool) else b


def _scalar(v):
    if isinstance(v, tuple) and v and v[0] == "s":
        return v[1]
    raise Unsupported("expected a number")


def _eval(e, ctx: _Ctx):
    op = e[0]
    if op == "num":
        return ("s", ctx.const(e[1]))
    if op in ("true", "false"):
        return ("b", op == "true")
    if op == "name":
        n = e[1]
        if n == "this":
            return _THIS
        if n == "math":
            return _MATH
        if n in ctx.vars:
            return ctx.vars[n]
        raise Unsupported(f"unknown name {n!r}")
    if op == "paren":
        return _eval(e[1], ctx)
    if op == "index":
        obj = _eval(e[1], ctx)
        key = e[2]
        if obj is _THIS:
            if key[0] == "str" and key[1] == "position":
                return ("v", ctx.pos)
            raise Unsupported(f"this.{key!r}")
        if obj is _MATH:
            if key[0] == "str" and key[1] in _MATH_CONSTS:
                return ("s", ctx.const(_MATH_CONSTS[key[1]]))
            raise Unsupported("math value")
        if isinstance(obj, tuple) and obj[0] == "v" and key[0] == "num":
            i = int(key[1]) - 1
            if 0 <= i < len(obj[1]):
                return ("s", obj[1][i])
        raise Unsupported("index")
    if op == "call":
        callee = e[1]
        if callee[0] == "index" and _eval(callee[1], ctx) is _MATH \
                and callee[2][0] == "str" and callee[2][1] in _MATH_FNS:
            args = [_scalar(_eval(a, ctx)) for a in e[2]]
            fn, arity = _MATH_FNS[callee[2][1]]
            if len(args) != arity:
                raise Unsupported(f"math.{callee[2][1]} with {len(args)} arguments")
            return ("s", fn(*args))
        raise Unsupported("call")
    if op == "binop":
        kind = e[1]
        l, r = _eval(e[2], ctx), _eval(e[3], ctx)
        if kind in ("+", "-", "*", "/", "%", "^", "//"):
            a, b = _scalar(l), _scalar(r)
            if kind == "+":
                return ("s", a + b)
            if kind == "-":
                return ("s", a - b)
            if kind == "*":
                return ("s", a * b)
            if kind == "/":
                return ("s", a / b)
            if kind == "%":
                return ("s", a - torch.floor(a / b) * b)   # Lua floor-mod
            if kind == "//":
                return ("s", torch.floor(a / b))
            return ("s", torch.pow(a, b))
        if kind in ("<", ">", "<=", ">=", "==", "~="):
            a, b = _scalar(l), _scalar(r)
            return ("b", {"<": torch.lt, ">": torch.gt, "<=": torch.le, ">=": torch.ge,
                          "==": torch.eq, "~=": torch.ne}[kind](a, b))
        raise Unsupported(f"binop {kind}")
    if op == "unop":
        if e[1] == "-":
            return ("s", -_scalar(_eval(e[2], ctx)))
        if e[1] == "not":
            v = _eval(e[2], ctx)
            if v[0] == "b":
                return ("b", torch.logical_not(ctx.as_bool(v[1])))
        raise Unsupported("unop")
    if op in ("and", "or"):
        l, r = _eval(e[1], ctx), _eval(e[2], ctx)
        if l[0] == "b" and r[0] == "b":
            f = torch.logical_and if op == "and" else torch.logical_or
            return ("b", f(ctx.as_bool(l[1]), ctx.as_bool(r[1])))
        raise Unsupported("non-boolean and/or")
    if op == "table":
        items = e[1]
        if not (2 <= len(items) <= 4) or any(k is not None for k, _ in items):
            raise Unsupported("table shape")
        return ("v", tuple(_scalar(_eval(v, ctx)) for _, v in items))
    raise Unsupported(f"expr {op}")


def _assign(tgt, val, ctx: _Ctx):
    if tgt[0] == "name":
        n = tgt[1]
        if n in ("this", "math"):
            raise Unsupported("assign builtin")
        if n in ctx.vars:
            cur = ctx.vars[n]
            if cur[0] != val[0] or (cur[0] == "v" and len(cur[1]) != len(val[1])):
                # a scalar/vector change is allowed only for a fresh local
                if n not in ctx.locals:
                    raise Unsupported("state shape change")
            ctx.vars[n] = val
            return
        raise Unsupported(f"assign to unknown {n!r} (global write)")
    if tgt[0] == "index":
        base, key = tgt[1], tgt[2]
        if base[0] == "name" and base[1] == "this":
            if key[0] == "str" and key[1] == "position":
                if val[0] != "v" or len(val[1]) != 3:
                    raise Unsupported("position needs a 3-vector")
                ctx.pos = val[1]
                return
            raise Unsupported("this.* write")
        obj = _eval(base, ctx)
        if isinstance(obj, tuple) and obj[0] == "v" and key[0] == "num":
            i = int(key[1]) - 1
            if 0 <= i < len(obj[1]):
                nv = list(obj[1])
                nv[i] = _scalar(val)
                _assign(base, ("v", tuple(nv)), ctx)
                return
        raise Unsupported("index assign")
    raise Unsupported("assign target")


def _merge(cond, then_ctx: _Ctx, else_ctx: _Ctx, ctx: _Ctx):
    """Merge two branch contexts back into ctx with torch.where."""
    cond = ctx.as_bool(cond)
    names = set(then_ctx.vars) | set(else_ctx.vars)
    for n in names:
        tv = then_ctx.vars.get(n)
        ev = else_ctx.vars.get(n)
        if tv is None or ev is None:
            if n in ctx.vars:
                raise Unsupported("branch drops a variable")
            continue                          # branch-local: dies here
        if tv is ev:
            continue
        if tv[0] != ev[0]:
            raise Unsupported("branch type mismatch")
        if tv[0] == "s":
            ctx.vars[n] = ("s", torch.where(cond, tv[1], ev[1]))
        elif tv[0] == "v":
            if len(tv[1]) != len(ev[1]):
                raise Unsupported("branch vec size mismatch")
            ctx.vars[n] = ("v", tuple(torch.where(cond, a, b) for a, b in zip(tv[1], ev[1])))
        else:
            raise Unsupported("branch bool merge")
    if then_ctx.pos is not else_ctx.pos:
        ctx.pos = tuple(torch.where(cond, a, b) for a, b in zip(then_ctx.pos, else_ctx.pos))
    else:
        ctx.pos = then_ctx.pos


def _exec_block(stmts, ctx: _Ctx):
    for i, st in enumerate(stmts):
        op = st[0]
        if op == "local":
            _, names, exprs, _line = st
            vals = [_eval(e, ctx) for e in exprs]
            while len(vals) < len(names):
                vals.append(("s", ctx.const(0.0)))
            for n, v in zip(names, vals):
                if n in ctx.state_names:
                    raise Unsupported("local shadows state")
                ctx.vars[n] = v
                ctx.locals.add(n)
        elif op == "assign":
            _, targets, exprs, _line = st
            vals = [_eval(e, ctx) for e in exprs]
            if len(vals) != len(targets):
                raise Unsupported("multi-assign arity")
            for t, v in zip(targets, vals):
                _assign(t, v, ctx)
        elif op == "compound":
            _, tgt, kind, rhs, line = st
            _eval(tgt, ctx)
            v = _eval(("binop", kind, tgt, rhs, line), ctx)
            _assign(tgt, v, ctx)
        elif op == "if":
            _, arms, els, _line = st

            def run_arms(k, base):
                if k >= len(arms):
                    out = base.copy()
                    if els:
                        _exec_block(els, out)
                    return out
                cond_v = _eval(arms[k][0], base)
                if cond_v[0] != "b":
                    raise Unsupported("non-boolean if")
                then_ctx = base.copy()
                _exec_block(arms[k][1], then_ctx)
                else_ctx = run_arms(k + 1, base)
                merged = base.copy()
                _merge(cond_v[1], then_ctx, else_ctx, merged)
                return merged
            out = run_arms(0, ctx)
            ctx.vars = out.vars
            ctx.pos = out.pos
            ctx.locals = out.locals
        elif op == "return":
            if st[1] or i != len(stmts) - 1:
                raise Unsupported("early/valued return")
        elif op == "do":
            _exec_block(st[1], ctx)
        else:
            raise Unsupported(f"stmt {op}")


def _collect_names(node, out):
    if isinstance(node, tuple):
        if node and node[0] == "name" and len(node) >= 2 and isinstance(node[1], str):
            out.add(node[1])
        for x in node:
            _collect_names(x, out)
    elif isinstance(node, list):
        for x in node:
            _collect_names(x, out)


def try_compile(env, world) -> Optional[FastUpdate]:
    """Compile one LuaScriptEnv's update() if it fits the subset; None on
    any unsupported construct (the host interpreter keeps the script)."""
    from lumixengine_tpu_torch.script.lua.interp import LuaFunction, LuaTable

    try:
        fn = env.env.get("update")
    except Exception:
        return None
    if not isinstance(fn, LuaFunction) or len(fn.params) > 1 or env.error:
        return None
    e = env.entity
    try:
        if world.get_parent(e) >= 0:
            return None                    # this.position is global; the device
    except Exception:                      # writes local — roots only
        return None

    names: set = set()
    _collect_names(fn.body, names)
    dt_name = fn.params[0] if fn.params else None
    layout: List[Tuple[str, int, int]] = []
    init: List[float] = []
    off = 0
    for n in sorted(names):
        if n in ("this", "math") or n == dt_name:
            continue
        sc = fn.scope.lookup(n) if fn.scope else None
        if sc is None:
            continue                       # bound locally inside the body
        v = sc.vars[n]
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            layout.append((n, off, 1))
            init.append(float(v))
            off += 1
        elif isinstance(v, LuaTable):
            size = 0
            for x in (v.get(i) for i in range(1, 5)):
                if isinstance(x, (int, float)) and not isinstance(x, bool):
                    size += 1
                else:
                    break
            if size < 2 or v.get(size + 1) is not None:
                return None
            layout.append((n, off, size))
            init.extend(float(v.get(i)) for i in range(1, size + 1))
            off += size
        else:
            return None                    # functions/userdata upvalues
    nslots = off
    consts = _Consts()

    def run(rows, pos, dt):
        """rows [..., NI, K], pos [..., 3, NI], dt a 0-dim tensor."""
        vals = {}
        for n, o, s in layout:
            if s == 1:
                vals[n] = ("s", rows[..., o])
            else:
                vals[n] = ("v", tuple(rows[..., o + k] for k in range(s)))
        ctx = _Ctx(vals, tuple(pos[..., k, :] for k in range(3)), dt_name, dt, consts,
                   pos.device)
        _exec_block(fn.body, ctx)
        shape = pos.shape[:-2] + pos.shape[-1:]           # [..., NI]
        out = []
        for n, o, s in layout:
            v = ctx.vars[n]
            if v[0] == "s" and s == 1:
                out.append(torch.broadcast_to(v[1], shape))
            elif v[0] == "v" and len(v[1]) == s:
                out.extend(torch.broadcast_to(x, shape) for x in v[1])
            else:
                raise Unsupported("state shape changed across update")
        new_rows = (torch.stack(out, dim=-1).to(torch.float32) if out
                    else rows.new_zeros(shape + (0,)))
        new_pos = torch.stack([torch.broadcast_to(p, shape) for p in ctx.pos], dim=-2)
        return new_rows, new_pos.to(torch.float32)

    # run once on zeros on the CPU to hold the whole body to the subset
    try:
        run(torch.zeros((1, nslots), dtype=torch.float32), torch.zeros((3, 1), dtype=torch.float32),
            torch.tensor(1 / 60, dtype=torch.float32))
    except Exception:
        return None

    fu = FastUpdate(source_key=env.source, layout=layout, nslots=nslots, fn=run)
    fu.entities.append(e)
    fu.init_rows.append(np.asarray(init, np.float32))
    fu.envs.append(env)
    return fu


def write_back(env, layout, row: np.ndarray) -> None:
    """Device state row → the Lua chunk scope (save/editor reads)."""
    from lumixengine_tpu_torch.script.lua.interp import LuaTable

    fn = env.env.get("update")
    if fn is None or getattr(fn, "scope", None) is None:
        return
    for n, o, s in layout:
        sc = fn.scope.lookup(n)
        if sc is None:
            continue
        if s == 1:
            sc.vars[n] = float(row[o])
        else:
            t = sc.vars[n]
            if isinstance(t, LuaTable):
                for k in range(s):
                    t.set(k + 1, float(row[o + k]))

"""Lua/Luau tree-walking interpreter (clean-room, semantics per the public
Lua 5.1 manual; coroutines are real threads with handoff, so `coroutine.yield`
works at any call depth exactly like the reference's Luau VM).

≙ reference src/lua/lua_script_system.cpp: scripts run in per-instance
environment tables whose metatable `__index` falls back to the shared globals
(lua_script_system.cpp env creation; see bridge in script/lua_bridge.py).

Host interop protocol: any Python object with `lua_index(key)` /
`lua_set(key, value)` participates in indexing; Python callables are callable
from Lua (a returned Python tuple becomes a Lua multiple-return).
"""
from __future__ import annotations

import math as _pymath
import threading
import time as _pytime
from typing import Any, Callable, Dict, List, Optional

from lumixengine_tpu_torch.script.lua.parser import parse


class LuaError(Exception):
    def __init__(self, value, traceback_str: str = ""):
        super().__init__(str(value))
        self.value = value
        self.traceback_str = traceback_str


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, values: tuple):
        self.values = values


def _normkey(k):
    if isinstance(k, float) and k.is_integer():
        return int(k)
    if isinstance(k, bool):  # bool keys stay bools (rare)
        return k
    return k


class LuaTable:
    __slots__ = ("hash", "metatable")

    def __init__(self, items: Optional[dict] = None):
        self.hash: Dict[Any, Any] = {}
        self.metatable: Optional["LuaTable"] = None
        if items:
            for k, v in items.items():
                if v is not None:
                    self.hash[_normkey(k)] = v

    # raw access
    def get(self, k):
        return self.hash.get(_normkey(k))

    def set(self, k, v):
        k = _normkey(k)
        if k is None:
            raise LuaError("table index is nil")
        if v is None:
            self.hash.pop(k, None)
        else:
            self.hash[k] = v

    def length(self) -> int:
        n = 0
        while (n + 1) in self.hash:
            n += 1
        return n

    def __repr__(self):
        return f"table: 0x{id(self):012x}"


class LuaFunction:
    __slots__ = ("params", "is_vararg", "body", "scope", "interp", "name")

    def __init__(self, params, is_vararg, body, scope, interp, name="?"):
        self.params = params
        self.is_vararg = is_vararg
        self.body = body
        self.scope = scope
        self.interp = interp
        self.name = name

    def __call__(self, *args):  # callable from Python host code too
        return self.interp.call(self, list(args))

    def __repr__(self):
        return f"function: {self.name}"


class Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name: str) -> Optional["Scope"]:
        s = self
        while s is not None:
            if name in s.vars:
                return s
            s = s.parent
        return None


class LuaCoroutine:
    """Thread-backed coroutine: resume/yield hand off via two events —
    only one side ever runs at a time (Lua semantics on any core count)."""

    __slots__ = ("fn", "interp", "status", "_thread", "_to_co", "_to_main",
                 "_xfer", "_error")

    def __init__(self, fn, interp):
        self.fn = fn
        self.interp = interp
        self.status = "suspended"
        self._thread: Optional[threading.Thread] = None
        self._to_co = threading.Event()
        self._to_main = threading.Event()
        self._xfer: tuple = ()
        self._error = None

    def _body(self):
        self._to_co.wait()
        self._to_co.clear()
        try:
            args = self._xfer
            rets = self.interp.call_value(self.fn, list(args))
            self._xfer = tuple(rets)
        except LuaError as e:
            self._error = e
        except Exception as e:  # host error inside coroutine
            self._error = LuaError(str(e))
        self.status = "dead"
        self._to_main.set()

    def resume(self, args: List[Any]) -> tuple:
        if self.status == "dead":
            return (False, "cannot resume dead coroutine")
        if self.status == "running":
            return (False, "cannot resume non-suspended coroutine")
        if self._thread is None:
            self._thread = threading.Thread(target=self._body, daemon=True,
                                            name="lua-coroutine")
            self._thread.start()
        prev = self.interp.current_coroutine
        self.interp.current_coroutine = self
        self.status = "running"
        self._xfer = tuple(args)
        self._to_co.set()
        self._to_main.wait()
        self._to_main.clear()
        self.interp.current_coroutine = prev
        if self._error is not None:
            err, self._error = self._error, None
            return (False, err.value)
        if self.status != "dead":
            self.status = "suspended"
        return (True,) + self._xfer

    def yield_(self, args: List[Any]) -> tuple:
        self._xfer = tuple(args)
        self._to_main.set()
        self._to_co.wait()
        self._to_co.clear()
        return self._xfer

    def __repr__(self):
        return f"thread: 0x{id(self):012x}"


def lua_tostring(v) -> str:
    if v is None:
        return "nil"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, (int, float)):
        return num_str(v)
    if isinstance(v, str):
        return v
    return repr(v)


def num_str(v) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e16:
        return str(int(f))
    return f"{f:.14g}"


def truthy(v) -> bool:
    return v is not None and v is not False


class Interpreter:
    """One Lua universe (≙ one lua_State): shared globals `_G`, require cache,
    math.random stream. Many script environments share one interpreter."""

    def __init__(self, loader: Optional[Callable[[str], Optional[str]]] = None):
        import random as _pyrandom

        self.G = LuaTable()
        self.rng = _pyrandom.Random(0)
        self.loader = loader           # module path → source (require/inherit)
        self.module_cache: Dict[str, Any] = {}
        self.current_coroutine: Optional[LuaCoroutine] = None
        self.print_fn: Callable[[str], None] = lambda s: print(s)
        self._install_stdlib()

    # -- public API ---------------------------------------------------------------

    def compile(self, src: str, chunkname: str = "?", env: Optional[LuaTable] = None
                ) -> LuaFunction:
        ast = parse(src, chunkname)
        use_env = env if env is not None else self.G
        scope = Scope()
        scope.vars["_ENV"] = use_env
        return LuaFunction([], True, ast[1], scope, self, chunkname)

    def run(self, src: str, chunkname: str = "?", env: Optional[LuaTable] = None):
        return self.call(self.compile(src, chunkname, env), [])

    def new_env(self) -> LuaTable:
        """Script environment with `__index` fallback to the shared globals
        (≙ lua_script_system.cpp environment metatable)."""
        env = LuaTable()
        mt = LuaTable()
        mt.set("__index", self.G)
        env.metatable = mt
        return env

    # -- call ---------------------------------------------------------------------

    def call(self, fn: LuaFunction, args: List[Any]) -> tuple:
        scope = Scope(fn.scope)
        for i, p in enumerate(fn.params):
            scope.vars[p] = args[i] if i < len(args) else None
        if fn.is_vararg:
            scope.vars["..."] = tuple(args[len(fn.params):])
        try:
            self.exec_block(fn.body, scope)
        except _Return as r:
            return r.values
        return ()

    def call_value(self, f, args: List[Any]) -> tuple:
        if isinstance(f, LuaFunction):
            return self.call(f, args)
        if callable(f):
            out = f(*args)
            if isinstance(out, tuple):
                return out
            return () if out is None else (out,)
        if isinstance(f, LuaTable) and f.metatable is not None:
            call = f.metatable.get("__call")
            if call is not None:
                return self.call_value(call, [f] + args)
        raise LuaError(f"attempt to call a {self._typename(f)} value")

    # -- indexing -------------------------------------------------------------------

    def index(self, obj, key):
        if isinstance(obj, LuaTable):
            v = obj.get(key)
            if v is not None:
                return v
            if obj.metatable is not None:
                idx = obj.metatable.get("__index")
                if isinstance(idx, LuaTable):
                    return self.index(idx, key)
                if idx is not None:
                    r = self.call_value(idx, [obj, key])
                    return r[0] if r else None
            return None
        if obj is None:
            raise LuaError(f"attempt to index a nil value (key {lua_tostring(key)!r})")
        if isinstance(obj, str):
            strlib = self.G.get("string")
            return strlib.get(key) if strlib is not None else None
        if hasattr(obj, "lua_index"):
            return obj.lua_index(key)
        raise LuaError(f"attempt to index a {self._typename(obj)} value")

    def setindex(self, obj, key, value):
        if isinstance(obj, LuaTable):
            if obj.get(key) is None and obj.metatable is not None:
                ni = obj.metatable.get("__newindex")
                if isinstance(ni, LuaTable):
                    return self.setindex(ni, key, value)
                if ni is not None:
                    self.call_value(ni, [obj, key, value])
                    return
            obj.set(key, value)
            return
        if hasattr(obj, "lua_set"):
            obj.lua_set(key, value)
            return
        raise LuaError(f"attempt to index a {self._typename(obj)} value")

    @staticmethod
    def _typename(v) -> str:
        if v is None:
            return "nil"
        if isinstance(v, bool):
            return "boolean"
        if isinstance(v, (int, float)):
            return "number"
        if isinstance(v, str):
            return "string"
        if isinstance(v, LuaTable):
            return "table"
        if isinstance(v, (LuaFunction,)) or callable(v):
            return "function"
        if isinstance(v, LuaCoroutine):
            return "thread"
        return "userdata"

    # -- statements -------------------------------------------------------------------

    def exec_block(self, stmts: List[tuple], scope: Scope) -> None:
        for st in stmts:
            self.exec_stmt(st, scope)

    def exec_stmt(self, st: tuple, scope: Scope) -> None:
        op = st[0]
        if op == "local":
            _, names, exprs, _line = st
            vals = self.eval_list(exprs, scope, want=len(names))
            for n, v in zip(names, vals):
                scope.vars[n] = v
        elif op == "assign":
            _, targets, exprs, _line = st
            vals = self.eval_list(exprs, scope, want=len(targets))
            for tgt, v in zip(targets, vals):
                self.assign(tgt, v, scope)
        elif op == "compound":
            _, tgt, binop, rhs, line = st
            cur = self.eval(tgt, scope)
            v = self.binop(binop, cur, self.eval(rhs, scope), line)
            self.assign(tgt, v, scope)
        elif op == "call_stmt":
            self.eval_multi(st[1], scope)
        elif op == "if":
            _, arms, els, _line = st
            for cond, body in arms:
                if truthy(self.eval(cond, scope)):
                    self.exec_block(body, Scope(scope))
                    return
            if els:
                self.exec_block(els, Scope(scope))
        elif op == "while":
            _, cond, body, _line = st
            while truthy(self.eval(cond, scope)):
                try:
                    self.exec_block(body, Scope(scope))
                except _Break:
                    break
                except _Continue:
                    continue
        elif op == "repeat":
            _, body, cond, _line = st
            while True:
                inner = Scope(scope)
                try:
                    self.exec_block(body, inner)
                except _Break:
                    break
                except _Continue:
                    pass
                # until-cond sees the loop body's locals (Lua scoping rule)
                if truthy(self.eval(cond, inner)):
                    break
        elif op == "fornum":
            _, name, start_e, stop_e, step_e, body, line = st
            i = self._tonum(self.eval(start_e, scope), line)
            stop = self._tonum(self.eval(stop_e, scope), line)
            step = self._tonum(self.eval(step_e, scope), line) if step_e else 1.0
            if step == 0:
                raise LuaError(f"'for' step is zero (line {line})")
            while (i <= stop) if step > 0 else (i >= stop):
                inner = Scope(scope)
                inner.vars[name] = i
                try:
                    self.exec_block(body, inner)
                except _Break:
                    break
                except _Continue:
                    pass
                i += step
        elif op == "forin":
            _, names, exprs, body, _line = st
            vals = self.eval_list(exprs, scope, want=3)
            f, s, var = vals[0], vals[1], vals[2]
            while True:
                rets = self.call_value(f, [s, var])
                var = rets[0] if rets else None
                if var is None:
                    break
                inner = Scope(scope)
                for i, n in enumerate(names):
                    inner.vars[n] = rets[i] if i < len(rets) else None
                try:
                    self.exec_block(body, inner)
                except _Break:
                    break
                except _Continue:
                    continue
        elif op == "do":
            self.exec_block(st[1], Scope(scope))
        elif op == "return":
            raise _Return(tuple(self.eval_list(st[1], scope, want=-1)))
        elif op == "break":
            raise _Break()
        elif op == "continue":
            raise _Continue()
        elif op == "localfunc":
            _, name, fexpr, _line = st
            scope.vars[name] = None  # visible to itself (recursion)
            fn = self.eval(fexpr, scope)
            fn.name = name
            scope.vars[name] = fn
        else:
            raise LuaError(f"unknown statement {op}")

    def assign(self, tgt: tuple, v, scope: Scope) -> None:
        if tgt[0] == "name":
            name = tgt[1]
            s = scope.lookup(name)
            if s is not None:
                s.vars[name] = v
            else:
                env = scope.lookup("_ENV").vars["_ENV"]
                self.setindex(env, name, v)
        elif tgt[0] == "index":
            obj = self.eval(tgt[1], scope)
            key = self.eval(tgt[2], scope)
            self.setindex(obj, key, v)
        else:
            raise LuaError("cannot assign to this expression")

    # -- expressions ---------------------------------------------------------------------

    def eval_list(self, exprs: List[tuple], scope: Scope, want: int) -> List[Any]:
        """Evaluate an expression list; the LAST expression expands its
        multiple returns (Lua adjustment rule). want=-1 keeps everything."""
        vals: List[Any] = []
        for i, e in enumerate(exprs):
            if i == len(exprs) - 1:
                vals.extend(self.eval_multi(e, scope))
            else:
                vals.append(self.eval(e, scope))
        if want >= 0:
            while len(vals) < want:
                vals.append(None)
            del vals[want:]
        return vals

    def eval_multi(self, e: tuple, scope: Scope) -> tuple:
        op = e[0]
        if op == "call":
            fn = self.eval(e[1], scope)
            args = self.eval_list(e[2], scope, want=-1)
            return self.call_value(fn, args)
        if op == "method":
            obj = self.eval(e[1], scope)
            fn = self.index(obj, e[2])
            if fn is None:
                raise LuaError(f"attempt to call missing method {e[2]!r} "
                               f"(line {e[4]})")
            args = self.eval_list(e[3], scope, want=-1)
            return self.call_value(fn, [obj] + args)
        if op == "vararg":
            s = scope.lookup("...")
            return s.vars["..."] if s else ()
        v = self.eval(e, scope)
        return () if v is None else (v,)

    def eval(self, e: tuple, scope: Scope):
        op = e[0]
        if op == "num":
            return e[1]
        if op == "str":
            return e[1]
        if op == "nil":
            return None
        if op == "true":
            return True
        if op == "false":
            return False
        if op == "name":
            name = e[1]
            s = scope.lookup(name)
            if s is not None:
                return s.vars[name]
            env = scope.lookup("_ENV").vars["_ENV"]
            return self.index(env, name)
        if op == "index":
            return self.index(self.eval(e[1], scope), self.eval(e[2], scope))
        if op in ("call", "method", "vararg"):
            r = self.eval_multi(e, scope)
            return r[0] if r else None
        if op == "paren":
            return self.eval(e[1], scope)
        if op == "and":
            l = self.eval(e[1], scope)
            return self.eval(e[2], scope) if truthy(l) else l
        if op == "or":
            l = self.eval(e[1], scope)
            return l if truthy(l) else self.eval(e[2], scope)
        if op == "binop":
            return self.binop(e[1], self.eval(e[2], scope),
                              self.eval(e[3], scope), e[4])
        if op == "unop":
            return self.unop(e[1], self.eval(e[2], scope), e[3])
        if op == "func":
            return LuaFunction(e[1], e[2], e[3], scope, self)
        if op == "table":
            t = LuaTable()
            arr_i = 1
            items = e[1]
            for j, (k, vexpr) in enumerate(items):
                if k is None:
                    if j == len(items) - 1:
                        for v in self.eval_multi(vexpr, scope):
                            t.set(arr_i, v)
                            arr_i += 1
                    else:
                        t.set(arr_i, self.eval(vexpr, scope))
                        arr_i += 1
                else:
                    t.set(self.eval(k, scope), self.eval(vexpr, scope))
            return t
        raise LuaError(f"unknown expression {op}")

    @staticmethod
    def _tonum(v, line) -> float:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        if isinstance(v, str):
            try:
                return float(v)
            except ValueError:
                pass
        raise LuaError(f"arithmetic on a non-number (line {line})")

    def binop(self, op: str, l, r, line: int):
        if op == "..":
            if isinstance(l, (str, int, float)) and isinstance(r, (str, int, float)) \
                    and not isinstance(l, bool) and not isinstance(r, bool):
                return lua_tostring(l) + lua_tostring(r)
            raise LuaError(f"attempt to concatenate a {self._typename(l if not isinstance(l, (str, int, float)) else r)} value (line {line})")
        if op == "==":
            return self._eq(l, r)
        if op == "~=":
            return not self._eq(l, r)
        if op in ("<", "<=", ">", ">="):
            if isinstance(l, str) and isinstance(r, str):
                pass
            else:
                l = self._tonum(l, line)
                r = self._tonum(r, line)
            return {"<": l < r, "<=": l <= r, ">": l > r, ">=": l >= r}[op]
        a = self._tonum(l, line)
        b = self._tonum(r, line)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if b == 0:
                return _pymath.inf if a > 0 else (-_pymath.inf if a < 0 else _pymath.nan)
            return a / b
        if op == "%":
            if b == 0:
                return _pymath.nan
            return a - _pymath.floor(a / b) * b
        if op == "//":
            return _pymath.floor(a / b) if b != 0 else _pymath.inf
        if op == "^":
            return a ** b
        raise LuaError(f"unknown operator {op} (line {line})")

    @staticmethod
    def _eq(l, r) -> bool:
        if isinstance(l, bool) or isinstance(r, bool):
            return l is r
        if isinstance(l, (int, float)) and isinstance(r, (int, float)):
            return float(l) == float(r)
        if type(l) is str and type(r) is str:
            return l == r
        if l is None or r is None:
            return l is r
        if hasattr(l, "lua_eq"):
            return bool(l.lua_eq(r))
        if hasattr(r, "lua_eq"):
            return bool(r.lua_eq(l))
        return l is r

    def unop(self, op: str, v, line: int):
        if op == "-":
            return -self._tonum(v, line)
        if op == "not":
            return not truthy(v)
        if op == "#":
            if isinstance(v, str):
                return float(len(v))
            if isinstance(v, LuaTable):
                return float(v.length())
            if hasattr(v, "lua_len"):
                return float(v.lua_len())
            raise LuaError(f"attempt to get length of a {self._typename(v)} value (line {line})")
        raise LuaError(f"unknown unary {op}")

    # -- stdlib -------------------------------------------------------------------------

    def _install_stdlib(self) -> None:
        G = self.G
        G.set("_G", G)
        G.set("_VERSION", "Luau")

        def _print(*args):
            self.print_fn("\t".join(lua_tostring(a) for a in args))

        def _type(v=None):
            return self._typename(v)

        def _tonumber(v=None, base=None):
            if base is not None:
                try:
                    return float(int(str(v), int(base)))
                except (ValueError, TypeError):
                    return None
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return float(v)
            if isinstance(v, str):
                try:
                    s = v.strip()
                    if s.lower().startswith("0x"):
                        return float(int(s, 16))
                    return float(s)
                except ValueError:
                    return None
            return None

        def _ipairs(t):
            def it(tt, i):
                i = int(i) + 1
                v = self.index(tt, i)
                if v is None:
                    return None
                return (float(i), v)
            return (it, t, 0.0)

        def _pairs(t):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument to 'pairs' (table expected)")
            keys = list(t.hash.keys())
            pos = [0]

            def it(_tt, _var):
                while pos[0] < len(keys):
                    k = keys[pos[0]]
                    pos[0] += 1
                    if k in t.hash:
                        kk = float(k) if isinstance(k, int) and not isinstance(k, bool) else k
                        return (kk, t.hash[k])
                return None
            return (it, t, None)

        def _error(msg=None, _level=None):
            raise LuaError(msg if msg is not None else "nil")

        def _assert(v=None, msg=None, *rest):
            if not truthy(v):
                raise LuaError(msg if msg is not None else "assertion failed!")
            return (v, msg) + rest if msg is not None else v

        def _pcall(f=None, *args):
            try:
                return (True,) + self.call_value(f, list(args))
            except LuaError as e:
                return (False, e.value)
            except (_Break, _Return, _Continue):
                raise
            except Exception as e:
                return (False, str(e))

        def _select(what=None, *args):
            if what == "#":
                return float(len(args))
            i = int(what)
            return args[i - 1:]

        def _unpack(t, i=1.0, j=None):
            i = int(i)
            j = int(j) if j is not None else (t.length() if isinstance(t, LuaTable) else 0)
            return tuple(self.index(t, k) for k in range(i, j + 1))

        def _rawget(t, k):
            return t.get(k) if isinstance(t, LuaTable) else None

        def _rawset(t, k, v):
            t.set(k, v)
            return t

        def _rawequal(a=None, b=None):
            return a is b or (isinstance(a, (int, float, str)) and a == b)

        def _setmetatable(t, mt=None):
            t.metatable = mt
            return t

        def _getmetatable(t=None):
            return t.metatable if isinstance(t, LuaTable) else None

        def _require(path=None):
            return self.require(str(path))

        for name, fn in [
            ("print", _print), ("type", _type), ("tostring", lua_tostring),
            ("tonumber", _tonumber), ("ipairs", _ipairs), ("pairs", _pairs),
            ("error", _error), ("assert", _assert), ("pcall", _pcall),
            ("select", _select), ("unpack", _unpack), ("rawget", _rawget),
            ("rawset", _rawset), ("rawequal", _rawequal),
            ("setmetatable", _setmetatable), ("getmetatable", _getmetatable),
            ("require", _require),
        ]:
            G.set(name, fn)

        # math ------------------------------------------------------------------
        m = LuaTable()

        def _random(a=None, b=None):
            if a is None:
                return self.rng.random()
            if b is None:
                return float(self.rng.randint(1, int(a)))
            return float(self.rng.randint(int(a), int(b)))

        for name, fn in [
            ("sin", _pymath.sin), ("cos", _pymath.cos), ("tan", _pymath.tan),
            ("asin", _pymath.asin), ("acos", _pymath.acos),
            ("atan", _pymath.atan), ("atan2", _pymath.atan2),
            ("sqrt", _pymath.sqrt), ("exp", _pymath.exp),
            ("pow", lambda a, b: float(a) ** float(b)),
            ("log", lambda x, base=_pymath.e: _pymath.log(x, base)),
            ("abs", abs), ("floor", lambda x: float(_pymath.floor(x))),
            ("ceil", lambda x: float(_pymath.ceil(x))),
            ("fmod", _pymath.fmod),
            ("max", lambda *a: max(float(x) for x in a)),
            ("min", lambda *a: min(float(x) for x in a)),
            ("random", _random),
            ("randomseed", lambda s=0: self.rng.seed(int(s))),
            ("rad", _pymath.radians), ("deg", _pymath.degrees),
            ("clamp", lambda x, lo, hi: max(float(lo), min(float(hi), float(x)))),
            ("sign", lambda x: (x > 0) - (x < 0) and float((x > 0) - (x < 0))),
            ("modf", lambda x: (float(int(x)), x - int(x))),
        ]:
            m.set(name, fn)
        m.set("pi", _pymath.pi)
        m.set("huge", _pymath.inf)
        G.set("math", m)

        # string ----------------------------------------------------------------
        s = LuaTable()

        def _byte(st, i=1.0, j=None):
            i = int(i)
            j = int(j) if j is not None else i
            return tuple(float(ord(c)) for c in st[i - 1:j])

        def _sub(st, i, j=-1.0):
            i = int(i)
            j = int(j)
            n = len(st)
            if i < 0:
                i = max(n + i + 1, 1)
            elif i == 0:
                i = 1
            if j < 0:
                j = n + j + 1
            elif j > n:
                j = n
            return st[i - 1:j] if i <= j else ""

        def _format(fmt, *args):
            out = []
            ai = 0
            i = 0
            while i < len(fmt):
                c = fmt[i]
                if c != "%":
                    out.append(c)
                    i += 1
                    continue
                j = i + 1
                while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                    j += 1
                spec = fmt[i:j + 1]
                conv = fmt[j]
                a = args[ai] if ai < len(args) else None
                ai += 1
                if conv == "%":
                    out.append("%")
                    ai -= 1
                elif conv in "di":
                    out.append(spec[:-1] % int(a) + "")
                    out[-1] = (spec[:-1] + "d") % int(a)
                elif conv in "fFgGeE":
                    out.append(spec % float(a))
                elif conv == "s":
                    out.append(spec % lua_tostring(a))
                elif conv in "xX":
                    out.append(spec % int(a))
                else:
                    out.append(spec)
                i = j + 1
            return "".join(out)

        def _find_plain(st, pat, init=1.0, _plain=None):
            idx = st.find(pat, int(init) - 1)
            if idx < 0:
                return None
            return (float(idx + 1), float(idx + len(pat)))

        def _gsub_plain(st, pat, repl, n=None):
            cnt = st.count(pat) if n is None else min(st.count(pat), int(n))
            return (st.replace(pat, repl, cnt), float(cnt))

        for name, fn in [
            ("byte", _byte), ("char", lambda *a: "".join(chr(int(x)) for x in a)),
            ("len", lambda st: float(len(st))), ("sub", _sub),
            ("upper", lambda st: st.upper()), ("lower", lambda st: st.lower()),
            ("rep", lambda st, n: st * int(n)), ("format", _format),
            ("find", _find_plain), ("gsub", _gsub_plain),
            ("reverse", lambda st: st[::-1]),
        ]:
            s.set(name, fn)
        G.set("string", s)

        # table ------------------------------------------------------------------
        t = LuaTable()

        def _insert(tt, a, b=None):
            if b is None:
                tt.set(tt.length() + 1, a)
            else:
                pos = int(a)
                for k in range(tt.length(), pos - 1, -1):
                    tt.set(k + 1, tt.get(k))
                tt.set(pos, b)

        def _remove(tt, pos=None):
            n = tt.length()
            if n == 0:
                return None
            pos = n if pos is None else int(pos)
            v = tt.get(pos)
            for k in range(pos, n):
                tt.set(k, tt.get(k + 1))
            tt.set(n, None)
            return v

        def _concat(tt, sep="", i=1.0, j=None):
            j = int(j) if j is not None else tt.length()
            return str(sep).join(lua_tostring(tt.get(k)) for k in range(int(i), j + 1))

        def _sort(tt, comp=None):
            n = tt.length()
            items = [tt.get(k) for k in range(1, n + 1)]
            if comp is None:
                items.sort()
            else:
                import functools

                def cmp(a, b):
                    r = self.call_value(comp, [a, b])
                    if r and truthy(r[0]):
                        return -1
                    r2 = self.call_value(comp, [b, a])
                    return 1 if (r2 and truthy(r2[0])) else 0
                items.sort(key=functools.cmp_to_key(cmp))
            for k, v in enumerate(items):
                tt.set(k + 1, v)

        for name, fn in [("insert", _insert), ("remove", _remove),
                         ("concat", _concat), ("sort", _sort),
                         ("getn", lambda tt: float(tt.length())),
                         ("clear", lambda tt: tt.hash.clear())]:
            t.set(name, fn)
        G.set("table", t)

        # os / debug -------------------------------------------------------------
        o = LuaTable()
        o.set("time", lambda: float(int(_pytime.time())))
        o.set("clock", lambda: float(_pytime.process_time()))
        G.set("os", o)
        d = LuaTable()
        d.set("traceback", lambda msg=None, _lvl=None: lua_tostring(msg) if msg else "stack traceback:")
        G.set("debug", d)

        # coroutine ---------------------------------------------------------------
        co = LuaTable()

        def _co_create(f=None):
            return LuaCoroutine(f, self)

        def _co_resume(c=None, *args):
            if not isinstance(c, LuaCoroutine):
                raise LuaError("cannot resume non-coroutine")
            return c.resume(list(args))

        def _co_yield(*args):
            c = self.current_coroutine
            if c is None:
                raise LuaError("attempt to yield from outside a coroutine")
            return c.yield_(list(args))

        def _co_status(c=None):
            return c.status if isinstance(c, LuaCoroutine) else "dead"

        def _co_wrap(f=None):
            c = LuaCoroutine(f, self)

            def wrapped(*args):
                r = c.resume(list(args))
                if not r[0]:
                    raise LuaError(r[1])
                return r[1:]
            return wrapped

        for name, fn in [("create", _co_create), ("resume", _co_resume),
                         ("yield", _co_yield), ("status", _co_status),
                         ("wrap", _co_wrap),
                         ("isyieldable", lambda: self.current_coroutine is not None),
                         ("running", lambda: self.current_coroutine)]:
            co.set(name, fn)
        G.set("coroutine", co)

    # -- modules ---------------------------------------------------------------------

    def require(self, path: str):
        """≙ Luau require: load `<path>.lua` via the host loader; cache by path;
        module chunk runs with the SHARED global env (so `td = ...` writes _G)."""
        if path in self.module_cache:
            return self.module_cache[path]
        if self.loader is None:
            raise LuaError(f"module '{path}' not found (no loader)")
        src = self.loader(path)
        if src is None:
            raise LuaError(f"module '{path}' not found")
        fn = self.compile(src, chunkname=path, env=self.G)
        rets = self.call(fn, [])
        mod = rets[0] if rets else True
        self.module_cache[path] = mod
        return mod

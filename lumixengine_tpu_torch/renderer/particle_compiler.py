"""Particle script compiler (counterpart of
``lumixengine_tpu/renderer/particle_compiler.py``).

The front end is the reference's: tokenizer → AST → constant folding, with
imports of ``.pai`` libraries. The back end lowers an emitter's programs to
eager torch over SoA channel tensors ``[..., cap]`` (a leading world batch
where the state has one): every instruction is one tensor op, branches
become masked selects, ``kill()`` accumulates a mask and ``emit()`` records
cross-emitter requests. ``random(a, b)`` draws from the reference's
threefry stream (``core/random.py``): the n-th draw of an invocation uses
``fold_in(key, n)``, so the same key gives the same numbers in both
packages.

Language surface:
  const NAME = expr;             import "path";        global name : type;
  fn name(a, b) { let x = ...; result = expr; }       (user fns, inlined)
  emitter name {
      material "path"            init_emit_count N    emit_per_second N
      max_particles N            model "path"         mesh "path"
      max_ribbons N  max_ribbon_length N  init_ribbons_count N
      emit_move_distance N
      out ch : float|float3|float4     var ch : ...    in ch : ...
      fn emit() {...}   fn update() {...}   fn output() {...}
  }
  statements: x = e;  x.yz = e;  let v [: type] [= e];  return e;
              if e { ... } [else { ... }]     kill();
              emit(other) { in_x = e; ... };
  exprs: + - * / %  < > <= >= == !=  && || !  unary-  swizzles .xyzw/.rgba
         {a, b, c[, d]} vector literal
         random(a,b) sin cos sqrt min max mix noise frac floor user_fns
  system values: time_delta, total_time; externs: globals,
  entity_position, emit_index, ribbon_index
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from lumixengine_tpu_torch.core import profiler
from lumixengine_tpu_torch.core import random as prng
from lumixengine_tpu_torch.core.tokenizer import (  # noqa: F401 (TokenizeError: re-exported)
    IDENT, NUMBER, SYMBOL, TokenStream, TokenizeError, tokenize,
)

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Num:
    value: float


@dataclass
class Ref:
    name: str


@dataclass
class Swizzle:
    base: object
    comps: str  # e.g. "x", "rgb"


@dataclass
class BinOp:
    op: str
    a: object
    b: object


@dataclass
class Unary:
    op: str
    a: object


@dataclass
class Call:
    name: str
    args: List[object]


@dataclass
class VecLit:
    items: List[object]


@dataclass
class Assign:
    name: str
    comps: Optional[str]
    expr: object


@dataclass
class Let:
    name: str
    type: Optional[str]
    expr: Optional[object]


@dataclass
class If:
    cond: object
    then: List[object]
    orelse: List[object]


@dataclass
class Kill:
    pass


@dataclass
class EmitStmt:
    target: str
    assigns: List[Assign]


@dataclass
class FnDecl:
    name: str
    params: List[str]
    body: List[object]


@dataclass
class EmitterDecl:
    name: str
    material: str = ""
    model: str = ""
    init_emit_count: int = 0
    # script default is 0 (≙ particle_script_compiler.h m_emit_per_second = 0;
    # the runtime Header's 100 applies only to programmatic construction)
    emit_per_second: float = 0.0
    max_particles: int = 1024
    emit_move_distance: float = -1.0
    # ribbons (≙ particle_system ribbon strips): capacity defaults to
    # max_ribbons * max_ribbon_length; slots are ribbon-major
    max_ribbons: int = 0
    max_ribbon_length: int = 0
    init_ribbons_count: int = 0
    # instanced-mesh particles (≙ MESH: each particle renders this model)
    mesh: str = ""
    outs: List[Tuple[str, str]] = field(default_factory=list)
    vars: List[Tuple[str, str]] = field(default_factory=list)
    ins: List[Tuple[str, str]] = field(default_factory=list)
    fns: Dict[str, FnDecl] = field(default_factory=dict)


@dataclass
class Program:
    consts: Dict[str, float] = field(default_factory=dict)
    functions: Dict[str, FnDecl] = field(default_factory=dict)
    emitters: Dict[str, EmitterDecl] = field(default_factory=dict)
    imports: List[str] = field(default_factory=list)
    # `global name : type` — external per-frame inputs set by the game
    # (≙ DataStream::GLOBAL operands driven from Lua)
    globals: Dict[str, int] = field(default_factory=dict)


class CompileError(ValueError):
    pass


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

_TYPE_WIDTH = {"float": 1, "float3": 3, "float4": 4}


class Parser:
    def __init__(self, src: str):
        self.ts = TokenStream(tokenize(src))

    # --- expressions, precedence climbing
    def parse_expr(self):
        return self._or()

    def _or(self):
        e = self._and()
        while self.ts.at_symbol("||"):
            self.ts.next()
            e = BinOp("||", e, self._and())
        return e

    def _and(self):
        e = self._cmp()
        while self.ts.at_symbol("&&"):
            self.ts.next()
            e = BinOp("&&", e, self._cmp())
        return e

    def _cmp(self):
        e = self._add()
        while any(self.ts.at_symbol(s) for s in ("<", ">", "<=", ">=", "==", "!=")):
            op = self.ts.next().value
            e = BinOp(op, e, self._add())
        return e

    def _add(self):
        e = self._mul()
        while self.ts.at_symbol("+") or self.ts.at_symbol("-"):
            op = self.ts.next().value
            e = BinOp(op, e, self._mul())
        return e

    def _mul(self):
        e = self._unary()
        while self.ts.at_symbol("*") or self.ts.at_symbol("/") or self.ts.at_symbol("%"):
            op = self.ts.next().value
            e = BinOp(op, e, self._unary())
        return e

    def _unary(self):
        if self.ts.at_symbol("-"):
            self.ts.next()
            return Unary("-", self._unary())
        if self.ts.at_symbol("!"):
            self.ts.next()
            return Unary("!", self._unary())
        return self._postfix()

    def _postfix(self):
        e = self._primary()
        while self.ts.at_symbol("."):
            self.ts.next()
            comps = self.ts.expect_ident().value
            e = Swizzle(e, comps)
        return e

    def _primary(self):
        t = self.ts.peek()
        if t.kind == NUMBER:
            self.ts.next()
            return Num(float(t.value))
        if t.kind == IDENT:
            self.ts.next()
            if self.ts.at_symbol("("):
                self.ts.next()
                args = []
                if not self.ts.at_symbol(")"):
                    args.append(self.parse_expr())
                    while self.ts.accept_symbol(","):
                        args.append(self.parse_expr())
                self.ts.expect_symbol(")")
                return Call(t.value, args)
            return Ref(t.value)
        if self.ts.accept_symbol("("):
            e = self.parse_expr()
            self.ts.expect_symbol(")")
            return e
        if self.ts.accept_symbol("{"):
            items = [self.parse_expr()]
            while self.ts.accept_symbol(","):
                items.append(self.parse_expr())
            self.ts.expect_symbol("}")
            return VecLit(items)
        raise CompileError(f"unexpected token {t.value!r} at {t.line}:{t.col}")

    # --- statements
    def parse_block(self) -> List[object]:
        self.ts.expect_symbol("{")
        stmts = []
        while not self.ts.accept_symbol("}"):
            stmts.append(self.parse_stmt())
        return stmts

    def parse_stmt(self):
        if self.ts.at_ident("let"):
            self.ts.next()
            name = self.ts.expect_ident().value
            typ = None
            expr = None
            if self.ts.accept_symbol(":"):
                typ = self.ts.expect_ident().value
            if self.ts.accept_symbol("="):
                expr = self.parse_expr()
            self.ts.expect_symbol(";")
            return Let(name, typ, expr)
        if self.ts.at_ident("if"):
            self.ts.next()
            cond = self.parse_expr()
            then = self.parse_block()
            orelse = []
            if self.ts.at_ident("else"):
                self.ts.next()
                orelse = self.parse_block()
            return If(cond, then, orelse)
        if self.ts.at_ident("return"):
            # `return expr;` in user fns — sugar for `result = expr;`
            self.ts.next()
            expr = self.parse_expr()
            self.ts.expect_symbol(";")
            return Assign("result", None, expr)
        if self.ts.at_ident("kill"):
            self.ts.next()
            self.ts.expect_symbol("(")
            self.ts.expect_symbol(")")
            self.ts.expect_symbol(";")
            return Kill()
        if self.ts.at_ident("emit") and self.ts.peek(1).kind == SYMBOL and self.ts.peek(1).value == "(":
            self.ts.next()
            self.ts.expect_symbol("(")
            target = self.ts.expect_ident().value
            self.ts.expect_symbol(")")
            assigns = []
            self.ts.expect_symbol("{")
            while not self.ts.accept_symbol("}"):
                assigns.append(self._parse_assign())
            self.ts.expect_symbol(";")
            return EmitStmt(target, assigns)
        return self._parse_assign()

    def _parse_assign(self):
        name = self.ts.expect_ident().value
        comps = None
        if self.ts.accept_symbol("."):
            comps = self.ts.expect_ident().value
        self.ts.expect_symbol("=")
        expr = self.parse_expr()
        self.ts.expect_symbol(";")
        return Assign(name, comps, expr)

    # --- top level
    def parse_program(self) -> Program:
        prog = Program()
        while not self.ts.done():
            if self.ts.at_ident("const"):
                self.ts.next()
                name = self.ts.expect_ident().value
                self.ts.expect_symbol("=")
                expr = self.parse_expr()
                self.ts.expect_symbol(";")
                prog.consts[name] = _const_eval(expr, prog.consts)
            elif self.ts.at_ident("import"):
                self.ts.next()
                prog.imports.append(self.ts.expect_string())
            elif self.ts.at_ident("fn"):
                fn = self._parse_fn()
                prog.functions[fn.name] = fn
            elif self.ts.at_ident("global"):
                self.ts.next()
                name = self.ts.expect_ident().value
                self.ts.expect_symbol(":")
                typ = self.ts.expect_ident().value
                if typ not in _TYPE_WIDTH:
                    raise CompileError(f"unknown global type {typ!r}")
                prog.globals[name] = _TYPE_WIDTH[typ]
            elif self.ts.at_ident("emitter"):
                em = self._parse_emitter()
                prog.emitters[em.name] = em
            else:
                t = self.ts.peek()
                raise CompileError(f"unexpected {t.value!r} at top level ({t.line}:{t.col})")
        return prog

    def _parse_fn(self) -> FnDecl:
        self.ts.expect_ident("fn")
        name = self.ts.expect_ident().value
        self.ts.expect_symbol("(")
        params = []
        if not self.ts.at_symbol(")"):
            params.append(self.ts.expect_ident().value)
            while self.ts.accept_symbol(","):
                params.append(self.ts.expect_ident().value)
        self.ts.expect_symbol(")")
        body = self.parse_block()
        return FnDecl(name, params, body)

    def _parse_emitter(self) -> EmitterDecl:
        self.ts.expect_ident("emitter")
        em = EmitterDecl(name=self.ts.expect_ident().value)
        self.ts.expect_symbol("{")
        while not self.ts.accept_symbol("}"):
            t = self.ts.peek()
            if self.ts.at_ident("material"):
                self.ts.next()
                em.material = self.ts.expect_string()
            elif self.ts.at_ident("model"):
                self.ts.next()
                em.model = self.ts.expect_string()
            elif self.ts.at_ident("init_emit_count"):
                self.ts.next()
                em.init_emit_count = int(self.ts.expect_number())
            elif self.ts.at_ident("emit_per_second"):
                self.ts.next()
                em.emit_per_second = float(self.ts.expect_number())
            elif self.ts.at_ident("max_particles"):
                self.ts.next()
                em.max_particles = int(self.ts.expect_number())
            elif self.ts.at_ident("emit_move_distance"):
                self.ts.next()
                em.emit_move_distance = float(self.ts.expect_number())
            elif self.ts.at_ident("max_ribbons"):
                self.ts.next()
                em.max_ribbons = int(self.ts.expect_number())
            elif self.ts.at_ident("max_ribbon_length"):
                self.ts.next()
                em.max_ribbon_length = int(self.ts.expect_number())
            elif self.ts.at_ident("init_ribbons_count"):
                self.ts.next()
                em.init_ribbons_count = int(self.ts.expect_number())
            elif self.ts.at_ident("mesh"):
                self.ts.next()
                em.mesh = self.ts.expect_string()
            elif self.ts.at_ident("out") or self.ts.at_ident("var") or self.ts.at_ident("in"):
                kind = self.ts.next().value
                name = self.ts.expect_ident().value
                self.ts.expect_symbol(":")
                typ = self.ts.expect_ident().value
                if typ not in _TYPE_WIDTH:
                    raise CompileError(f"unknown type {typ!r}")
                {"out": em.outs, "var": em.vars, "in": em.ins}[kind].append((name, typ))
            elif self.ts.at_ident("fn"):
                fn = self._parse_fn()
                em.fns[fn.name] = fn
            else:
                raise CompileError(f"unexpected {t.value!r} in emitter ({t.line}:{t.col})")
        return em


def _const_eval(expr, consts: Dict[str, float]) -> float:
    """Host-side constant folding (≙ reference compiler const fold pass)."""
    if isinstance(expr, Num):
        return expr.value
    if isinstance(expr, Ref):
        if expr.name in consts:
            return consts[expr.name]
        raise CompileError(f"not a constant: {expr.name}")
    if isinstance(expr, Unary) and expr.op == "-":
        return -_const_eval(expr.a, consts)
    if isinstance(expr, BinOp):
        a = _const_eval(expr.a, consts)
        b = _const_eval(expr.b, consts)
        return {
            "+": a + b, "-": a - b, "*": a * b, "/": a / b, "%": a % b,
        }[expr.op]
    raise CompileError("constant expression expected")



# ---------------------------------------------------------------------------
# lowering to torch
# ---------------------------------------------------------------------------

_SWIZZLE_IDX = {"x": 0, "y": 1, "z": 2, "w": 3, "r": 0, "g": 1, "b": 2, "a": 3}


class Vec:
    """Value = tuple of component tensors (width 1, 3 or 4), each
    broadcastable to the invocation's shape [..., cap]."""

    def __init__(self, comps: Sequence):
        self.comps = tuple(comps)

    @property
    def width(self):
        return len(self.comps)

    def broadcast_to(self, w: int) -> "Vec":
        if self.width == w:
            return self
        if self.width == 1:
            return Vec([self.comps[0]] * w)
        raise CompileError(f"cannot broadcast width {self.width} to {w}")


def _zip_op(f, a: Vec, b: Vec) -> Vec:
    w = max(a.width, b.width)
    a = a.broadcast_to(w)
    b = b.broadcast_to(w)
    return Vec([f(x, y) for x, y in zip(a.comps, b.comps)])


class EmitRequest:
    def __init__(self, target: str, mask, ins: Dict[str, Vec]):
        self.target = target
        self.mask = mask
        self.ins = ins


class _ExecCtx:
    """Per-invocation lowering context: the shape [..., cap] of every value,
    the RNG stream, the branch masks and the side effects."""

    def __init__(self, shape, dt, time, key, consts, functions,
                 extern: Optional[Dict[str, "Vec"]] = None):
        self.shape = tuple(shape)
        self.cap = self.shape[-1]
        self.key = key
        self.device = key.device
        self.dt = self.scalar(dt)
        self.time = self.scalar(time)
        self._rand_counter = 0
        self.consts = consts
        self.functions = functions
        # external named values: globals, entity_position, emit_index,
        # ribbon_index — resolved by Ref lookup after consts
        self.extern = extern or {}
        self.mask_stack = [None]  # None = all active
        self.kill_mask = torch.zeros(self.shape, dtype=torch.bool, device=self.device)
        self.emits: List[EmitRequest] = []

    def scalar(self, v) -> torch.Tensor:
        """A float32 tensor from a Python number or a tensor (0-d, or one
        value per world)."""
        if isinstance(v, torch.Tensor):
            return v.to(device=self.device, dtype=torch.float32)
        return torch.full((), float(v), dtype=torch.float32, device=self.device)

    def full(self, v) -> torch.Tensor:
        """`v` (per-world values [...] or a number) at every slot."""
        t = self.scalar(v)
        return t.unsqueeze(-1).expand(self.shape)

    def zeros(self) -> torch.Tensor:
        return self.full(0.0)

    def mask(self):
        return self.mask_stack[-1]

    def rand_uniform(self, lo: Vec, hi: Vec) -> Vec:
        w = max(lo.width, hi.width)
        lo = lo.broadcast_to(w)
        hi = hi.broadcast_to(w)
        out = []
        for i in range(w):
            self._rand_counter += 1
            with profiler.block("particles.random"):
                u = prng.fold_uniform(self.key, self._rand_counter, (self.cap,)).expand(self.shape)
            out.append(lo.comps[i] + (hi.comps[i] - lo.comps[i]) * u)
        return Vec(out)


def _vnoise(x):
    """Value noise (a smooth hash of the integer lattice)."""
    i = torch.floor(x)
    f = x - i

    def h(v):
        return (torch.sin(v * 12.9898) * 43758.5453) % 1.0

    u = f * f * (3.0 - 2.0 * f)
    return h(i) * (1 - u) + h(i + 1.0) * u


_BUILTIN_1 = {
    "sin": torch.sin, "cos": torch.cos, "sqrt": lambda x: torch.sqrt(torch.clamp_min(x, 0.0)),
    "frac": lambda x: x - torch.floor(x), "floor": torch.floor, "noise": _vnoise,
}

_BINOPS = {
    "+": lambda x, y: x + y,
    "-": lambda x, y: x - y,
    "*": lambda x, y: x * y,
    "/": lambda x, y: x / y,
    "%": torch.remainder,  # Python-style, as jnp.mod
    "<": lambda x, y: (x < y).to(torch.float32),
    ">": lambda x, y: (x > y).to(torch.float32),
    "<=": lambda x, y: (x <= y).to(torch.float32),
    ">=": lambda x, y: (x >= y).to(torch.float32),
    "==": lambda x, y: (x == y).to(torch.float32),
    "!=": lambda x, y: (x != y).to(torch.float32),
    "&&": lambda x, y: ((x != 0) & (y != 0)).to(torch.float32),
    "||": lambda x, y: ((x != 0) | (y != 0)).to(torch.float32),
}


def _eval(expr, env: Dict[str, Vec], ctx: _ExecCtx) -> Vec:
    if isinstance(expr, Num):
        return Vec([ctx.full(expr.value)])
    if isinstance(expr, Ref):
        n = expr.name
        if n in env:
            return env[n]
        if n in ctx.consts:
            return Vec([ctx.full(ctx.consts[n])])
        if n == "time_delta":
            return Vec([ctx.full(ctx.dt)])
        if n == "total_time":
            return Vec([ctx.full(ctx.time)])
        if n in ctx.extern:
            return Vec([c.expand(ctx.shape) for c in ctx.extern[n].comps])
        raise CompileError(f"undefined identifier {n!r}")
    if isinstance(expr, Swizzle):
        base = _eval(expr.base, env, ctx)
        idx = [_SWIZZLE_IDX[c] for c in expr.comps]
        for i in idx:
            if i >= base.width:
                raise CompileError(f"swizzle .{expr.comps} out of range for width {base.width}")
        return Vec([base.comps[i] for i in idx])
    if isinstance(expr, Unary):
        a = _eval(expr.a, env, ctx)
        if expr.op == "-":
            return Vec([-c for c in a.comps])
        return Vec([(c == 0.0).to(torch.float32) for c in a.comps])
    if isinstance(expr, BinOp):
        a = _eval(expr.a, env, ctx)
        b = _eval(expr.b, env, ctx)
        return _zip_op(_BINOPS[expr.op], a, b)
    if isinstance(expr, VecLit):
        comps = []
        for item in expr.items:
            comps.extend(_eval(item, env, ctx).comps)
        return Vec(comps)
    if isinstance(expr, Call):
        return _eval_call(expr, env, ctx)
    raise CompileError(f"bad expression node {expr!r}")


def _eval_call(call: Call, env, ctx: _ExecCtx) -> Vec:
    n = call.name
    if n == "random":
        lo = _eval(call.args[0], env, ctx)
        hi = _eval(call.args[1], env, ctx)
        return ctx.rand_uniform(lo, hi)
    if n in _BUILTIN_1:
        a = _eval(call.args[0], env, ctx)
        return Vec([_BUILTIN_1[n](c) for c in a.comps])
    if n in ("min", "max"):
        a = _eval(call.args[0], env, ctx)
        b = _eval(call.args[1], env, ctx)
        return _zip_op(torch.minimum if n == "min" else torch.maximum, a, b)
    if n == "mix":
        a = _eval(call.args[0], env, ctx)
        b = _eval(call.args[1], env, ctx)
        t = _eval(call.args[2], env, ctx)
        w = max(a.width, b.width)
        a, b, t = a.broadcast_to(w), b.broadcast_to(w), t.broadcast_to(w)
        return Vec([x + (y - x) * s for x, y, s in zip(a.comps, b.comps, t.comps)])
    if n in ctx.functions:
        fn = ctx.functions[n]
        if len(call.args) != len(fn.params):
            raise CompileError(f"{n}() expects {len(fn.params)} args")
        local = dict(env)
        for p, a in zip(fn.params, call.args):
            local[p] = _eval(a, env, ctx)
        _exec_block(fn.body, local, ctx)
        if "result" not in local:
            raise CompileError(f"fn {n} did not assign result")
        return local["result"]
    raise CompileError(f"unknown function {n!r}")


def _masked_assign(old: Vec, new: Vec, comps: Optional[str], mask) -> Vec:
    """Write `new` into `old` (optionally through a swizzle), predicated by the
    active branch mask — branches become selects."""
    if comps is None:
        new = new.broadcast_to(old.width)
        if new.width != old.width:
            raise CompileError(f"width mismatch: {new.width} into {old.width}")
        if mask is None:
            return new
        return Vec([torch.where(mask, nc, oc) for nc, oc in zip(new.comps, old.comps)])
    out = list(old.comps)
    idx = [_SWIZZLE_IDX[c] for c in comps]
    new = new.broadcast_to(len(idx))
    for j, i in enumerate(idx):
        if i >= len(out):
            raise CompileError(f"swizzle write .{comps} out of range")
        out[i] = new.comps[j] if mask is None else torch.where(mask, new.comps[j], old.comps[i])
    return Vec(out)


def _exec_block(stmts, env: Dict[str, Vec], ctx: _ExecCtx) -> None:
    for st in stmts:
        if isinstance(st, Let):
            if st.expr is not None:
                env[st.name] = _eval(st.expr, env, ctx)
            else:
                env[st.name] = Vec([ctx.zeros()] * _TYPE_WIDTH[st.type or "float"])
        elif isinstance(st, Assign):
            new = _eval(st.expr, env, ctx)
            if st.name not in env:
                if st.comps is not None:
                    raise CompileError(f"swizzle write to undeclared {st.name!r}")
                env[st.name] = new
            else:
                env[st.name] = _masked_assign(env[st.name], new, st.comps, ctx.mask())
        elif isinstance(st, If):
            cond = _eval(st.cond, env, ctx).comps[0] != 0.0
            parent = ctx.mask()
            ctx.mask_stack.append(cond if parent is None else (parent & cond))
            _exec_block(st.then, env, ctx)
            ctx.mask_stack.pop()
            if st.orelse:
                ctx.mask_stack.append(~cond if parent is None else (parent & ~cond))
                _exec_block(st.orelse, env, ctx)
                ctx.mask_stack.pop()
        elif isinstance(st, Kill):
            m = ctx.mask()
            ctx.kill_mask = torch.ones_like(ctx.kill_mask) if m is None else ctx.kill_mask | m
        elif isinstance(st, EmitStmt):
            ins: Dict[str, Vec] = {}
            for a in st.assigns:
                v = _eval(a.expr, env, ctx)
                if a.comps is not None:
                    need = max(_SWIZZLE_IDX[c] for c in a.comps) + 1
                    old = ins.get(a.name, Vec([]))
                    if old.width < need:  # widen — declared width lives in the
                        # TARGET emitter; run_emit broadcasts the final value
                        old = Vec(list(old.comps) + [ctx.zeros()] * (need - old.width))
                    ins[a.name] = _masked_assign(old, v, a.comps, None)
                else:
                    ins[a.name] = v
            m = ctx.mask()
            ctx.emits.append(EmitRequest(
                st.target, torch.ones_like(ctx.kill_mask) if m is None else m, ins))
        else:
            raise CompileError(f"bad statement {st!r}")


class CompiledEmitter:
    """One emitter's programs + metadata. The run_* methods take the shape
    [..., cap] of the invocation and a key batched like its leading axes."""

    def __init__(self, decl: EmitterDecl, consts, functions,
                 globals_decl: Optional[Dict[str, int]] = None):
        self.decl = decl
        self.name = decl.name
        self.consts = consts
        self.functions = functions
        self.globals_decl = dict(globals_decl or {})
        self.channels: List[Tuple[str, int]] = [(n, _TYPE_WIDTH[t]) for n, t in decl.vars]
        self.outs: List[Tuple[str, int]] = [(n, _TYPE_WIDTH[t]) for n, t in decl.outs]
        self.ins: List[Tuple[str, int]] = [(n, _TYPE_WIDTH[t]) for n, t in decl.ins]

    def channel_rows(self) -> int:
        return sum(w for _, w in self.channels)

    def out_rows(self) -> int:
        return sum(w for _, w in self.outs)

    def _run(self, fn_name: str, channels: Dict[str, Vec], shape, dt, time, key,
             extra_env: Optional[Callable[[_ExecCtx], Dict[str, Vec]]] = None,
             extern: Optional[Dict[str, Vec]] = None):
        ctx = _ExecCtx(shape, dt, time, key, self.consts, self.functions, extern=extern)
        env = dict(channels)
        if extra_env:
            env.update(extra_env(ctx))
        fn = self.decl.fns.get(fn_name)
        if fn is not None:
            _exec_block(fn.body, env, ctx)
        new_channels = {n: env[n] for n, _ in self.channels if n in env}
        return env, new_channels, ctx

    def run_update(self, channels, shape, dt, time, key, extern=None):
        """→ (new var channels, kill_mask [..., cap], emit requests)."""
        env, new_ch, ctx = self._run("update", channels, shape, dt, time, key, extern=extern)
        return new_ch, ctx.kill_mask, ctx.emits

    def run_emit(self, channels, shape, key, ins: Optional[Dict[str, Vec]] = None,
                 extern=None):
        """Vectorized spawn-candidate values for every slot."""
        def extra(ctx):
            out = dict(ins or {})
            for n, w in self.ins:
                out.setdefault(n, Vec([ctx.zeros()] * w))
            return out

        env, new_ch, ctx = self._run("emit", channels, shape, 0.0, 0.0, key, extra,
                                     extern=extern)
        return new_ch

    def run_output(self, channels, shape, dt, time, key, extern=None):
        # out channels are writable (incl. swizzled) in output(): seed zeros
        def seeded(ctx):
            return {n: Vec([ctx.zeros()] * w) for n, w in self.outs}

        env, _, ctx = self._run("output", channels, shape, dt, time, key, seeded, extern=extern)
        return {n: env[n].broadcast_to(w) if n in env else Vec([ctx.zeros()] * w)
                for n, w in self.outs}


def compile_source(src: str, imports: Optional[Dict[str, str]] = None,
                   resolve: Optional[Callable[[str], str]] = None
                   ) -> Dict[str, CompiledEmitter]:
    """Compile a .pat source (plus imported .pai libraries) → emitters.
    `imports` maps import paths to sources; `resolve` loads an import that
    `imports` does not hold (a path → its source)."""
    prog = Parser(src).parse_program()
    seen = set()
    frontier = list(prog.imports)
    while frontier:
        path = frontier.pop()
        if path in seen:
            continue
        seen.add(path)
        isrc = None
        if imports:
            # paths may be absolute ("/engine/particles/common.pai") or
            # relative; match progressively looser forms incl. basename
            for cand in (path, path.lstrip("/"),
                         path.lstrip("/").removeprefix("engine/"),
                         path.rsplit("/", 1)[-1]):
                if cand in imports:
                    isrc = imports[cand]
                    break
        if isrc is None and resolve is not None:
            isrc = resolve(path)
        if isrc is None:
            raise CompileError(f"unresolved import {path!r}")
        sub = Parser(isrc).parse_program()
        frontier.extend(sub.imports)
        prog.consts.update({k: v for k, v in sub.consts.items() if k not in prog.consts})
        for k, v in sub.functions.items():
            prog.functions.setdefault(k, v)
        for k, v in sub.emitters.items():
            prog.emitters.setdefault(k, v)
        for k, v in sub.globals.items():
            prog.globals.setdefault(k, v)
    return {
        name: CompiledEmitter(decl, prog.consts, prog.functions, prog.globals)
        for name, decl in prog.emitters.items()
    }

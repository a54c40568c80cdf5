"""Lua/Luau recursive-descent parser → tuple AST (clean-room, from the public
Lua 5.1 grammar + the Luau extras used by the reference's demo scripts:
compound assignment, `continue`, and type annotations, which are skipped).

AST is plain tuples; first element is the node kind (see interp.py).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from lumixengine_tpu_torch.script.lua.lexer import LuaSyntaxError, Token, tokenize

# binary operator precedence (left, right) — right > left means right-assoc
_BINPRI = {
    "or": (1, 1), "and": (2, 2),
    "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3), "~=": (3, 3), "==": (3, 3),
    "..": (9, 8),  # right assoc
    "+": (10, 10), "-": (10, 10),
    "*": (11, 11), "/": (11, 11), "//": (11, 11), "%": (11, 11),
    "^": (14, 13),  # right assoc
}
_UNARY_PRI = 12
_COMPOUND = {"+=": "+", "-=": "-", "*=": "*", "/=": "/", "%=": "%",
             "^=": "^", "..=": ".."}


class Parser:
    def __init__(self, src: str, chunkname: str = "?"):
        self.toks = tokenize(src, chunkname)
        self.pos = 0
        self.chunk = chunkname

    # -- token helpers -----------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def check(self, kind: str, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def accept(self, kind: str, value=None) -> Optional[Token]:
        if self.check(kind, value):
            return self.next()
        return None

    def expect(self, kind: str, value=None) -> Token:
        t = self.peek()
        if not self.check(kind, value):
            raise LuaSyntaxError(
                f"{self.chunk}:{t.line}: expected {value or kind}, got {t.value!r}")
        return self.next()

    def err(self, msg: str):
        raise LuaSyntaxError(f"{self.chunk}:{self.peek().line}: {msg}")

    # -- Luau type annotations (parsed and discarded) ------------------------------

    def skip_type(self) -> None:
        t = self.peek()
        if t.kind == "sym" and t.value == "(":
            self._skip_balanced("(", ")")
        elif t.kind == "sym" and t.value == "{":
            self._skip_balanced("{", "}")
        elif t.kind in ("name", "string") or (t.kind == "keyword" and t.value in ("nil", "true", "false")):
            self.next()
            while self.accept("sym", "."):
                self.next()
            if self.check("sym", "<"):
                self._skip_balanced("<", ">")
        else:
            self.err(f"bad type annotation near {t.value!r}")
        self.accept("sym", "?")
        if self.accept("sym", "|") or self.accept("sym", "&"):
            self.skip_type()

    def _skip_balanced(self, open_s: str, close_s: str) -> None:
        self.expect("sym", open_s)
        depth = 1
        while depth:
            t = self.next()
            if t.kind == "eof":
                self.err("unterminated type annotation")
            if t.kind == "sym" and t.value == open_s:
                depth += 1
            elif t.kind == "sym" and t.value == close_s:
                depth -= 1

    # -- blocks / statements ------------------------------------------------------

    def parse_chunk(self) -> tuple:
        body = self.block()
        self.expect("eof")
        return ("block", body)

    _BLOCK_END = {"end", "else", "elseif", "until"}

    def block(self) -> List[tuple]:
        stmts: List[tuple] = []
        while True:
            t = self.peek()
            if t.kind == "eof" or (t.kind == "keyword" and t.value in self._BLOCK_END):
                return stmts
            if t.kind == "keyword" and t.value == "return":
                self.next()
                exprs = []
                nt = self.peek()
                if not (nt.kind == "eof"
                        or (nt.kind == "keyword" and nt.value in self._BLOCK_END)
                        or (nt.kind == "sym" and nt.value == ";")):
                    exprs = self.exprlist()
                self.accept("sym", ";")
                stmts.append(("return", exprs, t.line))
                return stmts
            st = self.statement()
            if st is not None:
                stmts.append(st)

    def statement(self) -> Optional[tuple]:
        t = self.peek()
        if t.kind == "sym" and t.value == ";":
            self.next()
            return None
        if t.kind == "keyword":
            kw = t.value
            if kw == "break":
                self.next()
                return ("break", t.line)
            if kw == "continue":
                self.next()
                return ("continue", t.line)
            if kw == "do":
                self.next()
                body = self.block()
                self.expect("keyword", "end")
                return ("do", body)
            if kw == "while":
                self.next()
                cond = self.expr()
                self.expect("keyword", "do")
                body = self.block()
                self.expect("keyword", "end")
                return ("while", cond, body, t.line)
            if kw == "repeat":
                self.next()
                body = self.block()
                self.expect("keyword", "until")
                cond = self.expr()
                return ("repeat", body, cond, t.line)
            if kw == "if":
                return self.if_stmt()
            if kw == "for":
                return self.for_stmt()
            if kw == "function":
                return self.func_stmt()
            if kw == "local":
                return self.local_stmt()
            self.err(f"unexpected keyword {kw!r}")
        # exprstat: assignment / compound / call
        line = t.line
        e = self.suffixed_expr()
        nt = self.peek()
        if nt.kind == "sym" and nt.value in _COMPOUND:
            self.next()
            rhs = self.expr()
            return ("compound", e, _COMPOUND[nt.value], rhs, line)
        if nt.kind == "sym" and nt.value in ("=", ","):
            targets = [e]
            while self.accept("sym", ","):
                targets.append(self.suffixed_expr())
            self.expect("sym", "=")
            exprs = self.exprlist()
            return ("assign", targets, exprs, line)
        if e[0] not in ("call", "method"):
            self.err("syntax error: expression statement must be a call")
        return ("call_stmt", e, line)

    def if_stmt(self) -> tuple:
        line = self.expect("keyword", "if").line
        arms = []
        cond = self.expr()
        self.expect("keyword", "then")
        arms.append((cond, self.block()))
        els: List[tuple] = []
        while True:
            t = self.peek()
            if t.kind == "keyword" and t.value == "elseif":
                self.next()
                c = self.expr()
                self.expect("keyword", "then")
                arms.append((c, self.block()))
            elif t.kind == "keyword" and t.value == "else":
                self.next()
                els = self.block()
                self.expect("keyword", "end")
                break
            else:
                self.expect("keyword", "end")
                break
        return ("if", arms, els, line)

    def for_stmt(self) -> tuple:
        line = self.expect("keyword", "for").line
        name = self.expect("name").value
        if self.accept("sym", ":"):
            self.skip_type()
        if self.accept("sym", "="):
            start = self.expr()
            self.expect("sym", ",")
            stop = self.expr()
            step = None
            if self.accept("sym", ","):
                step = self.expr()
            self.expect("keyword", "do")
            body = self.block()
            self.expect("keyword", "end")
            return ("fornum", name, start, stop, step, body, line)
        names = [name]
        while self.accept("sym", ","):
            names.append(self.expect("name").value)
            if self.accept("sym", ":"):
                self.skip_type()
        self.expect("keyword", "in")
        exprs = self.exprlist()
        self.expect("keyword", "do")
        body = self.block()
        self.expect("keyword", "end")
        return ("forin", names, exprs, body, line)

    def func_stmt(self) -> tuple:
        line = self.expect("keyword", "function").line
        target: tuple = ("name", self.expect("name").value, line)
        is_method = False
        while self.accept("sym", "."):
            target = ("index", target, ("str", self.expect("name").value), line)
        if self.accept("sym", ":"):
            target = ("index", target, ("str", self.expect("name").value), line)
            is_method = True
        fn = self.func_body(line, is_method)
        return ("assign", [target], [fn], line)

    def local_stmt(self) -> tuple:
        line = self.expect("keyword", "local").line
        if self.accept("keyword", "function"):
            name = self.expect("name").value
            fn = self.func_body(line, False)
            return ("localfunc", name, fn, line)
        names = [self.expect("name").value]
        if self.accept("sym", ":"):
            self.skip_type()
        while self.accept("sym", ","):
            names.append(self.expect("name").value)
            if self.accept("sym", ":"):
                self.skip_type()
        exprs: List[tuple] = []
        if self.accept("sym", "="):
            exprs = self.exprlist()
        return ("local", names, exprs, line)

    def func_body(self, line: int, is_method: bool) -> tuple:
        self.expect("sym", "(")
        params: List[str] = ["self"] if is_method else []
        is_vararg = False
        if not self.check("sym", ")"):
            while True:
                if self.accept("sym", "..."):
                    is_vararg = True
                    break
                params.append(self.expect("name").value)
                if self.accept("sym", ":"):
                    self.skip_type()
                if not self.accept("sym", ","):
                    break
        self.expect("sym", ")")
        if self.accept("sym", ":"):  # Luau return type
            self.skip_type()
        body = self.block()
        self.expect("keyword", "end")
        return ("func", params, is_vararg, body, line)

    # -- expressions ----------------------------------------------------------------

    def exprlist(self) -> List[tuple]:
        out = [self.expr()]
        while self.accept("sym", ","):
            out.append(self.expr())
        return out

    def expr(self, limit: int = 0) -> tuple:
        t = self.peek()
        if t.kind == "keyword" and t.value == "not":
            self.next()
            e: tuple = ("unop", "not", self.expr(_UNARY_PRI), t.line)
        elif t.kind == "sym" and t.value == "-":
            self.next()
            e = ("unop", "-", self.expr(_UNARY_PRI), t.line)
        elif t.kind == "sym" and t.value == "#":
            self.next()
            e = ("unop", "#", self.expr(_UNARY_PRI), t.line)
        else:
            e = self.simple_expr()
        while True:
            t = self.peek()
            op = None
            if t.kind == "sym" and t.value in _BINPRI:
                op = t.value
            elif t.kind == "keyword" and t.value in ("and", "or"):
                op = t.value
            if op is None:
                break
            left_pri, right_pri = _BINPRI[op]
            if left_pri <= limit:
                break
            self.next()
            rhs = self.expr(right_pri)
            if op == "and":
                e = ("and", e, rhs)
            elif op == "or":
                e = ("or", e, rhs)
            else:
                e = ("binop", op, e, rhs, t.line)
        return e

    def simple_expr(self) -> tuple:
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ("num", t.value)
        if t.kind == "string":
            self.next()
            return ("str", t.value)
        if t.kind == "keyword":
            if t.value == "nil":
                self.next()
                return ("nil",)
            if t.value == "true":
                self.next()
                return ("true",)
            if t.value == "false":
                self.next()
                return ("false",)
            if t.value == "function":
                self.next()
                return self.func_body(t.line, False)
        if t.kind == "sym":
            if t.value == "...":
                self.next()
                return ("vararg", t.line)
            if t.value == "{":
                return self.table_expr()
        return self.suffixed_expr()

    def primary_expr(self) -> tuple:
        t = self.peek()
        if t.kind == "name":
            self.next()
            return ("name", t.value, t.line)
        if t.kind == "sym" and t.value == "(":
            self.next()
            e = self.expr()
            self.expect("sym", ")")
            return ("paren", e)
        self.err(f"unexpected symbol near {t.value!r}")

    def suffixed_expr(self) -> tuple:
        e = self.primary_expr()
        while True:
            t = self.peek()
            if t.kind == "sym" and t.value == ".":
                self.next()
                name = self.expect("name").value
                e = ("index", e, ("str", name), t.line)
            elif t.kind == "sym" and t.value == "[":
                self.next()
                k = self.expr()
                self.expect("sym", "]")
                e = ("index", e, k, t.line)
            elif t.kind == "sym" and t.value == ":":
                # ambiguous with type annotation in Luau, but in expression
                # position a colon is always a method call
                self.next()
                name = self.expect("name").value
                args = self.call_args()
                e = ("method", e, name, args, t.line)
            elif (t.kind == "sym" and t.value == "(") or t.kind == "string" \
                    or (t.kind == "sym" and t.value == "{"):
                args = self.call_args()
                e = ("call", e, args, t.line)
            else:
                return e

    def call_args(self) -> List[tuple]:
        t = self.peek()
        if t.kind == "string":
            self.next()
            return [("str", t.value)]
        if t.kind == "sym" and t.value == "{":
            return [self.table_expr()]
        self.expect("sym", "(")
        args: List[tuple] = []
        if not self.check("sym", ")"):
            args = self.exprlist()
        self.expect("sym", ")")
        return args

    def table_expr(self) -> tuple:
        line = self.expect("sym", "{").line
        items: List[Tuple[Optional[tuple], tuple]] = []
        while not self.check("sym", "}"):
            t = self.peek()
            if t.kind == "sym" and t.value == "[":
                self.next()
                k = self.expr()
                self.expect("sym", "]")
                self.expect("sym", "=")
                items.append((k, self.expr()))
            elif t.kind == "name" and self.peek(1).kind == "sym" and self.peek(1).value == "=":
                self.next()
                self.next()
                items.append((("str", t.value), self.expr()))
            else:
                items.append((None, self.expr()))
            if not (self.accept("sym", ",") or self.accept("sym", ";")):
                break
        self.expect("sym", "}")
        return ("table", items, line)


def parse(src: str, chunkname: str = "?") -> tuple:
    return Parser(src, chunkname).parse_chunk()

"""Shared tokenizer (counterpart of ``lumixengine_tpu/core/tokenizer.py``, a
copy: the lexer of the particle script compiler).

Token kinds: identifiers, numbers, strings, symbols. Positions are tracked
for error messages ("line:col").
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

IDENT = "ident"
NUMBER = "number"
STRING = "string"
SYMBOL = "symbol"
EOF = "eof"

# multi-char symbols first so they win the alternation
_SYMBOLS = ["==", "!=", "<=", ">=", "&&", "||",
            "{", "}", "(", ")", "[", "]", ",", ";", ":", ".", "=",
            "+", "-", "*", "/", "%", "<", ">", "!"]

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<nl>\n)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>\d+\.\d*|\.\d+|\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<symbol>%s)
    """
    % "|".join(re.escape(s) for s in _SYMBOLS),
    re.VERBOSE | re.DOTALL,
)


@dataclass
class Token:
    kind: str
    value: str
    line: int
    col: int

    def __repr__(self):
        return f"Token({self.kind}, {self.value!r} @{self.line}:{self.col})"


class TokenizeError(ValueError):
    pass


def tokenize(src: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    line = 1
    line_start = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            col = pos - line_start + 1
            raise TokenizeError(f"unexpected character {src[pos]!r} at {line}:{col}")
        kind = m.lastgroup
        text = m.group()
        col = pos - line_start + 1
        if kind == "nl":
            line += 1
            line_start = m.end()
        elif kind in ("ws", "comment"):
            line += text.count("\n")
            if "\n" in text:
                line_start = pos + text.rfind("\n") + 1
        elif kind == "string":
            tokens.append(Token(STRING, text[1:-1], line, col))
        else:
            tokens.append(Token(kind, text, line, col))
        pos = m.end()
    tokens.append(Token(EOF, "", line, n - line_start + 1))
    return tokens


class TokenStream:
    """Cursor with peek/expect helpers (parser front end)."""

    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.i = 0

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.peek()
        self.i += 1
        return t

    def at_symbol(self, sym: str) -> bool:
        t = self.peek()
        return t.kind == SYMBOL and t.value == sym

    def at_ident(self, name: Optional[str] = None) -> bool:
        t = self.peek()
        return t.kind == IDENT and (name is None or t.value == name)

    def accept_symbol(self, sym: str) -> bool:
        if self.at_symbol(sym):
            self.i += 1
            return True
        return False

    def expect_symbol(self, sym: str) -> Token:
        t = self.next()
        if t.kind != SYMBOL or t.value != sym:
            raise TokenizeError(f"expected {sym!r}, got {t.value!r} at {t.line}:{t.col}")
        return t

    def expect_ident(self, name: Optional[str] = None) -> Token:
        t = self.next()
        if t.kind != IDENT or (name is not None and t.value != name):
            raise TokenizeError(f"expected identifier{f' {name!r}' if name else ''}, got {t.value!r} at {t.line}:{t.col}")
        return t

    def expect_number(self) -> float:
        neg = self.accept_symbol("-")
        t = self.next()
        if t.kind != NUMBER:
            raise TokenizeError(f"expected number, got {t.value!r} at {t.line}:{t.col}")
        return -float(t.value) if neg else float(t.value)

    def expect_string(self) -> str:
        t = self.next()
        if t.kind != STRING:
            raise TokenizeError(f"expected string, got {t.value!r} at {t.line}:{t.col}")
        return t.value

    def done(self) -> bool:
        return self.peek().kind == EOF

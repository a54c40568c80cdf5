"""Lua/Luau lexer (clean-room; grammar per the public Lua 5.1 manual plus the
Luau extensions the reference's demo scripts use: compound assignment ops and
type annotations).

≙ reference: the Luau VM in external/luau executes these scripts; here they
feed lumixengine_tpu_torch.script.lua.parser/interp instead.
"""
from __future__ import annotations

from typing import List, NamedTuple

KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for", "function",
    "if", "in", "local", "nil", "not", "or", "repeat", "return", "then",
    "true", "until", "while", "continue",
}

# longest-match first
SYMBOLS = [
    "...", "..=", "==", "~=", "<=", ">=", "..", "::", "+=", "-=", "*=", "/=",
    "%=", "^=", "//", "->", "+", "-", "*", "/", "%", "^", "#", "<", ">", "=",
    "(", ")", "{", "}", "[", "]", ";", ":", ",", ".", "|", "&", "?",
]


class Token(NamedTuple):
    kind: str   # 'name' | 'number' | 'string' | 'keyword' | 'sym' | 'eof'
    value: object
    line: int


class LuaSyntaxError(SyntaxError):
    pass


def _long_bracket_level(src: str, i: int) -> int:
    """At src[i] == '[': return level n if this opens [=*[ , else -1."""
    j = i + 1
    while j < len(src) and src[j] == "=":
        j += 1
    if j < len(src) and src[j] == "[":
        return j - i - 1
    return -1


def _read_long_string(src: str, i: int, level: int, line: int):
    """Read past [=^n[ ... ]=^n]. Returns (content, next_index, line)."""
    i += level + 2
    if i < len(src) and src[i] == "\n":  # skip first newline (Lua rule)
        i += 1
        line += 1
    close = "]" + "=" * level + "]"
    end = src.find(close, i)
    if end < 0:
        raise LuaSyntaxError(f"unterminated long string at line {line}")
    content = src[i:end]
    return content, end + len(close), line + content.count("\n")


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "a": "\a", "b": "\b",
            "f": "\f", "v": "\v", "\\": "\\", '"': '"', "'": "'", "\n": "\n"}


def tokenize(src: str, chunkname: str = "?") -> List[Token]:
    toks: List[Token] = []
    i, line, n = 0, 1, len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("--", i):
            lvl = _long_bracket_level(src, i + 2) if i + 2 < n and src[i + 2] == "[" else -1
            if lvl >= 0:
                _, i, line = _read_long_string(src, i + 2, lvl, line)
            else:
                j = src.find("\n", i)
                i = n if j < 0 else j
            continue
        if c == "[" :
            lvl = _long_bracket_level(src, i)
            if lvl >= 0:
                s, i, line = _read_long_string(src, i, lvl, line)
                toks.append(Token("string", s, line))
                continue
        if c in "\"'":
            quote = c
            j = i + 1
            buf = []
            while j < n and src[j] != quote:
                ch = src[j]
                if ch == "\n":
                    raise LuaSyntaxError(f"{chunkname}:{line}: unfinished string")
                if ch == "\\":
                    j += 1
                    if j >= n:
                        break
                    e = src[j]
                    if e in _ESCAPES:
                        buf.append(_ESCAPES[e])
                        if e == "\n":
                            line += 1
                    elif e.isdigit():
                        num = e
                        while (j + 1 < n and src[j + 1].isdigit()
                               and len(num) < 3):
                            j += 1
                            num += src[j]
                        buf.append(chr(int(num)))
                    elif e == "x":
                        buf.append(chr(int(src[j + 1:j + 3], 16)))
                        j += 2
                    else:
                        buf.append(e)
                else:
                    buf.append(ch)
                j += 1
            if j >= n:
                raise LuaSyntaxError(f"{chunkname}:{line}: unfinished string")
            toks.append(Token("string", "".join(buf), line))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and (src[j] in "0123456789abcdefABCDEF"):
                    j += 1
                val = float(int(src[i:j], 16))
            else:
                while j < n and (src[j].isdigit() or src[j] == "."):
                    j += 1
                if j < n and src[j] in "eE":
                    j += 1
                    if j < n and src[j] in "+-":
                        j += 1
                    while j < n and src[j].isdigit():
                        j += 1
                val = float(src[i:j])
            toks.append(Token("number", val, line))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            toks.append(Token("keyword" if word in KEYWORDS else "name", word, line))
            i = j
            continue
        for sym in SYMBOLS:
            if src.startswith(sym, i):
                toks.append(Token("sym", sym, line))
                i += len(sym)
                break
        else:
            raise LuaSyntaxError(f"{chunkname}:{line}: unexpected character {c!r}")
    toks.append(Token("eof", None, line))
    return toks

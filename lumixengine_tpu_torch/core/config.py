"""Config / flags (≙ reference's three mechanisms — SURVEY.md §5):
  1. CommandLineParser (core/command_line_parser.h): -world, -profile_start, ...
  2. project file: startup world + per-system versioned config (engine.cpp)
  3. editor Settings registry: typed options with categories persisted to ini,
     merged default + user file (editor/settings.h, data/studio_default.ini)

TPU build: one typed option registry backing both CLI overrides and ini
persistence, plus a Project dataclass serialized next to world saves.
"""
from __future__ import annotations

import json
import os
import shlex
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Option:
    name: str
    category: str
    default: Any
    type: str  # "bool" | "int" | "float" | "string"
    value: Any = None

    def get(self):
        return self.default if self.value is None else self.value


class Settings:
    """Typed option registry with ini persistence (≙ editor/settings.h
    registerOption + studio_default.ini merge)."""

    def __init__(self):
        self.options: Dict[str, Option] = {}

    def register(self, name: str, default: Any, category: str = "general") -> Option:
        t = {bool: "bool", int: "int", float: "float", str: "string"}[type(default)]
        opt = Option(name, category, default, t)
        self.options[name] = opt
        return opt

    def get(self, name: str):
        return self.options[name].get()

    def set(self, name: str, value) -> None:
        opt = self.options[name]
        cast = {"bool": lambda v: v in (True, "true", "1", 1),
                "int": int, "float": float, "string": str}[opt.type]
        opt.value = cast(value)

    # -- ini persistence (merged default + user, ≙ settings.cpp) ---------------

    def save_ini(self, path: str, only_modified: bool = True) -> None:
        by_cat: Dict[str, List[Option]] = {}
        for o in self.options.values():
            if only_modified and o.value is None:
                continue
            by_cat.setdefault(o.category, []).append(o)
        lines = []
        for cat in sorted(by_cat):
            lines.append(f"[{cat}]")
            for o in sorted(by_cat[cat], key=lambda x: x.name):
                lines.append(f"{o.name} = {o.get()}")
            lines.append("")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines))

    def load_ini(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("[", "#", ";")):
                    continue
                if "=" in line:
                    k, v = (s.strip() for s in line.split("=", 1))
                    if k in self.options:
                        self.set(k, v)


class CommandLineParser:
    """≙ core/command_line_parser.h — flags like -world path -profile_start."""

    def __init__(self, argv: Optional[List[str]] = None, cmdline: Optional[str] = None):
        if cmdline is not None:
            argv = shlex.split(cmdline)
        self.argv = list(argv or [])
        self.flags: Dict[str, Optional[str]] = {}
        i = 0
        while i < len(self.argv):
            a = self.argv[i]
            if a.startswith("-"):
                name = a.lstrip("-")
                if i + 1 < len(self.argv) and not self.argv[i + 1].startswith("-"):
                    self.flags[name] = self.argv[i + 1]
                    i += 2
                    continue
                self.flags[name] = None
            i += 1

    def has(self, name: str) -> bool:
        return name in self.flags

    def value(self, name: str, default: Optional[str] = None) -> Optional[str]:
        v = self.flags.get(name, default)
        return default if v is None else v

    def apply_to_settings(self, settings: Settings) -> None:
        for name, v in self.flags.items():
            if name in settings.options:
                settings.set(name, v if v is not None else True)


@dataclass
class Project:
    """≙ engine.cpp project serialization: startup world + per-system versions."""

    startup_world: str = ""
    system_versions: Dict[str, int] = field(default_factory=dict)
    settings: Dict[str, Any] = field(default_factory=dict)

    def dumps(self) -> str:
        return json.dumps({
            "startup_world": self.startup_world,
            "system_versions": self.system_versions,
            "settings": self.settings,
        }, indent=2)

    @staticmethod
    def loads(text: str) -> "Project":
        d = json.loads(text)
        return Project(
            startup_world=d.get("startup_world", ""),
            system_versions=dict(d.get("system_versions", {})),
            settings=dict(d.get("settings", {})),
        )

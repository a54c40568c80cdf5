"""Settings view (counterpart of
``lumixengine_tpu/editor/settings_ui.py``; ≙ reference editor/settings.cpp:1-1648 — the Settings
window: typed options registered by every editor subsystem, grouped by
category, edited in a grid, persisted as merged default + user ini).

Same surface over core/config.py's Settings registry: categories ·
up/down/enter edit state machine (typed commit through Settings.set's
casts) · 'b' toggles a bool row directly · 's' saves the user ini ·
'r' resets the selected row to default. `on_change` lets the owning
EditorApp push edits into LIVE views (≙ the reference's registerPtr
options, which point straight at the subsystem's field)."""
from __future__ import annotations

from typing import Callable, List, Optional

from lumixengine_tpu_torch.core.config import Settings


class SettingsUI:
    def __init__(self, settings: Settings, ini_path: str = "",
                 on_change: Optional[Callable[[str], None]] = None):
        self.settings = settings
        self.ini_path = ini_path or ".lumix_editor.ini"
        self.on_change = on_change
        self.sel = 0
        self.edit: Optional[str] = None
        self.status = "settings"

    def rows(self) -> List[str]:
        """Option names, grouped by category then name (≙ the category
        tree in the settings window)."""
        return [o.name for o in sorted(self.settings.options.values(),
                                       key=lambda o: (o.category, o.name))]

    def _changed(self, name: str) -> None:
        if self.on_change is not None:
            self.on_change(name)

    def handle_key(self, code: int, text: str = "") -> None:
        rows = self.rows()
        if not rows:
            return
        self.sel = max(0, min(self.sel, len(rows) - 1))
        name = rows[self.sel]
        if self.edit is not None:
            if code == 13:
                v, self.edit = self.edit, None
                try:
                    self.settings.set(name, v)
                    self.status = f"{name} = {self.settings.get(name)}"
                    self._changed(name)
                except (ValueError, KeyError) as exc:
                    self.status = f"bad value: {exc}"
            elif code == 27:
                self.edit = None
                self.status = "edit cancelled"
            elif code == 8:
                self.edit = self.edit[:-1]
            elif text:
                self.edit += text
            return
        ch = text.lower()
        if code == 0x26:
            self.sel = max(self.sel - 1, 0)
        elif code == 0x28:
            self.sel = min(self.sel + 1, len(rows) - 1)
        elif code == 13:
            opt = self.settings.options[name]
            if opt.type == "bool":      # enter toggles bools, like a checkbox
                self.settings.set(name, not self.settings.get(name))
                self.status = f"{name} = {self.settings.get(name)}"
                self._changed(name)
            else:
                self.edit = ""
                self.status = "editing — enter commits, esc cancels"
        elif ch == "r":
            self.settings.options[name].value = None
            self.status = f"{name} reset to default"
            self._changed(name)
        elif ch == "s":
            self.settings.save_ini(self.ini_path)
            self.status = f"saved {self.ini_path}"

    def render_text(self, width: int = 100, height: int = 28) -> str:
        rows = self.rows()
        self.sel = max(0, min(self.sel, max(len(rows) - 1, 0)))
        body = height - 2
        t0 = max(0, self.sel - body + 1)
        lines = [f"settings — {len(rows)} options ({self.ini_path})"
                 .ljust(width)[:width]]
        last_cat = None
        out_rows: List[str] = []
        for i, name in enumerate(rows):
            o = self.settings.options[name]
            cat = o.category
            prefix = f"[{cat}] " if cat != last_cat else " " * (len(cat) + 3)
            last_cat = cat
            cur = i == self.sel
            val = (self.edit + "_") if (cur and self.edit is not None) \
                else str(o.get())
            star = "*" if o.value is not None else " "
            out_rows.append(f"{'>' if cur else ' '}{star}{prefix}{o.name} "
                            f"= {val}")
        for r in out_rows[t0: t0 + body]:
            lines.append(r[:width].ljust(width))
        while len(lines) < height - 1:
            lines.append("".ljust(width))
        lines.append((f"[{self.status}]  keys: enter edit/toggle · "
                      "r reset · s save ini")[:width].ljust(width))
        return "\n".join(lines[:height])

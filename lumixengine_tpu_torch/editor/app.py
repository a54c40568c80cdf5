"""Terminal editor application (counterpart of
``lumixengine_tpu/editor/app.py``; ≙ the StudioApp/WorldEditor shell,
reference src/editor/studio_app.cpp + world_editor.cpp — there a
dockable ImGui desktop app; on this headless platform the terminal is the
display, so the SAME editing core — CommandStack undo/redo, the reflection
property grid, entity tree, serialize save — drives a two-panel TUI).

Panels: entity tree (left, parent indentation) and property grid (right:
transform rows + every reflected property of every component on the selected
entity). The key model is a pure state machine (`handle_key`) over a pure
screen composer (`render_text`), so the whole editor is unit-testable without
a tty; `run()` wires it to the TerminalWindowBackend for interactive use:

    python -m lumixengine_tpu_torch.editor.app [--world path/to/map.unv] [--device cpu]

The views that touch the device (the scene view, the game view, the graph and
particle previews) run on the engine's device: the card unless the engine was
made for the CPU. The asset browser scans `data_dirs` (default: the engine's
base path).

Keys: up/down select · tab switch panel · enter edit property (type, enter
commits through SetProperty/SetTransformCommand) · esc cancel · u undo ·
y redo · n new entity · x delete selected · s save world.unv.sav · q quit.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from lumixengine_tpu_torch.editor.commands import (CommandStack, CreateEntityCommand,
                                             DestroyEntitiesCommand,
                                             SetPropertyCommand,
                                             SetTransformCommand)
from lumixengine_tpu_torch.engine import reflection

_UP, _DOWN = 0x26, 0x28


class EditorApp:
    def __init__(self, engine, world, settings_path: str = ".lumix_editor.ini",
                 data_dirs: Optional[Tuple[str, ...]] = None):
        reflection.register_builtin_components()
        self.engine = engine
        self.device = torch.device(getattr(engine, "device", "cuda"))
        self.data_dirs = (tuple(data_dirs) if data_dirs is not None
                          else (getattr(engine.fs, "base_path", "."),))
        self.world = world
        self.settings_path = settings_path
        self.stack = CommandStack(world)
        self.sel = 0                 # index into entities()
        self.panel = "tree"          # "tree" | "props"
        self.prop_sel = 0
        self.edit: Optional[str] = None   # edit buffer while typing a value
        self.status = "ready"
        self.quit_requested = False
        self.save_path = "world.unv.sav"
        # when the world came from a .unv, save writes the reference format
        # back (≙ WorldEditor save); set by main()'s --world load
        self.scene_inst = None
        # editor views (≙ StudioApp's dockable windows), lazily constructed;
        # from main: 1 log · 2 assets · 3 profiler · 4 scene · 5 anim graph
        # · 6 particles · 7 physics · 8 game · 9 material · 0 voxelizer ·
        # ',' settings · '.' spline ('@' in assets opens the model-meta
        # editor); esc returns, 'D' docks a second pane.
        self.view = "main"
        # docked secondary pane (≙ StudioApp docking: several windows
        # visible at once; here the FOCUSED view keeps the keys and a
        # second view renders in a bottom split — 'D' cycles it)
        self.dock: Optional[str] = None
        self._asset_browser = None
        self._profiler_ui = None
        self._scene_view = None
        self._anim_editor = None
        self._particle_editor = None
        self._physics_view = None
        self._game_view = None
        self._material_editor = None
        self._voxelizer = None
        self._log_ui = None
        self._settings_ui = None
        self._spline_editor = None
        self._meta_editor = None
        # typed editor options with ini persistence (≙ editor/settings.cpp:
        # every subsystem registers its options; the user file merges over
        # defaults at startup)
        from lumixengine_tpu_torch.core.config import Settings

        s = Settings()
        s.register("save_path", self.save_path, "editor")
        s.register("move_speed", 2.0, "scene_view")
        s.register("turn_speed", 0.1, "scene_view")
        s.register("brush_radius", 8.0, "scene_view")
        s.register("time_multiplier", 1.0, "game_view")
        s.register("autoscroll", True, "log")
        s.load_ini(settings_path)
        self.settings = s
        for name in s.options:
            self._apply_setting(name)

    # -- views ---------------------------------------------------------------

    def asset_browser(self):
        if self._asset_browser is None:
            from lumixengine_tpu_torch.editor.asset_browser import AssetBrowser
            from lumixengine_tpu_torch.editor.asset_compiler import AssetCompiler
            from lumixengine_tpu_torch.importers import anm as anm_codec
            from lumixengine_tpu_torch.renderer import texture as tex

            compiler = AssetCompiler()
            anm_codec.register(compiler)

            class _TexSink:            # browser-only: discard loaded textures
                def add_texture(self, t):
                    pass

            tex.register_texture_plugins(compiler, _TexSink())
            from lumixengine_tpu_torch.importers import composite_texture as ct
            ct.register(compiler)
            from lumixengine_tpu_torch.importers import mat as mat_codec
            mat_codec.register(compiler)
            self._asset_browser = AssetBrowser(self.data_dirs,
                                               compiler=compiler)
        return self._asset_browser

    def profiler_ui(self):
        if self._profiler_ui is None:
            from lumixengine_tpu_torch.editor.profiler_ui import ProfilerUI

            self._profiler_ui = ProfilerUI()
        return self._profiler_ui

    def scene_view(self):
        if self._scene_view is None:
            from lumixengine_tpu_torch.editor.scene_view import SceneView

            self._scene_view = SceneView(self.engine, self.world)
            for name in ("move_speed", "turn_speed", "brush_radius"):
                self._apply_setting(name)
        return self._scene_view

    def anim_editor(self):
        if self._anim_editor is None:
            from lumixengine_tpu_torch.editor.anim_editor import AnimGraphEditor

            anim = self.world.modules.get("animation")
            ctrls = getattr(getattr(anim, "system", None), "controllers", [])
            if not ctrls:
                raise ValueError("no animation controllers in this world")
            ctrl = ctrls[0]
            parsed = act_path = None
            name = getattr(ctrl, "name", "")
            if isinstance(name, str) and name.endswith(".act"):
                try:
                    from lumixengine_tpu_torch.importers.act import parse_act
                    with open(name, "rb") as f:
                        parsed = parse_act(f.read())
                    act_path = name
                except OSError:
                    pass
            self._anim_editor = AnimGraphEditor(ctrl, parsed=parsed,
                                                act_path=act_path,
                                                device=self.device)
        return self._anim_editor

    def particle_editor(self, path: str = None):
        if self._particle_editor is None or path is not None:
            from lumixengine_tpu_torch.editor.particle_editor import ParticleEditor

            if path is None:
                # default: the first .pat the asset browser knows about
                pats = [e for e in self.asset_browser().entries
                        if e.type == "particle_script"]
                if not pats:
                    raise ValueError("no .pat scripts in the data dirs")
                path = pats[0].full
            self._particle_editor = ParticleEditor(path, device=self.device)
        return self._particle_editor

    def physics_view(self):
        if self._physics_view is None:
            from lumixengine_tpu_torch.editor.physics_view import PhysicsView

            if "physics" not in self.world.modules:
                raise ValueError("no physics module in this world")
            self._physics_view = PhysicsView(self.engine, self.world)
            # joint gizmos overlay the scene view's presented frame
            # (≙ physics_plugins.cpp addLine through the editor viewport)
            self.scene_view().overlays.append(
                self._physics_view.overlay_segments)
        return self._physics_view

    def game_view(self):
        if self._game_view is None:
            from lumixengine_tpu_torch.editor.game_view import GameView

            self._game_view = GameView(self.engine, self.world,
                                       on_world_replaced=self.replace_world)
        return self._game_view

    def material_editor(self, path: str = None):
        if self._material_editor is None or path is not None:
            from lumixengine_tpu_torch.editor.material_editor import MaterialEditor

            if path is None:
                mats = [e for e in self.asset_browser().entries
                        if e.type == "material"]
                if not mats:
                    raise ValueError("no .mat files in the data dirs")
                path = mats[0].full
            self._material_editor = MaterialEditor(path)
        return self._material_editor

    def voxelizer(self, path: str = None):
        if self._voxelizer is None or path is not None:
            from lumixengine_tpu_torch.editor.voxelizer_ui import VoxelizerUI

            if path is None:
                models = [e for e in self.asset_browser().entries
                          if e.type == "model" and e.path.endswith(".fbx")]
                if not models:
                    raise ValueError("no .fbx models in the data dirs")
                path = models[0].full
            self._voxelizer = VoxelizerUI(path)
        return self._voxelizer

    def log_ui(self):
        if self._log_ui is None:
            from lumixengine_tpu_torch.editor.log_ui import LogUI

            self._log_ui = LogUI()
            self._apply_setting("autoscroll")
        return self._log_ui

    def settings_ui(self):
        if self._settings_ui is None:
            from lumixengine_tpu_torch.editor.settings_ui import SettingsUI

            self._settings_ui = SettingsUI(self.settings, self.settings_path,
                                           on_change=self._apply_setting)
        return self._settings_ui

    def spline_editor(self):
        if self._spline_editor is None:
            from lumixengine_tpu_torch.editor.spline_editor import SplineEditor

            core = self.world.modules.get("core")
            if core is None or not getattr(core, "splines", None):
                raise ValueError("no splines in this world")
            self._spline_editor = SplineEditor(self.engine, self.world,
                                               self.stack)
            # polyline + point gizmos overlay the scene view's frame
            # (≙ spline_editor.cpp drawing through the WorldView)
            self.scene_view().overlays.append(
                self._spline_editor.overlay_segments)
        return self._spline_editor

    def _apply_setting(self, name: str) -> None:
        """Push a settings value into the live owner (≙ settings.cpp
        registerPtr options pointing straight at the subsystem field)."""
        v = self.settings.get(name)
        if name == "save_path":
            self.save_path = v
        elif name == "time_multiplier":
            self.engine.time_multiplier = float(v)
        elif name in ("move_speed", "turn_speed", "brush_radius"):
            if self._scene_view is not None:
                setattr(self._scene_view, name, float(v))
        elif name == "autoscroll":
            if self._log_ui is not None:
                self._log_ui.autoscroll = bool(v)

    def replace_world(self, new_world) -> None:
        """Swap the edited world (≙ WorldEditor leaving game mode: the
        played world is destroyed and the pre-play blob is loaded into a
        fresh one, world_editor.cpp:2290-2302). Every world-bound view and
        the undo stack are dropped — they rebuild lazily on next use."""
        self.world = new_world
        self.stack = CommandStack(new_world)
        self.sel = 0
        self.prop_sel = 0
        self._scene_view = None
        self._anim_editor = None
        self._physics_view = None
        gv = self._game_view
        if gv is not None:
            gv.world = new_world

    # -- model ------------------------------------------------------------

    def entities(self) -> List[int]:
        w = self.world
        out = []

        def walk(e, depth):
            out.append((e, depth))
            for c in w.children_of(e):
                walk(c, depth + 1)

        roots = [e for e in sorted(w.names.keys() | set(_alive(w)))
                 if w.is_alive(e) and w.get_parent(e) < 0]
        for r in roots:
            walk(r, 0)
        return out

    def selected_entity(self) -> int:
        ents = self.entities()
        if not ents:
            return -1
        self.sel = max(0, min(self.sel, len(ents) - 1))
        return ents[self.sel][0]

    def prop_rows(self, e: int) -> List[Tuple[str, str, object]]:
        """(component, property, value) rows: transform first, then every
        reflected property of every component present on the entity."""
        if e < 0 or not self.world.is_alive(e):
            return []
        pos = np.asarray(self.world.get_local_transform(e)[0]).round(3)
        rows = [("transform", "x", float(pos[0])),
                ("transform", "y", float(pos[1])),
                ("transform", "z", float(pos[2]))]
        for ctype in reflection.registry.all_components():
            try:
                present = self.world.has_component(e, ctype)
            except KeyError:
                present = False
            if not present:
                continue
            cd = reflection.registry.component(ctype)
            for pname in (cd.properties if cd else {}):
                try:
                    v = reflection.registry.get_property(
                        self.world, e, ctype, pname)
                except Exception:
                    continue
                if isinstance(v, np.ndarray):
                    if v.size > 4:
                        continue
                    v = np.asarray(v).round(3).tolist()
                rows.append((ctype, pname, v))
        return rows

    # -- key state machine --------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        if self.view != "main":
            view_obj = {"assets": self.asset_browser,
                        "profiler": self.profiler_ui,
                        "scene": self.scene_view,
                        "anim": self.anim_editor,
                        "particles": self.particle_editor,
                        "physics": self.physics_view,
                        "game": self.game_view,
                        "material": self.material_editor,
                        "voxelizer": self.voxelizer,
                        "log": self.log_ui,
                        "settings": self.settings_ui,
                        "spline": self.spline_editor,
                        "meta": self.meta_editor}[self.view]()
            # 'q' quits only when the sub-editor is NOT in a text-edit
            # state — typing a .pat line containing 'q' ("quad", "sq")
            # must insert the character, not drop unsaved edits
            # (ADVICE-r4 medium)
            editing = getattr(view_obj, "edit", None) is not None
            if code == 27 and not editing:   # esc returns to the main view
                self.view = "main"
                self.status = "main view"
            elif (text.lower() == "q" and self.view != "assets"
                  and not editing):
                self.quit_requested = True
            elif text == "D" and self.view != "assets" and not editing:
                self._cycle_dock()
            else:
                view_obj.handle_key(code, text)
                # '@' on a model in the asset browser opens the meta editor
                # (≙ the reference import UI opening from the browser)
                req = getattr(view_obj, "meta_request", None)
                if self.view == "assets" and req:
                    view_obj.meta_request = None
                    from lumixengine_tpu_torch.editor.meta_editor import MetaEditor

                    self._meta_editor = MetaEditor(
                        req, compiler=getattr(view_obj, "compiler", None))
                    self.view = "meta"
                    self.status = f"meta editor: {req}"
            return
        if self.edit is None and text in ("1", "2", "3", "4", "5", "6", "7",
                                          "8", "9", "0", ",", "."):
            target = {"1": "log", "2": "assets", "3": "profiler",
                      "4": "scene", "5": "anim", "6": "particles",
                      "7": "physics", "8": "game", "9": "material",
                      "0": "voxelizer", ",": "settings", ".": "spline"}[text]
            if target in ("anim", "particles", "physics", "material",
                          "voxelizer", "spline"):
                try:
                    getattr(self, {"anim": "anim_editor",
                                   "particles": "particle_editor",
                                   "physics": "physics_view",
                                   "material": "material_editor",
                                   "voxelizer": "voxelizer",
                                   "spline": "spline_editor"}[target])()
                except ValueError as exc:
                    self.status = str(exc)
                    return
            self.view = target
            if self.view == "profiler":
                self.profiler_ui().snapshot()
            self.status = f"{self.view} view (esc returns)"
            return
        if self.edit is not None:
            if code == 13:                       # commit
                self._commit_edit()
            elif code == 27:                     # esc
                self.edit = None
                self.status = "edit cancelled"
            elif code == 8:                      # backspace
                self.edit = self.edit[:-1]
            elif text and (text.isdigit() or text in ".-+e"):
                self.edit += text
            return
        ch = text.lower()
        if ch == "q":
            self.quit_requested = True
        elif code == _UP:
            if self.panel == "tree":
                self.sel = max(self.sel - 1, 0)
            else:
                self.prop_sel = max(self.prop_sel - 1, 0)
        elif code == _DOWN:
            if self.panel == "tree":
                self.sel += 1
                self.selected_entity()
            else:
                self.prop_sel += 1
        elif code == 9:                          # tab
            self.panel = "props" if self.panel == "tree" else "tree"
        elif code == 13 and self.panel == "props":
            self.edit = ""
            self.status = "editing — type value, enter commits"
        elif ch == "u":
            self.stack.undo()
            self.status = "undo"
        elif ch == "y":
            self.stack.redo()
            self.status = "redo"
        elif ch == "n":
            self.stack.execute(CreateEntityCommand(name="new entity"))
            self.status = "entity created"
        elif ch == "x":
            e = self.selected_entity()
            if e >= 0:
                self.stack.execute(DestroyEntitiesCommand([e]))
                self.status = f"destroyed entity {e}"
        elif ch == "s":
            self.save()
        elif text == "p":
            # save the selected entity's subtree as a .fab prefab
            # (≙ prefab_system.cpp savePrefab over WorldEditor selection)
            e = self.selected_entity()
            if e >= 0:
                from lumixengine_tpu_torch.engine.serialize import make_prefab

                import os as _os

                name = (self.world.get_entity_name(e) or f"entity{e}"
                        ).replace(" ", "_").replace("/", "_")
                path = _os.path.join(
                    getattr(self.engine.fs, "base_path", "."),
                    f"{name}.fab")
                with open(path, "wb") as f:
                    f.write(make_prefab(self.world, [e]))
                self._last_prefab = path
                self.status = f"prefab saved: {path}"
        elif text == "P":
            # instantiate the last saved/loaded prefab next to the selection
            # (≙ PrefabSystem::instantiatePrefab, undoable)
            path = getattr(self, "_last_prefab", None)
            if path is None:
                fabs = [a.full for a in self.asset_browser().entries
                        if a.type == "prefab"]
                path = fabs[0] if fabs else None
            if path is None:
                self.status = "no prefab saved yet ('p' saves the selection)"
            else:
                from lumixengine_tpu_torch.editor.commands import \
                    InstantiatePrefabCommand

                e = self.selected_entity()
                pos = (np.asarray(self.world.get_local_transform(e)[0])
                       + [2.0, 0.0, 0.0]).tolist() if e >= 0 else None
                with open(path, "rb") as f:
                    blob = f.read()
                cmd = InstantiatePrefabCommand(blob, position=pos)
                self.stack.execute(cmd)
                self.status = (f"prefab {path}: {len(cmd.created)} "
                               "entities instantiated")
        elif text == "D":
            self._cycle_dock()
        elif ch == "c" and self.panel == "props":
            # signal event/function rows cycle through the reflection
            # registry's known pairs (≙ signal_editor.cpp:1-73's Event and
            # Function combos — the only editor for these string pairs)
            ent = self.selected_entity()
            rows = self.prop_rows(ent)
            if rows and self.prop_sel < len(rows):
                ctype, pname, _ = rows[self.prop_sel]
                if ctype == "signal" and pname in ("event", "function"):
                    self._cycle_signal(ent, pname)

    def meta_editor(self):
        if self._meta_editor is None:
            raise ValueError("open a model's meta from the asset browser "
                             "('@' on a model entry)")
        return self._meta_editor

    def _cycle_dock(self) -> None:
        """'D' cycles the docked bottom pane: off → log → profiler → scene
        (≙ dragging a second window into the dockspace)."""
        order = [None, "log", "profiler", "scene"]
        i = order.index(self.dock) if self.dock in order else 0
        self.dock = order[(i + 1) % len(order)]
        if self.dock == "profiler":
            self.profiler_ui().snapshot()
        self.status = (f"docked: {self.dock}" if self.dock
                       else "dock closed")

    def _cycle_signal(self, ent: int, which: str) -> None:
        reg = reflection.registry
        pairs = (reg.all_events() if which == "event"
                 else reg.all_functions())
        if not pairs:
            self.status = f"no reflected {which}s registered"
            return
        scope_prop = f"{which}_component"
        cur = (reg.get_property(self.world, ent, "signal", scope_prop),
               reg.get_property(self.world, ent, "signal", which))
        try:
            i = (pairs.index(cur) + 1) % len(pairs)
        except ValueError:
            i = 0
        scope, name = pairs[i]
        self.stack.execute(SetPropertyCommand(ent, "signal", scope_prop,
                                              scope))
        self.stack.execute(SetPropertyCommand(ent, "signal", which, name))
        self.status = f"signal {which} → {scope}::{name}"

    def _commit_edit(self) -> None:
        e = self.selected_entity()
        rows = self.prop_rows(e)
        buf, self.edit = self.edit, None
        if not rows or not buf:
            return
        self.prop_sel = min(self.prop_sel, len(rows) - 1)
        ctype, pname, old = rows[self.prop_sel]
        try:
            value = float(buf)
        except ValueError:
            self.status = f"not a number: {buf!r}"
            return
        if ctype == "transform":
            pos = np.asarray(self.world.get_local_transform(e)[0],
                             np.float32).copy()
            pos["xyz".index(pname)] = value
            self.stack.execute(SetTransformCommand(e, position=tuple(pos)))
        else:
            self.stack.execute(SetPropertyCommand(e, ctype, pname, value))
        self.status = f"{ctype}.{pname} = {value}"

    def save(self) -> None:
        if self.scene_inst is not None and self.save_path.endswith(".unv"):
            from lumixengine_tpu_torch.importers.instantiate import save_world_unv

            save_world_unv(self.scene_inst, self.save_path)
            import os
            self.status = (f"saved {os.path.getsize(self.save_path)} bytes "
                           f"(.unv) -> {self.save_path}")
            return
        from lumixengine_tpu_torch.engine import serialize

        blob = serialize.serialize_world(self.world)
        with open(self.save_path, "wb") as f:
            f.write(blob)
        self.status = f"saved {len(blob)} bytes -> {self.save_path}"

    # -- screen -----------------------------------------------------------

    def render_text(self, width: int = 100, height: int = 28) -> str:
        """Compose the screen: the focused view, plus the docked secondary
        pane in a bottom split when one is set (≙ StudioApp docking)."""
        if self.dock is None or self.dock == self.view:
            return self._render_view(self.view, width, height)
        h1 = max(height * 2 // 3, 6)
        h2 = max(height - h1 - 1, 3)
        try:
            bottom = self._render_view(self.dock, width, h2)
        except Exception as exc:    # a broken dock view must not kill the UI
            bottom = f"[dock {self.dock} error: {exc}]".ljust(width)[:width]
        return "\n".join([self._render_view(self.view, width, h1),
                          ("─" * width)[:width], bottom])

    def _render_view(self, view: str, width: int, height: int) -> str:
        if view == "assets":
            return self.asset_browser().render_text(width, height)
        if view == "profiler":
            return self.profiler_ui().render_text(width, height)
        if view == "anim":
            ae = self.anim_editor()
            ae.step_preview()
            return ae.render_text(width, height)
        if view == "particles":
            return self.particle_editor().render_text(width, height)
        if view == "physics":
            return self.physics_view().render_text(width, height)
        if view == "game":
            return self.game_view().render_text(width, height)
        if view == "material":
            return self.material_editor().render_text(width, height)
        if view == "voxelizer":
            return self.voxelizer().render_text(width, height)
        if view == "log":
            return self.log_ui().render_text(width, height)
        if view == "settings":
            return self.settings_ui().render_text(width, height)
        if view == "spline":
            return self.spline_editor().render_text(width, height)
        if view == "meta":
            return self.meta_editor().render_text(width, height)
        if view == "scene":
            sv = self.scene_view()
            # world edits since the last scene frame → re-upload host state
            n = len(self.stack._undo)
            if getattr(self, "_scene_synced_undo", -1) != n:
                sv.mark_dirty()
                self._scene_synced_undo = n
            return sv.render_text(width, height)
        ents = self.entities()
        e = self.selected_entity()
        rows = self.prop_rows(e)
        self.prop_sel = max(0, min(self.prop_sel,
                                   max(len(rows) - 1, 0)))
        left_w = max(30, width // 3)
        body = height - 3
        # windowed scrolling around the selections
        t0 = max(0, self.sel - body + 1)
        p0 = max(0, self.prop_sel - body + 1)
        lines = [f"lumixengine_tpu editor — {len(ents)} entities "
                 f"[{'TREE' if self.panel == 'tree' else 'PROPS'}]"
                 .ljust(width)[:width]]
        for r in range(body):
            ti = t0 + r
            if ti < len(ents):
                ent, depth = ents[ti]
                name = self.world.get_entity_name(ent) or f"entity {ent}"
                mark = ">" if ti == self.sel else " "
                lt = f"{mark}{'  ' * depth}{name} ({ent})"
            else:
                lt = ""
            pi = p0 + r
            if pi < len(rows):
                ct, pn, v = rows[pi]
                cur = (self.panel == "props" and pi == self.prop_sel)
                mark = ">" if cur else " "
                val = (self.edit + "_") if (cur and self.edit is not None) \
                    else str(v)
                rt = f"{mark}{ct}.{pn} = {val}"
            else:
                rt = ""
            lines.append((lt.ljust(left_w)[:left_w] + "| "
                          + rt)[:width].ljust(width))
        undo = len(self.stack._undo)
        lines.append(("-" * width))
        lines.append(f"[{self.status}]  undo:{undo}  "
                     "keys: tab panel · enter edit · u undo · y redo · "
                     "n new · x del · s save · q quit"[:width].ljust(width))
        return "\n".join(lines[:height])

    # -- interactive loop ----------------------------------------------------

    def run(self, max_frames: int = 10 ** 9) -> None:
        import time

        from lumixengine_tpu_torch.core.os import EventType
        from lumixengine_tpu_torch.core.os_terminal import TerminalWindowBackend

        be = TerminalWindowBackend()
        with be:
            for _ in range(max_frames):
                for ev in be.poll():
                    if ev.type == EventType.KEY and ev.down:
                        self.handle_key(ev.keycode)
                    elif ev.type == EventType.TEXT_INPUT:
                        self.handle_key(0, ev.text)
                    elif ev.type == EventType.QUIT:
                        self.quit_requested = True
                cols, rows = be.term_size()
                be.out.write("\x1b[H" + self.render_text(cols, rows))
                be.out.flush()
                if self.quit_requested:
                    break
                time.sleep(1 / 30)


def _alive(world) -> List[int]:
    return [e for e in range(world.capacity) if world.is_alive(e)]


def open_world(world_path: Optional[str] = None, device="cuda",
               settings_path: str = ".lumix_editor.ini",
               data_dirs: Optional[Tuple[str, ...]] = None) -> EditorApp:
    """The editor `main` opens: a `.unv` world through the importer (saved
    back as `.unv` to ``world_edited.unv``), else the headless demo world
    (256 entities), its engine on `device`."""
    device = torch.device(device)
    if world_path:
        from lumixengine_tpu_torch.importers.instantiate import load_world

        inst = load_world(world_path, device=device)
        engine, world = inst.engine, inst.world
    else:
        from lumixengine_tpu_torch.models import demo_scenes

        engine, world, _ = demo_scenes.headless_demo_world(num_entities=256)
        engine.device = device
        inst = None
    app = EditorApp(engine, world, settings_path=settings_path,
                    data_dirs=data_dirs)
    if inst is not None:
        app.scene_inst = inst
        app.save_path = "world_edited.unv"
    return app


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    args = argv if argv is not None else sys.argv[1:]
    world_path = None
    device = "cuda"
    for i, a in enumerate(args):
        if a in ("--world", "-world") and i + 1 < len(args):
            world_path = args[i + 1]
        elif a in ("--device", "-device") and i + 1 < len(args):
            device = args[i + 1]
    open_world(world_path, device).run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

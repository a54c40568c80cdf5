"""GUI module (≙ reference src/gui: retained canvas of Rect/Image/Text/Button/
InputField components, anchor-based layout, rendered via Draw2D into the
pipeline's post-tonemap pass — gui_module.h, gui_system.cpp).

TPU re-architecture: rect layout is data-parallel — every GUI rect stores
(anchor, offset) pairs for left/top/right/bottom relative to its parent rect;
resolution is the same level-scan as the transform hierarchy, over [4, K]
resolved-rect rows with a static per-level plan (rect parent = nearest
ancestor entity owning a rect, computed host-side). Hit tests (hover/click)
are one batched point-vs-rect pass against the frame's pointer state. The
module's output is the Draw2D payload: resolved rects + colors + sprite/text
ids, consumed by a 2D renderer.

The port's counterpart of ``lumixengine_tpu/gui/module.py``: the layout and
hit test work on tensors with an optional leading world axis; focus, text
editing and the draw list are the same host code.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.utils.store import DenseStore


@dataclass
class GuiState:
    resolved: torch.Tensor    # f32 [4, K] x0,y0,x1,y1 (canvas pixels)
    hovered: torch.Tensor     # bool [K]
    clicked: torch.Tensor     # bool [K] (this frame)
    enabled: torch.Tensor     # bool [K] per-rect enable (scripts toggle it)
    pointer: torch.Tensor     # f32 [2] mouse x,y (data, injected per frame)
    pointer_down: torch.Tensor  # bool []
    prev_down: torch.Tensor     # bool []
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "GuiState":
        return dataclasses.replace(self, **kw)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class GuiModule(IModule):
    name = "gui"
    COMPONENT_STORES = {"gui_rect": "rects", "gui_image": "images",
                        "gui_button": "buttons"}

    def __init__(self, world: World, system: "GuiSystem", max_rects: int = 256,
                 canvas_size: Tuple[int, int] = (1920, 1080)):
        super().__init__(world, system)
        self.canvas_size = canvas_size
        self.rects = DenseStore(
            max_rects,
            {
                # (anchor in [0,1] of parent span, pixel offset) per edge —
                # ≙ gui_module.h Rect {*_points, *_relative}
                "anchor": ((4,), np.float32, (0.0, 0.0, 1.0, 1.0)),  # l,t,r,b
                "offset": ((4,), np.float32, 0.0),
                "enabled": ((), np.bool_, True),
            },
        )
        self.images = DenseStore(max_rects, {"color": ((4,), np.float32, 1.0),
                                             "sprite": ((), np.int32, -1)})
        self.buttons = DenseStore(max_rects, {
            "normal_color": ((4,), np.float32, 1.0),
            "hovered_color": ((4,), np.float32, 0.8),
        })
        self.texts: Dict[int, dict] = {}   # entity -> {text, font_size, color, align}
        self.input_fields: Dict[int, dict] = {}  # entity -> {text, caret, font_size}
        self.render_targets: Dict[int, dict] = {}
        self.focused: int = -1             # entity of the focused input field
        self._statics = None
        self._statics_version = -1
        # host-side press-edge tracking: a click edge can only exist in a
        # device state computed AFTER inject_pointer(down=True) on a frame
        # where the pointer was up — lets pump_signals() skip its device
        # readback on the (vast majority of) frames with no press
        self._host_down = False
        self._press_pending = False
        self._click_events: List[int] = []

    def _font(self, size: int):
        return self.system.fonts.load(size=size)

    # -- components ------------------------------------------------------------

    def component_types(self):
        return ["gui_rect", "gui_image", "gui_text", "gui_button",
                "gui_input_field", "gui_render_target"]

    def create_component(self, entity: int, ctype: str, **props):
        self._statics = None
        if ctype == "gui_rect":
            self.rects.add(entity,
                           anchor=np.asarray(props.get("anchor", (0, 0, 1, 1)), np.float32),
                           offset=np.asarray(props.get("offset", (0, 0, 0, 0)), np.float32),
                           enabled=np.bool_(props.get("enabled", True)))
        elif ctype == "gui_image":
            self.images.add(entity, color=np.asarray(props.get("color", (1, 1, 1, 1)), np.float32),
                            sprite=np.int32(props.get("sprite", -1)))
        elif ctype == "gui_text":
            # ≙ gui_module.h Text {font, font_size, horizontal/vertical align}
            self.texts[entity] = {"text": props.get("text", ""),
                                  "font_size": props.get("font_size", 16),
                                  "color": list(props.get("color", (1, 1, 1, 1))),
                                  # 0=left/top 1=center/middle 2=right/bottom
                                  "align_h": int(props.get("align_h", 0)),
                                  "align_v": int(props.get("align_v", 0))}
        elif ctype == "gui_button":
            self.buttons.add(entity,
                             normal_color=np.asarray(props.get("normal_color", (1, 1, 1, 1)), np.float32),
                             hovered_color=np.asarray(props.get("hovered_color", (0.8, 0.8, 0.8, 1)), np.float32))
        elif ctype == "gui_input_field":
            txt = props.get("text", "")
            self.input_fields[entity] = {"text": txt, "caret": len(txt),
                                         "font_size": props.get("font_size", 16)}
        elif ctype == "gui_render_target":
            # ≙ gui_module.h RenderTarget: a rect displaying a pipeline
            # output texture; the renderer/viewer registers textures on the
            # system by id (see GuiSystem.set_render_target)
            self.render_targets[entity] = {"texture": props.get("texture", -1)}
        else:
            raise KeyError(ctype)

    def destroy_component(self, entity: int, ctype: str) -> None:
        self._statics = None
        if ctype == "gui_rect":
            self.rects.remove(entity)
        elif ctype == "gui_image":
            self.images.remove(entity)
        elif ctype == "gui_text":
            self.texts.pop(entity, None)
        elif ctype == "gui_button":
            self.buttons.remove(entity)
        elif ctype == "gui_input_field":
            self.input_fields.pop(entity, None)
            if self.focused == entity:
                self.focused = -1
        elif ctype == "gui_render_target":
            self.render_targets.pop(entity, None)

    # -- statics: rect-parent plan ------------------------------------------------

    def prepare_statics(self, device=None):
        self.world._refresh_levels()
        if self._statics is None or self._statics_version != self.world.topology_version:
            w = self.world
            # rect parent = nearest ancestor entity that owns a rect (host walk)
            slot_of = {int(self.rects.entity[s]): s for s in range(self.rects.capacity)
                       if self.rects.entity[s] >= 0}
            parent_slot = np.full(self.rects.capacity, -1, np.int32)
            depth = np.zeros(self.rects.capacity, np.int32)
            for e, s in slot_of.items():
                p = w.get_parent(e)
                while p >= 0 and p not in slot_of:
                    p = w.get_parent(p)
                if p >= 0:
                    parent_slot[s] = slot_of[p]
            # depths via chase
            for e, s in slot_of.items():
                d, ps = 0, parent_slot[s]
                while ps >= 0:
                    d += 1
                    ps = parent_slot[ps]
                depth[s] = d
            levels = []
            for d in range(1, int(depth.max(initial=0)) + 1):
                idx = np.nonzero((depth == d) & (self.rects.entity >= 0))[0].astype(np.int32)
                if idx.size:
                    levels.append((idx, parent_slot[idx]))
            self._statics = {
                "mask": self.rects.entity >= 0,
                "levels": levels,
                "anchor": np.asarray(self.rects.data["anchor"], np.float32).T.copy(),  # [4,K]
                "offset": np.asarray(self.rects.data["offset"], np.float32).T.copy(),
                "enabled": np.asarray(self.rects.data["enabled"], bool),
                "button_mask": np.isin(self.rects.entity,
                                       self.buttons.entity[self.buttons.entity >= 0]),
                "input_mask": np.isin(self.rects.entity,
                                      np.asarray(list(self.input_fields), np.int64)),
                "device": {},
            }
            self._statics_version = self.world.topology_version
        if device is not None:
            self._device_statics(torch.device(device))

    def statics(self):
        self.prepare_statics()
        return self._statics

    def _device_statics(self, device) -> dict:
        """The statics as tensors on `device`, made once per topology."""
        st = self._statics
        key = str(device)
        if key not in st["device"]:
            cw, ch = self.canvas_size
            k = self.rects.capacity

            def t(a, dtype=None):
                return torch.as_tensor(np.array(a), dtype=dtype, device=device)

            st["device"][key] = {
                "anchor": t(st["anchor"]), "offset": t(st["offset"]), "mask": t(st["mask"]),
                "clickable": t(st["button_mask"] | st["input_mask"]),
                "canvas": t(np.broadcast_to(np.asarray([0.0, 0.0, float(cw), float(ch)],
                                                       np.float32)[:, None], (4, k))),
                "canvas_size": (cw, ch),
                "levels": [(t(idx, torch.int64), t(ps, torch.int64))
                           for idx, ps in st["levels"]],
            }
        return st["device"][key]

    def device_state(self, device) -> GuiState:
        k = self.rects.capacity
        return GuiState(
            resolved=torch.zeros((4, k), dtype=torch.float32, device=device),
            enabled=torch.as_tensor(np.asarray(self.rects.data["enabled"], bool), device=device),
            hovered=torch.zeros(k, dtype=torch.bool, device=device),
            clicked=torch.zeros(k, dtype=torch.bool, device=device),
            pointer=torch.zeros(2, dtype=torch.float32, device=device),
            pointer_down=torch.zeros((), dtype=torch.bool, device=device),
            prev_down=torch.zeros((), dtype=torch.bool, device=device),
            counters={"clicks": torch.zeros((), dtype=torch.int32, device=device)},
        )

    # -- frame (≙ GUISystem::update layout + input) ---------------------------------

    def update(self, state: WorldState, dt) -> WorldState:
        gs: GuiState = state.modules[self.name]
        self.prepare_statics()
        d = self._device_statics(gs.resolved.device)
        if d["canvas_size"] != tuple(self.canvas_size):   # canvas resized since
            self._statics["device"].clear()
            d = self._device_statics(gs.resolved.device)
        anchor, offset = d["anchor"], d["offset"]    # [4,K] l,t,r,b

        # roots resolve against the canvas; deeper levels against their parents
        def resolve(parent_rect, anc, off):
            px0, py0, px1, py1 = (parent_rect[..., i, :] for i in range(4))
            pw = px1 - px0
            ph = py1 - py0
            x0 = px0 + pw * anc[..., 0, :] + off[..., 0, :]
            y0 = py0 + ph * anc[..., 1, :] + off[..., 1, :]
            x1 = px0 + pw * anc[..., 2, :] + off[..., 2, :]
            y1 = py0 + ph * anc[..., 3, :] + off[..., 3, :]
            return torch.stack([x0, y0, x1, y1], dim=-2)

        resolved = resolve(d["canvas"], anchor, offset).expand(gs.resolved.shape)
        for ji, pslots in d["levels"]:
            pr = resolved.index_select(-1, pslots)
            rr = resolve(pr, anchor.index_select(-1, ji), offset.index_select(-1, ji))
            resolved = resolved.index_copy(-1, ji, rr)

        # hit test (hover + click edge)
        mx = gs.pointer[..., 0]
        my = gs.pointer[..., 1]
        inside = ((mx[..., None] >= resolved[..., 0, :]) & (mx[..., None] <= resolved[..., 2, :])
                  & (my[..., None] >= resolved[..., 1, :]) & (my[..., None] <= resolved[..., 3, :]))
        hovered = inside & (d["mask"] & gs.enabled)
        click_edge = gs.pointer_down & ~gs.prev_down
        clicked = hovered & click_edge[..., None] & d["clickable"]

        gs = gs.replace(
            resolved=resolved.contiguous(), hovered=hovered, clicked=clicked,
            prev_down=gs.pointer_down,
            counters={"clicks": torch.sum(clicked, dim=-1, dtype=torch.int32)},
        )
        return state.replace(modules={**state.modules, self.name: gs})

    # -- host helpers -----------------------------------------------------------

    def inject_pointer(self, state: WorldState, x: float, y: float, down: bool) -> WorldState:
        if bool(down) and not self._host_down:
            self._press_pending = True     # a click edge will appear next step
        self._host_down = bool(down)
        gs: GuiState = state.modules[self.name]
        dev = gs.pointer.device
        pointer = torch.tensor([x, y], dtype=torch.float32, device=dev).expand(gs.pointer.shape)
        down_t = torch.tensor(bool(down), device=dev).expand(gs.pointer_down.shape)
        gs = gs.replace(pointer=pointer.clone(), pointer_down=down_t.clone())
        return state.replace(modules={**state.modules, self.name: gs})

    def clicked_entities(self, state: WorldState) -> List[int]:
        gs: GuiState = state.modules[self.name]
        out = []
        c = _host(gs.clicked)
        if c.ndim == 2:     # world batch: world 0
            c = c[0]
        for slot in np.nonzero(c)[0]:
            out.append(int(self.rects.entity[slot]))
        return out

    def pump_signals(self, state: WorldState) -> int:
        """Fire this frame's module-scoped events into CoreModule signals
        (≙ GUISystem's m_button_clicked delegate feeding reflected events,
        gui_module.h:153-159 + core.cpp:120-138). Call once per frame after
        update() — Runner.tick does (ADVICE-r4 medium: .unv button→script
        connections must fire during actual play, not only in tests).
        Returns the number of signal dispatches.

        Cheap on idle frames: the device readback only happens when a
        host-injected press edge is pending (clicks are press edges by
        construction — update()'s `pointer_down & ~prev_down`)."""
        core = self.world.modules.get("core")
        if core is None:
            return 0
        if not self._press_pending:
            return 0
        self._press_pending = False
        evs = [{"module": "gui", "event": "buttonClicked", "entity": e}
               for e in self.clicked_entities(state)]
        return core.dispatch_signals(evs) if evs else 0

    def process_input(self, state: WorldState, input_system) -> None:
        """Host-side focus + text editing for input fields (≙ GUISystem
        routing OS text/key events to the focused InputField,
        gui_system.cpp). Call once per frame after update()."""
        from lumixengine_tpu_torch.engine import input as inp

        clicks = self.clicked_entities(state)
        if clicks:
            focused = next((e for e in clicks if e in self.input_fields), -1)
            self.focused = focused
            if focused >= 0:
                fld = self.input_fields[focused]
                font = self._font(fld["font_size"])
                slot = self.rects.slot_of(focused)
                gs: GuiState = state.modules[self.name]
                x0 = float(_host(gs.resolved)[..., 0, slot].reshape(-1)[0])
                mx = float(_host(gs.pointer)[..., 0].reshape(-1)[0])
                fld["caret"] = font.index_at(fld["text"], mx - x0)
        if self.focused < 0 or self.focused not in self.input_fields:
            return
        fld = self.input_fields[self.focused]
        for ev in input_system.events:
            t, c = fld["text"], fld["caret"]
            if ev.type == inp.EVENT_TEXT:
                fld["text"] = t[:c] + ev.text + t[c:]
                fld["caret"] = c + len(ev.text)
            elif (ev.type == inp.EVENT_BUTTON and ev.down
                  and ev.device == inp.DEVICE_KEYBOARD):
                if ev.key_id == inp.KEY_BACKSPACE and c > 0:
                    fld["text"] = t[:c - 1] + t[c:]
                    fld["caret"] = c - 1
                elif ev.key_id == inp.KEY_DELETE and c < len(t):
                    fld["text"] = t[:c] + t[c + 1:]
                elif ev.key_id == inp.KEY_LEFT:
                    fld["caret"] = max(0, c - 1)
                elif ev.key_id == inp.KEY_RIGHT:
                    fld["caret"] = min(len(t), c + 1)
                elif ev.key_id == inp.KEY_HOME:
                    fld["caret"] = 0
                elif ev.key_id == inp.KEY_END:
                    fld["caret"] = len(t)
                elif ev.key_id == inp.KEY_RETURN:
                    self.focused = -1
                    return

    def _text_origin(self, rect, font, text, align_h, align_v):
        w, h = font.text_extents(text)
        x = [rect[0],
             (rect[0] + rect[2] - w) * 0.5,
             rect[2] - w][align_h]
        y = [rect[1],
             (rect[1] + rect[3] - h) * 0.5,
             rect[3] - h][align_v]
        return x, y

    def draw_list(self, state: WorldState) -> List[dict]:
        """The Draw2D payload (≙ gui rendered via Draw2D into the pipeline):
        rects/colors, per-glyph text quads with atlas UVs, input-field carets,
        render-target references."""
        gs: GuiState = state.modules[self.name]
        resolved = _host(gs.resolved)
        hovered = _host(gs.hovered)
        if resolved.ndim == 3:     # world batch: world 0
            resolved, hovered = resolved[0], hovered[0]
        out = []
        for slot in range(self.rects.capacity):
            e = int(self.rects.entity[slot])
            if e < 0 or not self.rects.get(e, "enabled"):
                continue
            rect = resolved[:, slot].tolist()
            item = {"entity": e, "rect": rect}
            if e in self.images:
                item["color"] = self.images.get(e, "color").tolist()
            if e in self.buttons:
                key = "hovered_color" if hovered[slot] else "normal_color"
                item["color"] = self.buttons.get(e, key).tolist()
            if e in self.texts:
                tx = self.texts[e]
                font = self._font(tx["font_size"])
                ox, oy = self._text_origin(rect, font, tx["text"],
                                           tx["align_h"], tx["align_v"])
                item["text"] = tx["text"]
                item["font_size"] = tx["font_size"]
                item["text_extents"] = font.text_extents(tx["text"])
                item["glyphs"] = font.layout(tx["text"], ox, oy)
            if e in self.input_fields:
                fld = self.input_fields[e]
                font = self._font(fld["font_size"])
                item["text"] = fld["text"]
                item["glyphs"] = font.layout(fld["text"], rect[0], rect[1])
                if e == self.focused:
                    cx = rect[0] + font.caret_x(fld["text"], fld["caret"])
                    item["caret"] = [cx, rect[1], cx + 1.0,
                                     rect[1] + font.line_height]
            if e in self.render_targets:
                item["render_target"] = self.render_targets[e]["texture"]
            out.append(item)
        return out


class GuiSystem(ISystem):
    name = "gui_system"

    def __init__(self, engine):
        super().__init__(engine)
        from lumixengine_tpu_torch.renderer.font import FontSystem
        self.fonts = FontSystem()
        # render-target textures by id (set by the renderer/viewer;
        # ≙ GUIRenderTarget textures bound at pipeline render time)
        self.render_target_textures: Dict[int, np.ndarray] = {}

    def set_render_target(self, texture_id: int, pixels: np.ndarray) -> None:
        self.render_target_textures[texture_id] = pixels

    def create_modules(self, world: World) -> GuiModule:
        caps = getattr(self.engine, "module_capacities", {})
        return GuiModule(world, self, max_rects=caps.get("gui_rects", 256))

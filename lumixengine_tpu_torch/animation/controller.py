"""Animation controller graphs (counterpart of
``lumixengine_tpu/animation/controller.py``).

A controller is a node tree compiled at build time into a function over the
whole animator batch. Value nodes evaluate to rows [..., A] of the inputs
[..., I, A]; pose nodes emit **blend slots**, a fixed-length list of
(clip_id [A], time [..., A], weight [..., A], pre-advance time [..., A]),
which the module samples and blends. Each Animation node owns a clock row
of the state [..., T, A]. Inactive Animation nodes keep advancing their
clocks while their weight is 0.

Nodes: Input, Const, Math, AnimationNode, PlayRate, Blend1D, Select and
Switch (cross-fades over ``blend_length`` seconds, tracked in state rows;
the entered child's clocks reset), Blend2D (gradient-band weights), IKNode
(FABRIK on a bone chain, applied by the module after the absolute pose)
and Layers (bone-masked layers over a base).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class ValueNode:
    """Evaluates to a float row [..., A]."""

    def eval(self, ctx) -> torch.Tensor:
        raise NotImplementedError


@dataclass
class Input(ValueNode):
    """Reads a controller input by index."""

    index: int

    def eval(self, ctx):
        return ctx.inputs[..., self.index, :]


@dataclass
class Const(ValueNode):
    value: float

    def eval(self, ctx):
        return torch.full((ctx.num_animators,), float(self.value), dtype=torch.float32,
                          device=ctx.device)


@dataclass
class Math(ValueNode):
    """MUL/DIV/ADD/SUB/CMP_*/AND/OR over two value nodes."""

    op: str
    a: ValueNode
    b: ValueNode

    _OPS = {
        "add": lambda a, b: a + b,
        "sub": lambda a, b: a - b,
        "mul": lambda a, b: a * b,
        "div": lambda a, b: a / torch.where(torch.abs(b) < 1e-12, 1e-12, b),
        "gt": lambda a, b: (a > b).to(torch.float32),
        "gte": lambda a, b: (a >= b).to(torch.float32),
        "lt": lambda a, b: (a < b).to(torch.float32),
        "lte": lambda a, b: (a <= b).to(torch.float32),
        "eq": lambda a, b: (a == b).to(torch.float32),
        "neq": lambda a, b: (a != b).to(torch.float32),
        "and": lambda a, b: ((a != 0) & (b != 0)).to(torch.float32),
        "or": lambda a, b: ((a != 0) | (b != 0)).to(torch.float32),
    }

    def eval(self, ctx):
        return self._OPS[self.op](self.a.eval(ctx), self.b.eval(ctx))


class PoseNode:
    """Emits blend slots; may own a clock row in the state."""

    def setup(self, ctrl: "Controller") -> None:
        """Allocate clock rows."""

    def advance(self, ctx) -> None:
        """Advance owned clocks by ctx.dt (scaled by play rate)."""

    def emit(self, ctx, weight: torch.Tensor) -> None:
        """Append (clip, time, weight, prev_time) slots scaled by `weight`."""
        raise NotImplementedError


@dataclass
class AnimationNode(PoseNode):
    """Plays one looping clip."""

    clip: int
    rate: Optional[ValueNode] = None
    _clock: int = field(default=-1, init=False)

    def setup(self, ctrl):
        self._clock = ctrl.alloc_clock()

    def advance(self, ctx):
        r = self.rate.eval(ctx) if self.rate is not None else 1.0
        length = float(ctx.statics.clip_length[self.clip])
        t = ctx.clocks[self._clock] + ctx.dt * r
        ctx.new_clocks[self._clock] = torch.remainder(t, length)

    def emit(self, ctx, weight):
        ctx.slots.append((
            torch.full((ctx.num_animators,), self.clip, dtype=torch.int64, device=ctx.device),
            ctx.new_clocks[self._clock],
            weight,
            ctx.clocks[self._clock],  # pre-advance clock (root-motion deltas)
        ))


@dataclass
class PlayRate(PoseNode):
    """Scales the child's clock advance."""

    rate: ValueNode
    child: PoseNode

    def setup(self, ctrl):
        # push the rate into Animation children (clocks are per-Animation)
        def push(n):
            if isinstance(n, AnimationNode):
                n.rate = self.rate if n.rate is None else Math("mul", n.rate, self.rate)
            for c in getattr(n, "children_nodes", lambda: [])():
                push(c)
        push(self.child)
        self.child.setup(ctrl)

    def advance(self, ctx):
        self.child.advance(ctx)

    def emit(self, ctx, weight):
        self.child.emit(ctx, weight)


@dataclass
class Blend1D(PoseNode):
    """Value-indexed blend over children at fixed points: hat weights, the
    value clamped to the end points."""

    value: ValueNode
    children: Sequence[Tuple[float, PoseNode]]  # (point, node), points ascending

    def children_nodes(self):
        return [c for _, c in self.children]

    def setup(self, ctrl):
        for _, c in self.children:
            c.setup(ctrl)

    def advance(self, ctx):
        for _, c in self.children:
            c.advance(ctx)

    def emit(self, ctx, weight):
        pts = np.asarray([p for p, _ in self.children], np.float32)
        x = torch.clamp(self.value.eval(ctx), float(pts[0]), float(pts[-1]))
        one, zero = torch.ones_like(x), torch.zeros_like(x)
        last = len(pts) - 1
        for i, (p, child) in enumerate(self.children):
            # hat function around point i; both branches evaluated, then selected
            left = pts[i - 1] if i > 0 else pts[0]
            right = pts[i + 1] if i < last else pts[-1]
            below = x <= float(pts[i])
            wl = torch.where(below, one if i == 0 else torch.clamp(
                (x - float(left)) / float(max(pts[i] - left, 1e-9)), 0.0, 1.0), zero)
            wr = torch.where(~below, zero if i == last else torch.clamp(
                (float(right) - x) / float(max(right - pts[i], 1e-9)), 0.0, 1.0), zero)
            child.emit(ctx, weight * torch.where(below, wl, wr))


def _collect_clocks(node) -> List[int]:
    out = []
    if isinstance(node, AnimationNode) and node._clock >= 0:
        out.append(node._clock)
    for c in getattr(node, "children_nodes", lambda: [])():
        out.extend(_collect_clocks(c))
    return out


@dataclass
class Select(PoseNode):
    """Integer-valued select with cross-fade transitions.

    State rows: current selection, previous selection, fade-elapsed
    seconds. On a change the fade restarts and the entered child's
    Animation clocks reset (the reference's enter())."""

    value: ValueNode
    children: Sequence[PoseNode]
    blend_length: float = 0.3
    _cur: int = field(default=-1, init=False)
    _prev: int = field(default=-1, init=False)
    _fade: int = field(default=-1, init=False)
    _child_clocks: list = field(default_factory=list, init=False)

    def children_nodes(self):
        return list(self.children)

    def setup(self, ctrl):
        for c in self.children:
            c.setup(ctrl)
        self._cur = ctrl.alloc_clock()
        self._prev = ctrl.alloc_clock()
        self._fade = ctrl.alloc_clock()
        self._child_clocks = [_collect_clocks(c) for c in self.children]

    def advance(self, ctx):
        for c in self.children:
            c.advance(ctx)
        v = torch.clamp(torch.round(self.value.eval(ctx)).to(torch.float32), 0,
                        len(self.children) - 1)
        cur = ctx.clocks[self._cur]
        changed = v != cur
        ctx.new_clocks[self._prev] = torch.where(changed, cur, ctx.clocks[self._prev])
        ctx.new_clocks[self._cur] = v
        ctx.new_clocks[self._fade] = torch.where(changed, 0.0, ctx.clocks[self._fade] + ctx.dt)
        # enter(): the subtree that just became current restarts its clocks
        for i, clocks in enumerate(self._child_clocks):
            entered = changed & (v == i)
            for ci in clocks:
                ctx.new_clocks[ci] = torch.where(entered, 0.0, ctx.new_clocks[ci])

    def emit(self, ctx, weight):
        cur = ctx.new_clocks[self._cur]
        prev = ctx.new_clocks[self._prev]
        if self.blend_length > 0:
            f = torch.clamp(ctx.new_clocks[self._fade] / self.blend_length, 0.0, 1.0)
        else:
            f = torch.ones(ctx.num_animators, dtype=torch.float32, device=ctx.device)
        for i, c in enumerate(self.children):
            w = (cur == i).to(torch.float32) * f + (prev == i).to(torch.float32) * (1.0 - f)
            c.emit(ctx, weight * w)


@dataclass
class Switch(PoseNode):
    """Boolean switch: a Select over (on_false, on_true) by cond != 0."""

    cond: ValueNode
    on_true: PoseNode
    on_false: PoseNode
    blend_length: float = 0.3
    _sel: object = field(default=None, init=False)

    def children_nodes(self):
        return [self.on_true, self.on_false]

    def setup(self, ctrl):
        self._sel = Select(Math("neq", self.cond, Const(0.0)), [self.on_false, self.on_true],
                           blend_length=self.blend_length)
        self._sel.setup(ctrl)

    def advance(self, ctx):
        self._sel.advance(ctx)

    def emit(self, ctx, weight):
        self._sel.emit(ctx, weight)


@dataclass
class Blend2D(PoseNode):
    """Children at 2D points blended by two inputs with gradient-band
    weights: w_i = min_j (1 - clamp((p - p_i)·(p_j - p_i) / |p_j - p_i|²)),
    normalized."""

    value_x: ValueNode
    value_y: ValueNode
    children: Sequence[Tuple[Tuple[float, float], PoseNode]]  # ((x, y), node)

    def children_nodes(self):
        return [c for _, c in self.children]

    def setup(self, ctrl):
        for _, c in self.children:
            c.setup(ctrl)

    def advance(self, ctx):
        for _, c in self.children:
            c.advance(ctx)

    def emit(self, ctx, weight):
        px = self.value_x.eval(ctx)
        py = self.value_y.eval(ctx)
        pts = np.asarray([p for p, _ in self.children], np.float32)  # [C, 2]
        ws = []
        for i in range(len(pts)):
            wi = None
            dx_i = px - float(pts[i, 0])
            dy_i = py - float(pts[i, 1])
            for j in range(len(pts)):
                if i == j:
                    continue
                ex = pts[j, 0] - pts[i, 0]
                ey = pts[j, 1] - pts[i, 1]
                denom = max(ex * ex + ey * ey, np.float32(1e-9))
                h = torch.clamp(1.0 - (dx_i * float(ex) + dy_i * float(ey)) / float(denom),
                                0.0, 1.0)
                wi = h if wi is None else torch.minimum(wi, h)
            ws.append(wi if wi is not None else torch.ones_like(px))
        total = sum(ws) + 1e-9
        for (_pt, child), w in zip(self.children, ws):
            child.emit(ctx, weight * w / total)


@dataclass
class IKNode(PoseNode):
    """FABRIK toward a target read from 3 controller inputs, alpha-blended:
    emits the child's slots and registers an IK request that the module
    applies after compute_absolute."""

    child: PoseNode
    chain: Sequence[int]                 # bone indices, root → effector
    target_inputs: Tuple[int, int, int]  # input rows of the target's x, y, z
    alpha: object = 1.0                  # a float, or an int = an input row

    def children_nodes(self):
        return [self.child]

    def setup(self, ctrl):
        self.child.setup(ctrl)
        ctrl.ik_requests.append(self)

    def advance(self, ctx):
        self.child.advance(ctx)

    def emit(self, ctx, weight):
        self.child.emit(ctx, weight)


@dataclass
class Layers(PoseNode):
    """A base layer blended over by weighted layers, each with an optional
    bone mask [B]: the slots a layer emits carry its mask, and the module
    blends them with ops/pose.masked_blend in emission order."""

    layers: Sequence[Tuple[PoseNode, Optional[np.ndarray], float]]  # (node, bone mask, weight)
    _masks: dict = field(default_factory=dict, init=False)

    def children_nodes(self):
        return [n for n, _, _ in self.layers]

    def setup(self, ctrl):
        for n, _mask, _w in self.layers:
            n.setup(ctrl)

    def advance(self, ctx):
        for n, _, _ in self.layers:
            n.advance(ctx)

    def _mask(self, i, mask, device):
        key = (i, str(device))
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(np.asarray(mask, bool), device=device)
        return self._masks[key]

    def emit(self, ctx, weight):
        for i, (n, mask, w) in enumerate(self.layers):
            start = len(ctx.slots)
            n.emit(ctx, weight * float(np.float32(w)))
            if mask is not None:
                for s in range(start, len(ctx.slots)):
                    ctx.slot_masks[s] = self._mask(i, mask, ctx.device)


class _Ctx:
    def __init__(self, controller, inputs, clocks, dt, statics):
        self.inputs = inputs
        self.clocks = clocks
        self.new_clocks = list(clocks)
        self.dt = dt
        self.statics = statics
        self.device = inputs.device
        self.num_animators = inputs.shape[-1]
        self.slots: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = []
        self.slot_masks: Dict[int, torch.Tensor] = {}


class Controller:
    """Named inputs + a root pose node.

    ``eval(inputs [..., I, A], clocks [..., T, A], dt) → (slots, slot_masks,
    new_clocks [..., T, A])``."""

    def __init__(self, name: str, statics, root: PoseNode, inputs: Sequence[str] = ()):
        self.name = name
        self.statics = statics  # ClipBankStatics
        self.root = root
        self.input_names = list(inputs)
        self._num_clocks = 0
        self.ik_requests: List[IKNode] = []  # filled by IKNode.setup
        root.setup(self)

    def alloc_clock(self) -> int:
        i = self._num_clocks
        self._num_clocks += 1
        return i

    @property
    def num_clocks(self) -> int:
        return self._num_clocks

    @property
    def num_inputs(self) -> int:
        return len(self.input_names)

    def input_index(self, name: str) -> int:
        return self.input_names.index(name)

    def eval(self, inputs: torch.Tensor, clocks: torch.Tensor, dt):
        clock_rows = [clocks[..., i, :] for i in range(self._num_clocks)]
        ctx = _Ctx(self, inputs, clock_rows, dt, self.statics)
        self.root.advance(ctx)
        self.root.emit(ctx, torch.ones(ctx.num_animators, dtype=torch.float32,
                                       device=ctx.device))
        if ctx.new_clocks:
            new_clocks = torch.stack(torch.broadcast_tensors(*ctx.new_clocks), dim=-2)
        else:
            new_clocks = inputs.new_zeros(inputs.shape[:-2] + (0, ctx.num_animators))
        return ctx.slots, ctx.slot_masks, new_clocks

"""Animation controller graphs (counterpart of
``lumixengine_tpu/animation/controller.py``).

A controller is a node tree compiled at build time into a function over the
whole animator batch. Value nodes evaluate to rows [..., A] of the inputs
[..., I, A]; pose nodes emit **blend slots**, a fixed-length list of
(clip_id [A], time [..., A], weight [..., A], pre-advance time [..., A]),
which the module samples and blends. Each Animation node owns a clock row
of the state [..., T, A]. Inactive Animation nodes keep advancing their
clocks while their weight is 0.

Ported nodes: Input, Const, Math, AnimationNode, PlayRate and Blend1D
(everything the demo's locomotion controller uses). Select, Switch,
Blend2D, IKNode and Layers raise NotImplementedError.
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


def _unported(name: str):
    class Node(PoseNode):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(f"controller node {name} is not ported")

    Node.__name__ = Node.__qualname__ = name
    return Node


Select = _unported("Select")
Switch = _unported("Switch")
Blend2D = _unported("Blend2D")
IKNode = _unported("IKNode")
Layers = _unported("Layers")


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
        self.ik_requests: list = []  # IK nodes are not ported; stays empty
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

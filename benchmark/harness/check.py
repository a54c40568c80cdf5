"""Whether what the window produced is correct: the program's states held
to the plain reference (``benchmark/reference``), which builds the scene
anew from the same recipe and seed, apart from the program's code, and runs
in float32 with TF32 off on the same device.

A frame depends on the one before it and the rigid bodies' contacts are
chaotic, so over hundreds of frames two sound float32 implementations part.
The reference therefore follows the program step by step where it must:

* ``start``: the replicated start state, the program's against the
  reference's own, on SAMPLE worlds drawn from the seed;
* ``first``: the first frame from each side's own start, on those worlds:
  every layer of the frame from scratch;
* ``last``: the window's last frame, in every world, the reference stepping
  from the program's own state before it (its transforms, clocks, bodies,
  impulses and particles: the program's outputs of the frame before).

Each group of outputs gives one number, its largest gap over the stages
and worlds, which is held to the configuration's limit for it; the
decisions (what is visible, at which LOD, which particle is alive) are
compared exactly, away from the cull's thresholds.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch

from benchmark.harness import scene as scenes
from benchmark.harness import tree
from benchmark.reference import model, recipe

SAMPLE = 16     # worlds of the start and the first frame held to the reference
MARGIN = 1e-4   # cull decisions this close to their threshold may flip between two float32 paths
BLOCK_BYTES = 2 << 30  # the reference steps the last frame in blocks of worlds of about this size

CONTINUOUS = {
    "transform": ("local.pos", "local.rot", "local.scale", "world.pos", "world.rot",
                  "world.scale", "modules.renderer.prev_pos", "modules.renderer.prev_rot"),
    "body": ("modules.physics.pos", "modules.physics.rot", "modules.physics.vel",
             "modules.physics.angvel"),
    "lambda": ("modules.physics.lam_n", "modules.physics.lam_t1", "modules.physics.lam_t2"),
    "pose": ("modules.animation.pose_pos", "modules.animation.pose_rot",
             "modules.animation.palette"),
    "clock": ("modules.animation.an_time", "modules.animation.ctrl_clocks", "time"),
}
CULL = ("modules.renderer.mi_visible", "modules.renderer.mi_lod", "modules.renderer.pl_visible")
PARTICLES = "modules.renderer.particles."


def sample_rows(worlds: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(scenes.seed_of(seed) ^ 0x5EED)
    return torch.randperm(worlds, generator=g)[:min(SAMPLE, worlds)].sort().values


def _per_world(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).amax(dim=1) if x[0].numel() else x.new_zeros(x.shape[0])


def _merge(out: dict, group: str, v: torch.Tensor) -> None:
    v = v.to(torch.float64)
    out[group] = torch.maximum(out[group], v) if group in out else v


def world_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               margins=None) -> Dict[str, torch.Tensor]:
    """group -> [B] float64: each world's largest absolute gap in the group's
    fields (the particles' channels over the slots alive on both sides), and
    for "decisions" its count of differing decisions: the cull's visibility,
    LOD and lights (only those away from MARGIN of their threshold where
    `margins`, the reference's, are given) and the particles' alive masks.
    A field the program lacks raises."""
    out: dict = {}
    for group, names in CONTINUOUS.items():
        for name in names:
            if name in ref:
                _merge(out, group, _per_world((got[name].float() - ref[name].float()).abs()))
    for i, name in enumerate(CULL):
        if name in ref:
            off = got[name] != ref[name]
            if margins is not None:
                off &= margins[i].abs() >= MARGIN
            _merge(out, "decisions", off.reshape(off.shape[0], -1).sum(dim=1))
    for name in (n for n in ref if n.startswith(PARTICLES) and n.endswith(".alive")):
        base = name[: -len(".alive")]
        both = got[name] & ref[name]
        flips = (got[name] != ref[name]).sum(dim=-1).to(torch.float64)
        out["decisions"] = out["decisions"] + flips if "decisions" in out else flips
        for f in ("channels", "outs"):
            d = (got[f"{base}.{f}"] - ref[f"{base}.{f}"]).abs()
            _merge(out, "particle", _per_world(torch.where(both[:, None], d, 0.0)))
    return out


def lower_precision(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every float32 tensor rounded to bfloat16: the control's precision."""
    return tree.apply(lambda t: t.to(torch.bfloat16).to(torch.float32)
                      if t.dtype == torch.float32 else t, leaves)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's matrix products, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Reference:
    """The plain reference's scene, built from the recipe and seed."""

    def __init__(self, config: dict, seed: int, device):
        self.model = model.Model(recipe.build(config, scenes.seed_of(seed)), device)
        self.device = torch.device(device)

    def start(self, worlds: int, seed: int, rows: torch.Tensor, lower: bool = False):
        """The reference's start state, worlds `rows`."""
        gen = torch.Generator(device=self.device).manual_seed(scenes.seed_of(seed))
        with float32_exact():
            out = self.model.start(worlds, gen, rows)
        return lower_precision(out) if lower else out

    def frame(self, leaves, dt: float, lower: bool = False):
        """One frame from `leaves` (a flat batched state): (the flat state
        after it, its cull margins). With `lower`, the control: the state
        held in bfloat16 before and after the frame."""
        leaves = {k: leaves[k] for k in self.model.names}
        with float32_exact():
            out = self.model.frame(lower_precision(leaves) if lower else leaves, dt)
            margins = self.model.margins(out)
        return (lower_precision(out) if lower else out), margins


def block_worlds(leaves: Dict[str, torch.Tensor]) -> int:
    worlds = next(iter(leaves.values())).shape[0]
    per_world = max(1, tree.nbytes(leaves) // max(worlds, 1))
    return max(1, min(worlds, BLOCK_BYTES // per_world))


def stages(ref: Reference, run, dt: float, lower: bool = False):
    """Yields (stage, world gaps) for the three stages. `run` holds the
    program's readings: `worlds`, `seed`, `rows`, `start` and `first` (flat,
    worlds `rows`), `prev` and `last` (flat, every world). With `lower` the
    control stands in the program's place and the reference is held to
    itself in bfloat16."""
    start = ref.start(run.worlds, run.seed, run.rows)
    got = ref.start(run.worlds, run.seed, run.rows, lower=True) if lower else run.start
    yield "start", world_gaps(got, start)
    first, margins = ref.frame(start, dt)
    got = ref.frame(start, dt, lower=True)[0] if lower else run.first
    yield "first", world_gaps(got, first, margins)
    del start, first, got
    step = block_worlds(run.prev)
    parts = []
    for a in range(0, run.worlds, step):
        b = min(a + step, run.worlds)
        prev = tree.block(run.prev, a, b)
        want, margins = ref.frame(prev, dt)
        got = ref.frame(prev, dt, lower=True)[0] if lower else tree.block(run.last, a, b)
        parts.append(world_gaps(got, want, margins))
    yield "last", {g: torch.cat([p[g] for p in parts]) for g in parts[0]}


def _worse(a: Optional[float], b: float) -> float:
    if a is None or math.isnan(b):
        return b
    return a if math.isnan(a) else max(a, b)


def verdict(stage_gaps, limits: Dict[str, float], log=None):
    """(numbers {group: largest gap}, world-frames compared, world-frames
    that broke a limit); `log` is given each stage's largest gaps. A group
    without a limit raises: the configuration must give one for every
    output its scene has."""
    numbers: Dict[str, float] = {}
    attempted = failed = 0
    for stage, gaps in stage_gaps:
        if log is not None:
            log(f"stage {stage}: " + ", ".join(f"{g} {float(v.max())!r}" for g, v in gaps.items()))
        missing = sorted(set(gaps) - set(limits))
        if missing:
            raise KeyError(f"the configuration gives no limit for {missing}")
        broke: Optional[torch.Tensor] = None
        for group, g in gaps.items():
            numbers[group] = _worse(numbers.get(group), float(g.max()))
            over = ~(g <= limits[group])
            broke = over if broke is None else broke | over
        attempted += int(broke.numel())
        failed += int(broke.sum())
    return numbers, attempted, failed

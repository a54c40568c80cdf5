"""A cell's scene, built through the port (the system under test) from the
configuration's recipe and the seed: the scene builder and its arguments,
then the world replicated to W worlds with per-world noise from a generator
seeded the same. The plain reference builds its own from the same recipe
and seed (``benchmark/reference/recipe.py``)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

PROGRAM = "lumixengine_tpu_torch"


def seed_of(seed: int) -> int:
    """The run's seed as the unsigned 64-bit number numpy and torch take."""
    return int(seed) % 2 ** 64


@dataclass
class Scene:
    engine: object
    world: object
    device: torch.device

    @property
    def renderer(self):
        return self.world.modules["renderer"]

    def start(self, worlds: int, seed: int):
        """The world's state replicated to `worlds` worlds; the noise comes
        from a generator on the device seeded with `seed`."""
        mesh = importlib.import_module(f"{PROGRAM}.parallel.mesh")
        gen = torch.Generator(device=self.device).manual_seed(seed_of(seed))
        return mesh.replicate_state(self.world.device_state(self.device), worlds, gen)

    def build_step(self):
        """The engine's frame step with the cull pass on camera 0."""
        return self.engine.build_step(self.world, self.device, extra=self.renderer.cull_pass)


def build(config: dict, seed: int, device) -> Scene:
    """The configuration's scene through the port: its ``builder`` (a
    function of the package, by dotted path) called with its ``args`` and
    the seed."""
    path, fn = config["builder"].rsplit(".", 1)
    builder = getattr(importlib.import_module(f"{PROGRAM}.{path}"), fn)
    built = builder(**config["args"], seed=seed_of(seed))
    return Scene(built[0], built[1], torch.device(device))

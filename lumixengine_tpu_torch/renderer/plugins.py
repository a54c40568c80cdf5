"""The builtin RenderPlugins (counterpart of
``lumixengine_tpu/renderer/plugins.py``): Atmo, CubemapSky, SSAO, TDAO,
SSS, TAA, DOF, Bloom, FilmGrain and FSR3. Each records an OP_DISPATCH into
the frame's DrawStream at the reference's hook point, its parameters in the
command; the software backend (``gpu_soft.py``) runs the named pass of
``postprocess.py`` on the card.
"""
from __future__ import annotations

from lumixengine_tpu_torch.renderer.draw_stream import OP_DISPATCH, RenderPlugin


class AtmoPlugin(RenderPlugin):
    """Analytic atmosphere and aerial perspective."""

    def __init__(self, fog_strength: float = 1.0):
        self.fog_strength = fog_strength

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="atmo", fog=self.fog_strength)


class CubemapSkyPlugin(RenderPlugin):
    """Sky sampled from a cubemap (the procedural default when none is bound)."""

    def __init__(self, faces=None):
        self.faces = faces

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="cubemap_sky", faces=self.faces)


class SSAOPlugin(RenderPlugin):
    """Depth-buffer ambient obscurance multiplied into the colour."""

    def __init__(self, radius: float = 0.8, strength: float = 1.0):
        self.radius = radius
        self.strength = strength

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="ssao",
                    radius=self.radius, strength=self.strength)


class TDAOPlugin(RenderPlugin):
    """Top-down ambient occlusion from the scene's geometry tops."""

    def __init__(self, strength: float = 0.7):
        self.strength = strength

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="tdao", strength=self.strength)


class SSSPlugin(RenderPlugin):
    """Screen-space contact shadows along the sun direction."""

    def __init__(self, steps: int = 8, shadow: float = 0.45):
        self.steps = steps
        self.shadow = shadow

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="sss",
                    steps=self.steps, shadow=self.shadow)


class TAAPlugin(RenderPlugin):
    """Temporal history blend with a neighbourhood clamp."""

    def __init__(self, alpha: float = 0.15):
        self.alpha = alpha

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="taa", alpha=self.alpha)


class BloomPlugin(RenderPlugin):
    """Bright-pass mip chain added back before the tonemap."""

    def __init__(self, threshold: float = 0.85, intensity: float = 0.6):
        self.threshold = threshold
        self.intensity = intensity

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="bloom",
                    threshold=self.threshold, intensity=self.intensity)


class DOFPlugin(RenderPlugin):
    """Circle-of-confusion blur around a focus distance."""

    def __init__(self, focus_dist: float = 20.0, focus_range: float = 25.0):
        self.focus_dist = focus_dist
        self.focus_range = focus_range

    def render_before_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="dof",
                    focus_dist=self.focus_dist,
                    focus_range=self.focus_range)


class FilmGrainPlugin(RenderPlugin):
    """Multiplicative noise after the tonemap."""

    def __init__(self, amount: float = 0.06):
        self.amount = amount

    def render_after_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="film_grain", amount=self.amount)


class FSR3Plugin(RenderPlugin):
    """Upscale and contrast-adaptive sharpen after the tonemap."""

    def __init__(self, scale: float = 1.5, sharpness: float = 0.4):
        self.scale = scale
        self.sharpness = sharpness

    def render_after_tonemap(self, stream, view, module):
        stream.push(OP_DISPATCH, shader="fsr_upscale",
                    scale=self.scale, sharpness=self.sharpness)


#: the default registration order: the sky first, so later passes see the
#: composited colour; grain after the tonemap.
DEFAULT_PLUGINS = (AtmoPlugin, SSAOPlugin, TDAOPlugin, SSSPlugin, TAAPlugin,
                   DOFPlugin, BloomPlugin, FilmGrainPlugin)


def install_builtins(renderer_system, which=None) -> list:
    """Instantiate and register the builtin plugin set on a RendererSystem.
    Returns the instances."""
    out = []
    for cls in (which or DEFAULT_PLUGINS):
        p = cls() if isinstance(cls, type) else cls
        renderer_system.add_plugin(p)
        out.append(p)
    return out

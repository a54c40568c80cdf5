"""World states as trees of tensors: nested dataclasses and dicts whose
leaves are tensors, flattened to the dotted names the port's fields have
(``local.pos``, ``modules.physics.lam_n``,
``modules.renderer.particles.pe2.storm.channels``). The program's state and
the reference's are different classes with the same names, so they meet
here as flat dicts."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch


def _is_empty(x) -> bool:
    return x is None or (isinstance(x, tuple) and not x)


def flatten(tree, prefix: str = "", out=None) -> Dict[str, torch.Tensor]:
    """Dotted name -> tensor, in declaration and insertion order."""
    out = {} if out is None else out
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif _is_empty(tree):
        pass
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            flatten(getattr(tree, f.name), f"{prefix}.{f.name}" if prefix else f.name, out)
    else:
        raise TypeError(f"{prefix}: not a state tree ({type(tree).__name__})")
    return out


def fill(template, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    """A tree of `template`'s classes and shape whose leaves are taken from
    `leaves` by name; raises KeyError for a name `leaves` lacks."""
    if isinstance(template, torch.Tensor):
        return leaves[prefix]
    if _is_empty(template):
        return template
    if isinstance(template, dict):
        return {k: fill(v, leaves, f"{prefix}.{k}" if prefix else str(k))
                for k, v in template.items()}
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: fill(getattr(template, f.name), leaves,
                                              f"{prefix}.{f.name}" if prefix else f.name)
                                 for f in dataclasses.fields(template)})
    raise TypeError(f"{prefix}: not a state tree ({type(template).__name__})")


def apply(fn: Callable[[torch.Tensor], torch.Tensor], leaves: Dict[str, torch.Tensor]):
    return {k: fn(v) for k, v in leaves.items()}


def rows(leaves: Dict[str, torch.Tensor], index: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The worlds `index` of a world-batched flat state (copies)."""
    return {k: v.index_select(0, index.to(v.device)) for k, v in leaves.items()}


def block(leaves: Dict[str, torch.Tensor], start: int, stop: int) -> Dict[str, torch.Tensor]:
    """Worlds start..stop of a world-batched flat state (views)."""
    return {k: v[start:stop] for k, v in leaves.items()}


def nbytes(leaves: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() * v.element_size() for v in leaves.values())

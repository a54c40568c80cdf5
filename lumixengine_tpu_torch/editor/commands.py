"""WorldEditor command stack (counterpart of
``lumixengine_tpu/editor/commands.py``; ≙ reference editor/world_editor.{h,cpp} —
command-pattern undo/redo over entity/component edits).

The editor UI itself is terminal-grade, but its load-bearing runtime — the
undoable edit model the property grid/gizmo drive — lives here: every mutation
of the host World goes through a Command with execute/undo, commands merge
when the same property is dragged continuously (≙ WorldEditor command
merging), and the stack supports undo/redo cursors.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from lumixengine_tpu_torch.engine import reflection, serialize
from lumixengine_tpu_torch.engine.world import World


class Command:
    name = "command"

    def execute(self, world: World) -> None:
        raise NotImplementedError

    def undo(self, world: World) -> None:
        raise NotImplementedError

    def merge(self, other: "Command") -> bool:
        """Try absorbing a newer command (continuous gizmo/slider edits)."""
        return False


class SetPropertyCommand(Command):
    name = "set_property"

    def __init__(self, entity: int, ctype: str, prop: str, value):
        self.entity = entity
        self.ctype = ctype
        self.prop = prop
        self.value = value
        self._old = None

    def execute(self, world: World) -> None:
        self._old = reflection.registry.get_property(world, self.entity, self.ctype, self.prop)
        if hasattr(self._old, "copy"):
            self._old = self._old.copy()
        reflection.registry.set_property(world, self.entity, self.ctype, self.prop, self.value)

    def undo(self, world: World) -> None:
        reflection.registry.set_property(world, self.entity, self.ctype, self.prop, self._old)

    def merge(self, other: Command) -> bool:
        if (isinstance(other, SetPropertyCommand) and other.entity == self.entity
                and other.ctype == self.ctype and other.prop == self.prop):
            self.value = other.value  # keep the ORIGINAL old value
            return True
        return False


class SetTransformCommand(Command):
    """≙ gizmo moves (MoveEntityCommand/RotateEntityCommand family)."""

    name = "set_transform"

    def __init__(self, entity: int, position=None, rotation=None, scale=None):
        self.entity = entity
        self.new = (position, rotation, scale)
        self._old = None

    def execute(self, world: World) -> None:
        self._old = world.get_global_transform(self.entity)
        world.set_global_transform(self.entity, position=self.new[0],
                                   rotation=self.new[1], scale=self.new[2])

    def undo(self, world: World) -> None:
        p, r, s = self._old
        world.set_global_transform(self.entity, position=p, rotation=r, scale=s)

    def merge(self, other: Command) -> bool:
        if isinstance(other, SetTransformCommand) and other.entity == self.entity:
            self.new = tuple(n if n is not None else o for n, o in zip(other.new, self.new))
            return True
        return False


class CreateEntityCommand(Command):
    name = "create_entity"

    def __init__(self, position=(0.0, 0.0, 0.0), name: Optional[str] = None):
        self.position = position
        self.entity_name = name
        self.entity = -1

    def execute(self, world: World) -> None:
        self.entity = world.create_entity(position=self.position, name=self.entity_name)

    def undo(self, world: World) -> None:
        world.destroy_entity(self.entity)


class DestroyEntitiesCommand(Command):
    """≙ WorldEditor::destroyEntities — undo restores the serialized fragment
    (components, hierarchy, names) via the prefab machinery."""

    name = "destroy_entities"

    def __init__(self, entities: List[int]):
        self.entities = list(entities)
        self._blob: Optional[bytes] = None

    def execute(self, world: World) -> None:
        # capture subtree(s) incl. descendants, then destroy
        all_ids = set()
        frontier = list(self.entities)
        while frontier:
            e = frontier.pop()
            if e in all_ids:
                continue
            all_ids.add(e)
            frontier.extend(world.children_of(e))
        self._blob = serialize.serialize_world(world, entities=sorted(all_ids))
        self._ids = sorted(all_ids)
        # delete the whole subtree, children first (World.destroy_entity
        # reparents children to root per reference semantics — an editor
        # delete removes the hierarchy it captured)
        for e in sorted(all_ids, key=lambda x: -world._level[x]):
            world.destroy_entity(e)

    def undo(self, world: World) -> None:
        # restore with original ids (slots were freed by execute)
        serialize.deserialize_into(world, self._blob, keep_ids=True)


class InstantiatePrefabCommand(Command):
    """≙ editor/prefab_system.cpp InstantiatePrefabCommand:95-160 —
    spawn a prefab blob at a pose; undo destroys the spawned subtree."""

    name = "instantiate_prefab"

    def __init__(self, blob: bytes, position=None, rotation=None):
        self.blob = blob
        self.position = position
        self.rotation = rotation
        self.created: List[int] = []

    def execute(self, world: World) -> None:
        self.created = serialize.instantiate_prefab(
            world, self.blob, position=self.position, rotation=self.rotation)

    def undo(self, world: World) -> None:
        for e in sorted(self.created, key=lambda x: -world._level[x]):
            if world.alive[e]:
                world.destroy_entity(e)
        self.created = []


class SetSplinePointsCommand(Command):
    """≙ spline_editor.cpp EditorCommand:145-190 — snapshot the whole point
    array; continuous drags of the same point merge (recordUndo's id)."""

    name = "set_spline_points"

    def __init__(self, entity: int, points, merge_id: Optional[int] = None):
        self.entity = entity
        self.points = np.asarray(points, np.float32).reshape(-1, 3)
        self.merge_id = merge_id
        self._old = None

    def execute(self, world: World) -> None:
        core = world.modules["core"]
        self._old = core.splines[self.entity].copy()
        core.set_spline_points(self.entity, self.points)

    def undo(self, world: World) -> None:
        world.modules["core"].set_spline_points(self.entity, self._old)

    def merge(self, other: Command) -> bool:
        if (isinstance(other, SetSplinePointsCommand)
                and other.entity == self.entity
                and self.merge_id is not None
                and other.merge_id == self.merge_id):
            self.points = other.points     # keep the ORIGINAL old array
            return True
        return False


class AddComponentCommand(Command):
    name = "add_component"

    def __init__(self, entity: int, ctype: str, **props):
        self.entity = entity
        self.ctype = ctype
        self.props = props

    def execute(self, world: World) -> None:
        world.create_component(self.entity, self.ctype, **self.props)

    def undo(self, world: World) -> None:
        world.destroy_component(self.entity, self.ctype)


class CommandStack:
    """≙ world_editor.cpp undo stack: executeCommand/undo/redo + merging."""

    def __init__(self, world: World, max_depth: int = 256):
        self.world = world
        self._undo: List[Command] = []
        self._redo: List[Command] = []
        self.max_depth = max_depth

    def execute(self, cmd: Command) -> Command:
        cmd.execute(self.world)
        self._redo.clear()
        if self._undo and self._undo[-1].merge(cmd):
            return self._undo[-1]
        self._undo.append(cmd)
        if len(self._undo) > self.max_depth:
            self._undo.pop(0)
        return cmd

    def can_undo(self) -> bool:
        return bool(self._undo)

    def can_redo(self) -> bool:
        return bool(self._redo)

    def undo(self) -> None:
        if self._undo:
            cmd = self._undo.pop()
            cmd.undo(self.world)
            self._redo.append(cmd)

    def redo(self) -> None:
        if self._redo:
            cmd = self._redo.pop()
            cmd.execute(self.world)
            self._undo.append(cmd)

"""EntityFolders (counterpart of
``lumixengine_tpu/editor/entity_folders.py``; ≙ reference src/editor/entity_folders.{h,cpp}): virtual
editor-only folders grouping entities — unrelated to the transform hierarchy
(the reference explicitly recommends folders over parenting for organization).

Same model as the reference: a folder tree per world partition (each
partition has a root folder), every entity belongs to exactly one folder
(the selected folder at creation time), folders have stable u64 ids that
survive serialization. Linked-list bookkeeping is replaced with plain Python
dicts/lists — the capability (move/emplace/destroy/rename/iterate/serialize)
is identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

INVALID_FOLDER = 0


@dataclass
class Folder:
    id: int
    name: str
    parent: int = INVALID_FOLDER
    children: List[int] = field(default_factory=list)
    entities: List[int] = field(default_factory=list)
    partition: int = 0


class EntityFolders:
    """≙ EntityFolders. Attach to a World; new entities land in the selected
    folder (hook `on_entity_created` from editor code)."""

    def __init__(self, world):
        self.world = world
        self.folders: Dict[int, Folder] = {}
        self.entity_folder: Dict[int, int] = {}
        self._next_id = 1
        self._roots: Dict[int, int] = {}       # partition -> folder id
        self._selected = self.get_root(0)
        self.ignore_new_entities = False

    # -- roots / selection ---------------------------------------------------

    def get_root(self, partition: int = 0) -> int:
        fid = self._roots.get(partition)
        if fid is None:
            fid = self._emplace_raw("root", INVALID_FOLDER, partition)
            self._roots[partition] = fid
        return fid

    def select_folder(self, folder: int) -> None:
        if folder not in self.folders:
            raise KeyError(folder)
        self._selected = folder

    @property
    def selected_folder(self) -> int:
        return self._selected

    # -- folder tree ---------------------------------------------------------

    def _emplace_raw(self, name: str, parent: int, partition: int) -> int:
        fid = self._next_id
        self._next_id += 1
        self.folders[fid] = Folder(id=fid, name=name, parent=parent,
                                   partition=partition)
        if parent != INVALID_FOLDER:
            self.folders[parent].children.append(fid)
        return fid

    def emplace_folder(self, name: str = "new folder",
                       parent: Optional[int] = None) -> int:
        parent = self._selected if parent is None else parent
        return self._emplace_raw(name, parent,
                                 self.folders[parent].partition)

    def rename_folder(self, folder: int, name: str) -> None:
        self.folders[folder].name = name[:80]   # reference cap: char[80]

    def move_folder(self, folder: int, new_parent: int) -> None:
        f = self.folders[folder]
        if f.parent == INVALID_FOLDER:
            raise ValueError("cannot move a root folder")
        # reject cycles
        p = new_parent
        while p != INVALID_FOLDER:
            if p == folder:
                raise ValueError("folder move would create a cycle")
            p = self.folders[p].parent
        self.folders[f.parent].children.remove(folder)
        f.parent = new_parent
        self.folders[new_parent].children.append(folder)

    def destroy_folder(self, folder: int) -> None:
        """Entities and subfolders are reparented to the folder's parent
        (≙ destroyFolder keeping entities)."""
        f = self.folders[folder]
        if f.parent == INVALID_FOLDER:
            raise ValueError("cannot destroy a root folder")
        parent = self.folders[f.parent]
        for e in list(f.entities):
            self.move_to_folder(e, parent.id)
        for c in list(f.children):
            self.move_folder(c, parent.id)
        parent.children.remove(folder)
        if self._selected == folder:
            self._selected = parent.id
        del self.folders[folder]

    # -- entities ------------------------------------------------------------

    def on_entity_created(self, entity: int) -> None:
        if not self.ignore_new_entities:
            self.move_to_folder(entity, self._selected)

    def on_entity_destroyed(self, entity: int) -> None:
        fid = self.entity_folder.pop(entity, None)
        if fid is not None and fid in self.folders:
            self.folders[fid].entities.remove(entity)

    def get_folder(self, entity: int) -> int:
        return self.entity_folder.get(entity, INVALID_FOLDER)

    def move_to_folder(self, entity: int, folder: int) -> None:
        old = self.entity_folder.get(entity)
        if old is not None and old in self.folders:
            self.folders[old].entities.remove(entity)
        self.folders[folder].entities.append(entity)
        self.entity_folder[entity] = folder

    def folder_entities(self, folder: int) -> List[int]:
        return list(self.folders[folder].entities)

    # -- serialization (≙ serialize/deserialize with EntityMap remap) --------

    def serialize(self) -> dict:
        return {
            "next_id": self._next_id,
            "selected": self._selected,
            "roots": dict(self._roots),
            "folders": [
                {"id": f.id, "name": f.name, "parent": f.parent,
                 "partition": f.partition, "entities": list(f.entities)}
                for f in self.folders.values()
            ],
        }

    def deserialize(self, blob: dict, entity_map: Optional[Dict[int, int]] = None) -> None:
        self.folders.clear()
        self.entity_folder.clear()
        self._next_id = blob["next_id"]
        self._roots = {int(k): v for k, v in blob["roots"].items()}
        for rec in blob["folders"]:
            self.folders[rec["id"]] = Folder(
                id=rec["id"], name=rec["name"], parent=rec["parent"],
                partition=rec["partition"])
        for rec in blob["folders"]:
            if rec["parent"] != INVALID_FOLDER:
                self.folders[rec["parent"]].children.append(rec["id"])
            for e in rec["entities"]:
                e2 = entity_map.get(e, e) if entity_map else e
                self.folders[rec["id"]].entities.append(e2)
                self.entity_folder[e2] = rec["id"]
        self._selected = blob["selected"]
        if self._selected not in self.folders:
            self._selected = self.get_root(0)

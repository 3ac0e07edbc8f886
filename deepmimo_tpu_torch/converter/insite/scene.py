"""Scene geometry extraction from InSite .city/.ter/.veg files.

Geometry files contain begin_<face> blocks of vertex rows; faces sharing
vertices form one physical object (connectivity grouping). Copied from
``deepmimo_tpu/converter/insite/scene.py``, on the port's ``scene``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List

import numpy as np

from ...scene import (Scene, Face, PhysicalElement, CAT_BUILDINGS,
                      CAT_TERRAIN, CAT_VEGETATION, CAT_FLOORPLANS,
                      CAT_OBJECTS)

OBJECT_LABELS = {
    ".city": CAT_BUILDINGS,
    ".ter": CAT_TERRAIN,
    ".veg": CAT_VEGETATION,
    ".flp": CAT_FLOORPLANS,
    ".obj": CAT_OBJECTS,
}

_FACE_RE = re.compile(r"begin_<face>(.*?)end_<face>", re.DOTALL)
_VERTEX_RE = re.compile(r"-?\d+\.\d+\s+-?\d+\.\d+\s+-?\d+\.\d+")
_MATERIAL_RE = re.compile(r"^\s*Material\s+(\d+)", re.MULTILINE)


def extract_faces(content: str) -> List[np.ndarray]:
    """All face vertex arrays ([N,3] each) in file order."""
    return [verts for verts, _ in extract_faces_with_materials(content)]


def extract_faces_with_materials(content: str):
    """(vertices, material_idx) for every face block in file order."""
    faces = []
    for face_text in _FACE_RE.findall(content):
        verts = [[float(v) for v in m.split()]
                 for m in _VERTEX_RE.findall(face_text)]
        if len(verts) < 3:
            continue
        m = _MATERIAL_RE.search(face_text)
        mat_idx = int(m.group(1)) if m else 0
        faces.append((np.asarray(verts, dtype=np.float32), mat_idx))
    return faces


def group_faces_into_objects(faces: List[np.ndarray]) -> List[List[int]]:
    """Group faces into connected components via shared vertices.

    Union-find over faces keyed by rounded vertex tuples — two faces
    touching at any vertex belong to the same physical object.
    """
    parent = list(range(len(faces)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    vertex_owner: Dict[tuple, int] = {}
    for i, verts in enumerate(faces):
        for v in verts:
            key = tuple(np.round(v, 4))
            if key in vertex_owner:
                union(vertex_owner[key], i)
            else:
                vertex_owner[key] = i

    groups: Dict[int, List[int]] = {}
    for i in range(len(faces)):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def parse_geometry_file(path: str, label: str, name: str,
                        starting_id: int = 0) -> List[PhysicalElement]:
    with open(path, "r") as f:
        content = f.read()
    faces_mats = extract_faces_with_materials(content)
    faces = [fm[0] for fm in faces_mats]
    objects = []
    for i, group in enumerate(group_faces_into_objects(faces)):
        obj_faces = [Face(vertices=faces_mats[j][0],
                          material_idx=faces_mats[j][1]) for j in group]
        objects.append(PhysicalElement(
            faces=obj_faces, name=f"{name}_{i}",
            object_id=starting_id + i, label=label))
    return objects


def read_scene(folder_path: str) -> Scene:
    """Build a Scene from all geometry files in an InSite project folder."""
    folder = Path(folder_path)
    scene = Scene()
    next_id = 0
    found = False
    for ext, label in OBJECT_LABELS.items():
        for file in sorted(folder.glob(f"*{ext}")):
            found = True
            objs = parse_geometry_file(str(file), label, file.stem,
                                       starting_id=next_id)
            next_id += len(objs)
            scene.add_objects(objs)
    if not found:
        raise ValueError(f"No geometry files (.city/.ter/.veg) in {folder}")
    return scene

"""Physical-scene data model: faces, objects, and the Scene container.

Represents the 3D geometry attached to a scenario (buildings, terrain,
vegetation, ...) with the scenario on-disk format: ``vertices.mat`` plus
``objects.json`` metadata, so scenes round-trip between toolchains. Host
numpy/scipy code, copied from ``deepmimo_tpu.scene``; plotting imports
matplotlib inside the function, so the package imports without it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import scipy.io

from . import consts as c
from .utils import save_dict_as_json, load_dict_from_json

# Object categories
CAT_BUILDINGS = "buildings"
CAT_TERRAIN = "terrain"
CAT_VEGETATION = "vegetation"
CAT_FLOORPLANS = "floorplans"
CAT_OBJECTS = "objects"

ELEMENT_CATEGORIES = [CAT_BUILDINGS, CAT_TERRAIN, CAT_VEGETATION,
                      CAT_FLOORPLANS, CAT_OBJECTS]


@dataclass
class BoundingBox:
    """Axis-aligned 3D bounding box."""

    bounds: np.ndarray  # (2, 3): [mins; maxs]

    def __init__(self, x_min, x_max, y_min, y_max, z_min, z_max):
        self.bounds = np.array([[x_min, y_min, z_min], [x_max, y_max, z_max]])

    @property
    def x_min(self): return self.bounds[0, 0]

    @property
    def x_max(self): return self.bounds[1, 0]

    @property
    def y_min(self): return self.bounds[0, 1]

    @property
    def y_max(self): return self.bounds[1, 1]

    @property
    def z_min(self): return self.bounds[0, 2]

    @property
    def z_max(self): return self.bounds[1, 2]

    @property
    def width(self): return self.x_max - self.x_min

    @property
    def length(self): return self.y_max - self.y_min

    @property
    def height(self): return self.z_max - self.z_min


class Face:
    """A planar polygonal surface; triangulated on demand (fan split)."""

    def __init__(self, vertices, material_idx: int = 0):
        self.vertices = np.asarray(vertices, dtype=np.float32)
        self.material_idx = int(material_idx)
        self._cache: Dict[str, object] = {}

    @property
    def normal(self) -> np.ndarray:
        if "normal" not in self._cache:
            v1 = self.vertices[1] - self.vertices[0]
            v2 = self.vertices[2] - self.vertices[0]
            n = np.cross(v1, v2)
            self._cache["normal"] = n / np.linalg.norm(n)
        return self._cache["normal"]

    @property
    def triangular_faces(self) -> List[np.ndarray]:
        if "tris" not in self._cache:
            v = self.vertices
            if len(v) == 3:
                self._cache["tris"] = [v]
            else:
                self._cache["tris"] = [
                    np.array([v[0], v[i], v[i + 1]])
                    for i in range(1, len(v) - 1)]
        return self._cache["tris"]

    @property
    def num_triangular_faces(self) -> int:
        return len(self.triangular_faces)

    @property
    def area(self) -> float:
        if "area" not in self._cache:
            n = self.normal
            proj_axis = int(np.argmax(np.abs(n)))
            axes = [i for i in range(3) if i != proj_axis]
            pts = self.vertices[:, axes]
            x, y = pts[:, 0], pts[:, 1]
            self._cache["area"] = 0.5 * abs(
                np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
        return self._cache["area"]

    @property
    def centroid(self) -> np.ndarray:
        return np.mean(self.vertices, axis=0)


class PhysicalElement:
    """A physical object: a set of faces with a label and materials."""

    DEFAULT_LABELS = set(ELEMENT_CATEGORIES)

    def __init__(self, faces: List[Face], object_id: int = -1,
                 label: str = CAT_OBJECTS, color: str = "",
                 speed: float = 0.0, name: str = ""):
        self._faces = faces
        self.object_id = object_id
        self.label = label if label in self.DEFAULT_LABELS else CAT_OBJECTS
        self.color = color
        self.speed = speed
        self.name = name
        self._bbox: Optional[BoundingBox] = None

    @property
    def faces(self) -> List[Face]:
        return self._faces

    @property
    def bounding_box(self) -> BoundingBox:
        if self._bbox is None:
            allv = np.vstack([f.vertices for f in self._faces])
            mins, maxs = allv.min(axis=0), allv.max(axis=0)
            self._bbox = BoundingBox(mins[0], maxs[0], mins[1], maxs[1],
                                     mins[2], maxs[2])
        return self._bbox

    @property
    def height(self) -> float:
        return self.bounding_box.height

    @property
    def position(self) -> np.ndarray:
        bb = self.bounding_box
        return 0.5 * (bb.bounds[0] + bb.bounds[1])

    @property
    def materials(self) -> Set[int]:
        return {f.material_idx for f in self._faces}

    @property
    def hull_volume(self) -> float:
        from scipy.spatial import ConvexHull
        allv = np.vstack([f.vertices for f in self._faces])
        try:
            return float(ConvexHull(allv).volume)
        except Exception:
            return 0.0

    @property
    def volume(self) -> float:
        return self.hull_volume

    def to_dict(self, vertex_map: Dict[Tuple[float, ...], int]) -> Dict:
        """Serialize via a shared vertex pool (indices into vertices.mat)."""
        meta = {"name": self.name, "label": self.label, "id": self.object_id,
                "face_vertex_idxs": [], "face_material_idxs": []}
        for face in self._faces:
            idxs: List[int] = []
            for tri in face.triangular_faces:
                for vertex in tri:
                    key = tuple(vertex)
                    if key not in vertex_map:
                        vertex_map[key] = len(vertex_map)
                    if vertex_map[key] not in idxs:
                        idxs.append(vertex_map[key])
            meta["face_vertex_idxs"].append(idxs)
            meta["face_material_idxs"].append(face.material_idx)
        return meta

    @classmethod
    def from_dict(cls, data: Dict, vertices: np.ndarray) -> "PhysicalElement":
        faces = [Face(vertices=vertices[np.asarray(vi, dtype=int)],
                      material_idx=mi)
                 for vi, mi in zip(data["face_vertex_idxs"],
                                   data["face_material_idxs"])]
        return cls(faces=faces, name=data.get("name", ""),
                   object_id=data.get("id", -1),
                   label=data.get("label", CAT_OBJECTS))

    def plot(self, ax=None, **kwargs):
        return Scene._plot_objects([self], ax=ax, **kwargs)

    def __repr__(self) -> str:
        return (f"PhysicalElement(name='{self.name}', id={self.object_id}, "
                f"label='{self.label}', faces={len(self._faces)})")


class PhysicalElementGroup:
    """A filtered collection of physical objects."""

    def __init__(self, objects: List[PhysicalElement]):
        self._objects = objects

    def __len__(self):
        return len(self._objects)

    def __iter__(self):
        return iter(self._objects)

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return self._objects[idx]
        return PhysicalElementGroup([self._objects[i] for i in idx])

    @property
    def bounding_box(self) -> BoundingBox:
        allv = np.vstack([f.vertices for o in self._objects for f in o.faces])
        mins, maxs = allv.min(axis=0), allv.max(axis=0)
        return BoundingBox(mins[0], maxs[0], mins[1], maxs[1],
                           mins[2], maxs[2])

    def get_objects(self, label: Optional[str] = None,
                    material: Optional[int] = None) -> "PhysicalElementGroup":
        objs = self._objects
        if label is not None:
            objs = [o for o in objs if o.label == label]
        if material is not None:
            objs = [o for o in objs if material in o.materials]
        return PhysicalElementGroup(objs)

    def __repr__(self):
        return f"PhysicalElementGroup({len(self._objects)} objects)"


class Scene:
    """All physical objects of a scenario, with export/import and plotting."""

    DEFAULT_VISUALIZATION_SETTINGS = {
        CAT_TERRAIN: {"z_order": 1, "alpha": 0.1, "color": "grey"},
        CAT_VEGETATION: {"z_order": 2, "alpha": 0.8, "color": "green"},
        CAT_BUILDINGS: {"z_order": 3, "alpha": 0.8, "color": None},
        CAT_FLOORPLANS: {"z_order": 4, "alpha": 0.8, "color": "blue"},
        CAT_OBJECTS: {"z_order": 5, "alpha": 0.8, "color": "blue"},
    }

    def __init__(self):
        self.objects: List[PhysicalElement] = []
        self.visualization_settings = dict(self.DEFAULT_VISUALIZATION_SETTINGS)
        self.face_indices: List[List[List[int]]] = []
        self._current_index = 0
        self._objects_by_category: Dict[str, List[PhysicalElement]] = {
            cat: [] for cat in ELEMENT_CATEGORIES}
        self._objects_by_material: Dict[int, List[PhysicalElement]] = {}

    @property
    def bounding_box(self) -> BoundingBox:
        return self.get_objects().bounding_box

    def add_object(self, obj: PhysicalElement) -> None:
        if obj.object_id == -1:
            obj.object_id = len(self.objects)
        obj_indices = []
        for face in obj.faces:
            n_tri = face.num_triangular_faces
            obj_indices.append(list(range(self._current_index,
                                          self._current_index + n_tri)))
            self._current_index += n_tri
        for mat in obj.materials:
            self._objects_by_material.setdefault(mat, []).append(obj)
        cat = obj.label if obj.label in ELEMENT_CATEGORIES else CAT_OBJECTS
        self._objects_by_category.setdefault(cat, []).append(obj)
        self.face_indices.append(obj_indices)
        self.objects.append(obj)

    def add_objects(self, objects: List[PhysicalElement]) -> None:
        for obj in objects:
            self.add_object(obj)

    def get_objects(self, label: Optional[str] = None,
                    material: Optional[int] = None) -> PhysicalElementGroup:
        if label:
            objs = self._objects_by_category.get(label, [])
        elif material is not None:
            objs = self._objects_by_material.get(material, [])
        else:
            objs = self.objects
        group = PhysicalElementGroup(objs)
        return group.get_objects(material=material) if material else group

    # -- persistence ---------------------------------------------------------

    def export_data(self, base_folder: str) -> Dict:
        """Write vertices.mat + objects.json; return scene metadata."""
        os.makedirs(base_folder, exist_ok=True)
        vertex_map: Dict[Tuple[float, ...], int] = {}
        objects_metadata = [obj.to_dict(vertex_map) for obj in self.objects]
        vertices = np.zeros((len(vertex_map), 3), dtype=np.float32)
        for vertex, idx in vertex_map.items():
            vertices[idx] = vertex
        scipy.io.savemat(os.path.join(base_folder, "vertices.mat"),
                         {"vertices": vertices})
        save_dict_as_json(os.path.join(base_folder, "objects.json"),
                          objects_metadata)
        return {
            c.SCENE_PARAM_NUMBER_SCENES: 1,
            c.SCENE_PARAM_N_OBJECTS: len(self.objects),
            c.SCENE_PARAM_N_VERTICES: len(vertices),
            c.SCENE_PARAM_N_FACES: sum(len(o.faces) for o in self.objects),
            c.SCENE_PARAM_N_TRIANGULAR_FACES: self._current_index,
        }

    @classmethod
    def from_data(cls, base_folder: str) -> Optional["Scene"]:
        """Load a scene from vertices.mat + objects.json (None if absent)."""
        vpath = os.path.join(base_folder, "vertices.mat")
        opath = os.path.join(base_folder, "objects.json")
        if not (os.path.exists(vpath) and os.path.exists(opath)):
            return None
        vertices = scipy.io.loadmat(vpath)["vertices"]
        objects_metadata = load_dict_from_json(opath)
        scene = cls()
        for object_data in objects_metadata:
            scene.add_object(PhysicalElement.from_dict(object_data, vertices))
        return scene

    # -- plotting ------------------------------------------------------------

    def plot(self, title: bool = True, ax=None, proj_2d: bool = False,
             figsize: tuple = (10, 10), dpi: int = 100, legend: bool = False):
        return self._plot_objects(self.objects, ax=ax, proj_2d=proj_2d,
                                  figsize=figsize, dpi=dpi, legend=legend,
                                  settings=self.visualization_settings,
                                  title=title)

    @staticmethod
    def _plot_objects(objects, ax=None, proj_2d: bool = False,
                      figsize=(10, 10), dpi=100, legend=False, settings=None,
                      title=True):
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        settings = settings or Scene.DEFAULT_VISUALIZATION_SETTINGS
        if ax is None:
            fig = plt.figure(figsize=figsize, dpi=dpi)
            ax = fig.add_subplot(111) if proj_2d else \
                fig.add_subplot(111, projection="3d")

        rng = np.random.default_rng(0)
        for obj in objects:
            s = settings.get(obj.label, settings[CAT_OBJECTS])
            color = obj.color or s.get("color") or \
                tuple(rng.uniform(0.2, 0.9, 3))
            alpha = s.get("alpha", 0.8)
            if proj_2d:
                for face in obj.faces:
                    v = face.vertices
                    ax.fill(v[:, 0], v[:, 1], color=color, alpha=alpha)
            else:
                polys = [f.vertices for f in obj.faces]
                ax.add_collection3d(Poly3DCollection(
                    polys, facecolor=color, alpha=alpha, edgecolor="k",
                    linewidths=0.2))
        if not proj_2d and objects:
            allv = np.vstack([f.vertices for o in objects for f in o.faces])
            ax.set_xlim(allv[:, 0].min(), allv[:, 0].max())
            ax.set_ylim(allv[:, 1].min(), allv[:, 1].max())
            ax.set_zlim(allv[:, 2].min(), max(allv[:, 2].max(), 1))
        if title:
            ax.set_title("Scene")
        ax.set_xlabel("x (m)")
        ax.set_ylabel("y (m)")
        return ax

    def __repr__(self):
        return f"Scene({len(self.objects)} objects)"


def _hull_prism_faces(vertices: np.ndarray) -> Optional[List[np.ndarray]]:
    """Simplified face set: footprint convex hull extruded over the z range.

    Capability parity with the reference's fast mode (deepmimo/scene.py:
    882-949): flat objects (roads, terrain patches) collapse to a single
    hull-outline face; 3D objects become bottom + top + one quad per hull
    edge. Returns None when the footprint is degenerate (collinear points).
    """
    from scipy.spatial import ConvexHull, QhullError

    pts2d = vertices[:, :2]
    if np.linalg.matrix_rank(pts2d - pts2d[0]) < 2:
        return None
    try:
        hull = ConvexHull(pts2d)
    except QhullError:
        return None

    z = vertices[:, 2]
    extent = np.ptp(pts2d, axis=0)
    min_extent = np.min(extent[extent > 0]) if np.any(extent > 0) else 0.0
    if np.std(z) < 0.1 * min_extent:
        # Flat object: a single outline face at the original heights.
        return [vertices[hull.vertices]]

    z_lo, z_hi = float(z.min()), float(z.max())
    outline = pts2d[hull.vertices]
    bottom = np.column_stack([outline, np.full(len(outline), z_lo)])
    top = np.column_stack([outline, np.full(len(outline), z_hi)])
    sides = []
    for i in range(len(outline)):
        j = (i + 1) % len(outline)
        sides.append(np.array([bottom[i], bottom[j], top[j], top[i]]))
    return [bottom, top] + sides


def _downsample_outline(pts: np.ndarray, max_points: int) -> np.ndarray:
    """Pick <= max_points representative outline points.

    Farthest-point sampling seeded with the axis extremes, so the polygon's
    reach is preserved while interior/duplicate points drop out.
    """
    pts = np.unique(np.round(pts, 6), axis=0)
    if len(pts) <= max_points:
        return pts
    seeds = {int(np.argmin(pts[:, 0])), int(np.argmax(pts[:, 0])),
             int(np.argmin(pts[:, 1])), int(np.argmax(pts[:, 1]))}
    chosen = list(seeds)
    dist = np.full(len(pts), np.inf)
    for idx in chosen:
        dist = np.minimum(dist, np.linalg.norm(pts[:, :2] - pts[idx, :2], axis=1))
    while len(chosen) < max_points:
        nxt = int(np.argmax(dist))
        if dist[nxt] <= 0:
            break
        chosen.append(nxt)
        dist = np.minimum(dist, np.linalg.norm(pts[:, :2] - pts[nxt, :2], axis=1))
    return pts[sorted(chosen)]


def _min_perimeter_cycle(pts2d: np.ndarray) -> List[int]:
    """Exact minimal-perimeter Hamiltonian cycle (bitmask DP, n <= ~14).

    For points in the plane the shortest closed tour is always a *simple*
    polygon (a crossing can be uncrossed to shorten it), so — unlike the
    reference's intersection-checked search (deepmimo/scene.py:975-1034) —
    minimizing perimeter alone reconstructs a non-self-intersecting
    boundary.
    """
    n = len(pts2d)
    if n <= 3:
        return list(range(n))
    dmat = np.linalg.norm(pts2d[:, None] - pts2d[None, :], axis=-1)
    full = 1 << n
    INF = np.inf
    # dp[mask][j] = shortest path visiting `mask`, starting at 0, ending j
    dp = np.full((full, n), INF)
    parent = np.full((full, n), -1, dtype=np.int32)
    dp[1][0] = 0.0
    for mask in range(1, full):
        if not mask & 1:
            continue
        ends = np.nonzero(np.isfinite(dp[mask]))[0]
        for j in ends:
            base = dp[mask][j]
            for k in range(1, n):
                if mask >> k & 1:
                    continue
                nm = mask | (1 << k)
                cand = base + dmat[j, k]
                if cand < dp[nm][k]:
                    dp[nm][k] = cand
                    parent[nm][k] = j
    closing = dp[full - 1] + dmat[:, 0]
    closing[0] = INF
    j = int(np.argmin(closing))
    order, mask = [], full - 1
    while j != -1:
        order.append(j)
        pj = parent[mask][j]
        mask ^= 1 << j
        j = pj
    return order[::-1]


def _drop_collinear(pts: np.ndarray, order: List[int],
                    angle_tol_deg: float = 1.0) -> List[int]:
    """Remove cycle points whose turn angle is within tol of straight."""
    n = len(order)
    if n <= 3:
        return order
    keep = []
    for i in range(n):
        p0 = pts[order[i - 1], :2]
        p1 = pts[order[i], :2]
        p2 = pts[order[(i + 1) % n], :2]
        a, b = p1 - p0, p2 - p1
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 1e-12 or nb < 1e-12:
            continue
        cosang = np.clip(np.dot(a, b) / (na * nb), -1.0, 1.0)
        if np.degrees(np.arccos(cosang)) > angle_tol_deg:
            keep.append(order[i])
    return keep if len(keep) >= 3 else order


def _planar_outline_face(vertices: np.ndarray, z_tolerance: float = 0.1,
                         max_points: int = 12) -> List[np.ndarray]:
    """Reconstruct one (possibly non-convex) planar polygon from a point soup.

    The road-polygon capability of the reference's detailed mode
    (deepmimo/scene.py:1239-1274): downsample to representative outline
    points, order them with an exact minimal-perimeter cycle (simple by
    construction), then drop collinear points.
    """
    if not np.allclose(vertices[:, 2], vertices[0, 2], atol=z_tolerance):
        raise ValueError("Vertices are not planar (z spread exceeds tolerance)")
    pts = _downsample_outline(vertices, max_points)
    order = _min_perimeter_cycle(pts[:, :2])
    order = _drop_collinear(pts, order)
    return [pts[order]]


def get_object_faces(vertices: np.ndarray, fast: Optional[bool] = None,
                     decimals: int = 2) -> Optional[List[np.ndarray]]:
    """Build polygonal faces for one physical object from its vertex soup.

    Modes (signature parity with reference deepmimo/scene.py:1276-1306):

    - ``fast=True``: convex-hull prism — footprint hull extruded over the
      z range (flat objects collapse to a single outline face).
    - ``fast=False``: geometry-preserving. Near-planar soups (roads) are
      reconstructed as one possibly non-convex outline polygon; full-3D
      soups fall back to coplanar triangle clustering.
    - ``fast=None`` (default): coplanar clustering of a triangle list —
      the exact path used by this package's converters, which receive
      structured triangles rather than bare point clouds.
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    if vertices.ndim == 2 and len(vertices) < 3:
        return None
    if fast is True:
        return _hull_prism_faces(vertices.reshape(-1, 3))
    if fast is False:
        flat = vertices.reshape(-1, 3)
        if np.allclose(flat[:, 2], flat[0, 2], atol=0.1):
            return _planar_outline_face(flat)
        # fall through to coplanar clustering for true 3D soups
    return _coplanar_cluster_faces(vertices, decimals)


def _coplanar_cluster_faces(vertices: np.ndarray,
                            decimals: int = 2) -> List[np.ndarray]:
    """Group a vertex soup into planar faces (coplanar clustering).

    Utility for converters that receive unstructured triangle lists: groups
    triangles by their (rounded) plane equation and merges each group into a
    single polygonal face.
    """
    verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3, 3)
    planes: Dict[tuple, List[np.ndarray]] = {}
    for tri in verts:
        n = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        norm = np.linalg.norm(n)
        if norm < 1e-12:
            continue
        n = n / norm
        # Canonical orientation so opposite-facing normals merge
        if (n[2], n[1], n[0]) < (0, 0, 0):
            n = -n
        d = float(np.dot(n, tri[0]))
        key = tuple(np.round(np.concatenate([n, [d]]), decimals))
        planes.setdefault(key, []).append(tri)
    faces = []
    for tris in planes.values():
        pts = np.unique(np.vstack(tris), axis=0)
        faces.append(pts)
    return faces

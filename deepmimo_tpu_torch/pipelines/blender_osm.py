"""OSM -> 3D scene export via headless Blender (gated on external tools).

Drives Blender with the blosm addon to import OSM buildings/roads for a
GPS bbox and produce ray-tracer-ready scene files: per-object-class PLY
(Wireless InSite ``.city`` conversion needs buildings / roads / terrain
as separate meshes WITH materials) and a Mitsuba ``scene.xml`` (Sionna):
addon bootstrap, blosm import configuration, OSM-origin + bbox metadata
persistence, material creation and assignment by object-name pattern,
tiered road selection with out-of-bounds trimming, a bbox-sized terrain
plane, and per-class exports.

Blender is an external dependency; every entry point raises a clear
error when it is absent. The bpy script is GENERATED host-side
(:func:`build_blender_script`) so its feature set is unit-testable
without Blender, and the pipeline has no import-time bpy dependency.

Copied from ``deepmimo_tpu/pipelines/blender_osm.py`` with two fixes in
the generated script. ``trim_to_bounds`` returns False when it deletes a
road lying fully outside the bounds, and ``process_roads`` then skips its
material: the JAX package's script reads ``obj.name`` on the deleted
object, which raises ReferenceError in Blender and aborts the export. The
bounds and the terrain size are written as Python floats: under numpy 2
the JAX package writes ``np.float64(...)``, which the script cannot
evaluate (it imports no numpy).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence, Tuple

from .geo_utils import bbox_size_meters, meters_per_deg_lon

# Addon zips looked up in ``addons_dir`` (no auto-download: scene
# generation environments are often air-gapped; the error message points
# at the project that ships each addon).
ADDON_ZIPS = {
    "blosm": "blosm.zip",                       # github.com/vvoovv/blosm
    "mitsuba-blender": "mitsuba-blender.zip",   # mitsuba-renderer org
}

# ITU material names expected by the downstream ray-tracer stages; the
# diffuse colors only matter for the diagnostic renders.
MATERIALS = {
    "building": ("itu_concrete", (0.75, 0.40, 0.16, 1.0)),
    "road": ("itu_brick", (0.29, 0.25, 0.21, 1.0)),
    "terrain": ("itu_wet_ground", (0.22, 0.28, 0.16, 1.0)),
}

# Road selection: keep the best-populated tier only (mixing tiers
# produces overlapping coplanar faces that break ray tracing); drop
# auxiliary blosm outputs that are not drivable surfaces.
ROAD_TIERS = (
    ("map.osm_roads_primary", "map.osm_roads_secondary",
     "map.osm_roads_tertiary", "map.osm_roads_residential",
     "map.osm_roads_unclassified", "map.osm_roads_service"),
    ("map.osm_paths_footway",),
)
REJECTED_ROAD_KEYWORDS = ("profile_", "paths_steps")


class BlenderNotAvailable(RuntimeError):
    pass


def find_blender() -> Optional[str]:
    return shutil.which("blender") or os.environ.get("BLENDER_PATH")


def xy_bounds_from_bbox(bbox: Sequence[float], pad_m: float = 0.0
                        ) -> Tuple[float, float, float, float]:
    """(min_x, max_x, min_y, max_y) meters, centered on the bbox center.

    blosm places the scene origin at the bbox center, so object
    coordinates live in this frame (used to size the terrain plane and
    trim roads).
    """
    min_lat, min_lon, max_lat, max_lon = (float(v) for v in bbox)
    size_x, size_y = bbox_size_meters((min_lat, min_lon, max_lat, max_lon))
    return (-size_x / 2 - pad_m, size_x / 2 + pad_m,
            -size_y / 2 - pad_m, size_y / 2 + pad_m)


def build_blender_script(bbox: Sequence[float], out_dir: str,
                         formats: Sequence[str] = ("insite",),
                         addons_dir: Optional[str] = None,
                         road_pad_m: float = 40.0) -> str:
    """Generate the self-contained bpy script for one OSM scene export.

    The script (executed inside Blender's Python) performs, in order:
    datablock wipe -> addon bootstrap -> blosm configure+import ->
    origin/bbox metadata -> world lighting -> mesh conversion ->
    material assignment (buildings by name pattern; roads by tier with
    bounds trim) -> bbox-sized terrain plane -> per-class PLY exports
    (+ Mitsuba XML for Sionna).
    """
    min_lat, min_lon, max_lat, max_lon = (float(v) for v in bbox)
    # Python floats: the repr of a numpy float is "np.float64(...)" from
    # numpy 2 on, a name the script (which imports no numpy) lacks.
    xy = tuple(float(v) for v in xy_bounds_from_bbox(bbox, pad_m=road_pad_m))
    size_x, size_y = (float(v) for v in bbox_size_meters(
        (min_lat, min_lon, max_lat, max_lon)))
    want_sionna = "sionna" in formats
    addons = ["blosm"] + (["mitsuba-blender"] if want_sionna else [])

    header = f"""\
import bpy
import os

OUT = {out_dir!r}
ADDONS_DIR = {addons_dir or os.path.join(out_dir, "blender_addons")!r}
ADDON_ZIPS = {ADDON_ZIPS!r}
MATERIALS = {MATERIALS!r}
ROAD_TIERS = {ROAD_TIERS!r}
REJECTED_ROAD_KEYWORDS = {REJECTED_ROAD_KEYWORDS!r}
MIN_LAT, MIN_LON, MAX_LAT, MAX_LON = \\
    {min_lat!r}, {min_lon!r}, {max_lat!r}, {max_lon!r}
XY_BOUNDS = {xy!r}                      # (min_x, max_x, min_y, max_y), padded
TERRAIN_SIZE = ({size_x * 1.2!r}, {size_y * 1.2!r})
WANT_SIONNA = {want_sionna!r}
BOOTSTRAP_ADDONS = {addons!r}
"""

    body = '''
def clean_scene():
    """Remove every datablock so repeated runs start identical."""
    bpy.ops.wm.read_factory_settings(use_empty=True)
    for coll in (bpy.data.objects, bpy.data.meshes, bpy.data.materials,
                 bpy.data.curves, bpy.data.cameras, bpy.data.collections):
        for block in list(coll):
            coll.remove(block, do_unlink=True)


def ensure_addon(name):
    """Enable an addon, installing it from ADDONS_DIR when missing."""
    if name in bpy.context.preferences.addons:
        return
    try:
        bpy.ops.preferences.addon_enable(module=name)
        return
    except Exception:
        pass
    zip_path = os.path.join(ADDONS_DIR, ADDON_ZIPS[name])
    if not os.path.exists(zip_path):
        raise RuntimeError(
            "addon %r is not installed and %s does not exist; place the "
            "addon zip there (blosm: github.com/vvoovv/blosm; "
            "mitsuba-blender: the mitsuba-renderer org)" % (name, zip_path))
    bpy.ops.preferences.addon_install(filepath=zip_path)
    bpy.ops.preferences.addon_enable(module=name)
    bpy.ops.wm.save_userpref()


def configure_blosm():
    prefs = bpy.context.preferences.addons["blosm"].preferences
    prefs.dataDir = OUT
    s = bpy.context.scene.blosm
    s.mode = "3Dsimple"
    s.minLat, s.maxLat = MIN_LAT, MAX_LAT
    s.minLon, s.maxLon = MIN_LON, MAX_LON
    s.buildings = True
    s.highways = True
    s.water = False
    s.forests = False
    s.vegetation = False
    s.railways = False
    s.singleObject = True
    s.ignoreGeoreferencing = True


def save_metadata():
    """Persist the OSM origin (needed to georeference TX/RX placements
    downstream) and the bbox, next to the scene files."""
    scene = bpy.data.scenes["Scene"]
    with open(os.path.join(OUT, "osm_gps_origin.txt"), "w") as f:
        f.write("%s\\n%s\\n" % (scene["lat"], scene["lon"]))
    with open(os.path.join(OUT, "scenario_info.txt"), "w") as f:
        f.write("Bounding Box: [%s, %s] to [%s, %s]\\n"
                % (MIN_LAT, MIN_LON, MAX_LAT, MAX_LON))


def setup_lighting():
    world = bpy.data.worlds.new("World")
    world.use_nodes = True
    bg = world.node_tree.nodes.get("Background")
    if bg is not None:
        bg.inputs[0].default_value = (1.0, 1.0, 1.0, 1.0)
        bg.inputs[1].default_value = 1.0
    bpy.context.scene.world = world


def convert_all_to_mesh():
    bpy.ops.object.select_all(action="SELECT")
    sel = bpy.context.selected_objects
    if sel:
        bpy.context.view_layer.objects.active = sel[0]
        bpy.ops.object.convert(target="MESH", keep_original=False)


def make_material(kind):
    name, color = MATERIALS[kind]
    mat = bpy.data.materials.get(name)
    if mat is None:
        mat = bpy.data.materials.new(name=name)
        mat.diffuse_color = color
    return mat


def assign_material_by_pattern(pattern, mat):
    """Material-by-object-name assignment: the PLY/Mitsuba exports carry
    the material per mesh, which the InSite .city conversion requires."""
    hit = False
    for obj in bpy.data.objects:
        if obj.type == "MESH" and pattern in obj.name.lower():
            obj.data.materials.clear()
            obj.data.materials.append(mat)
            hit = True
    return hit


def trim_to_bounds(obj, min_x, max_x, min_y, max_y):
    """Boolean-intersect an object with the (tall) bounds box; delete it
    outright when fully outside. Returns False when it deleted the object
    (its Python handle is then invalid), True otherwise."""
    xs = [obj.matrix_world @ v.co for v in obj.data.vertices] \\
        if obj.data.vertices else []
    if xs:
        ox = [v.x for v in xs]
        oy = [v.y for v in xs]
        if (max(ox) < min_x or min(ox) > max_x or
                max(oy) < min_y or min(oy) > max_y):
            bpy.data.objects.remove(obj, do_unlink=True)
            return False
        if (min(ox) >= min_x and max(ox) <= max_x and
                min(oy) >= min_y and max(oy) <= max_y):
            return True                  # fully inside: nothing to trim
    bpy.ops.mesh.primitive_cube_add(size=1)
    cutter = bpy.context.active_object
    cutter.scale = ((max_x - min_x), (max_y - min_y), 2000.0)
    cutter.location = ((max_x + min_x) / 2, (max_y + min_y) / 2, 0.0)
    mod = obj.modifiers.new(name="bounds", type="BOOLEAN")
    mod.object = cutter
    mod.operation = "INTERSECT"
    bpy.context.view_layer.objects.active = obj
    bpy.ops.object.modifier_apply(modifier=mod.name)
    bpy.data.objects.remove(cutter, do_unlink=True)
    return True


def process_roads(mat):
    """Tiered road selection: reject non-road auxiliaries, keep the best
    populated tier, trim to the padded scene bounds, assign material."""
    for obj in list(bpy.data.objects):
        if any(k in obj.name.lower() for k in REJECTED_ROAD_KEYWORDS):
            bpy.data.objects.remove(obj, do_unlink=True)
    picked, picked_tier = [], None
    for tier, names in enumerate(ROAD_TIERS):
        objs = [bpy.data.objects[n] for n in names
                if n in bpy.data.objects]
        if objs:
            picked, picked_tier = objs, tier
            break
    for tier, names in enumerate(ROAD_TIERS):
        if picked_tier is None or tier <= picked_tier:
            continue
        for n in names:
            if n in bpy.data.objects:
                bpy.data.objects.remove(bpy.data.objects[n],
                                        do_unlink=True)
    for obj in picked:
        if trim_to_bounds(obj, *XY_BOUNDS):
            obj.data.materials.clear()
            obj.data.materials.append(mat)
    return bool(picked)


def create_terrain():
    """Ground plane sized to the bbox (x1.2 margin), named 'terrain'."""
    bpy.ops.mesh.primitive_plane_add(size=1)
    plane = bpy.context.active_object
    plane.scale = (TERRAIN_SIZE[0], TERRAIN_SIZE[1], 1.0)
    plane.name = "terrain"
    plane.data.materials.append(make_material("terrain"))
    return plane


def export_class_ply(pattern):
    """Export every mesh whose name matches ``pattern`` to one PLY."""
    bpy.ops.object.select_all(action="DESELECT")
    objs = [o for o in bpy.data.objects if pattern in o.name.lower()]
    if not objs:
        print("WARNING: no %r objects to export" % pattern)
        return
    for o in objs:
        o.select_set(True)
    path = os.path.join(OUT, "%ss.ply" % pattern)
    if bpy.app.version[0] >= 4:
        bpy.ops.wm.ply_export(filepath=path, ascii_format=True,
                              export_selected_objects=True)
    else:
        bpy.ops.export_mesh.ply(filepath=path, use_ascii=True,
                                use_selection=True)


def export_mitsuba():
    bpy.ops.export_scene.mitsuba(
        filepath=os.path.join(OUT, "scene.xml"), export_ids=True,
        axis_forward="Y", axis_up="Z")
    bpy.ops.wm.save_as_mainfile(
        filepath=os.path.join(OUT, "scene.blend"))


clean_scene()
for addon in BOOTSTRAP_ADDONS:
    ensure_addon(addon)
configure_blosm()
bpy.ops.blosm.import_data()
save_metadata()
setup_lighting()
convert_all_to_mesh()
assign_material_by_pattern("building", make_material("building"))
process_roads(make_material("road"))
create_terrain()
export_class_ply("building")
export_class_ply("road")
export_class_ply("terrain")
if WANT_SIONNA:
    export_mitsuba()
print("OSM scene export complete:", OUT)
'''
    return header + body


def fetch_osm_scene(gps_bbox: Sequence[float], out_dir: str,
                    formats: Sequence[str] = ("insite",),
                    addons_dir: Optional[str] = None,
                    timeout: float = 1800.0) -> str:
    """Fetch + export the OSM 3D scene for a GPS bbox with Blender.

    ``gps_bbox`` is (min_lat, min_lon, max_lat, max_lon). Skips work when
    ``out_dir`` already holds a buildings export (resumable pipelines).
    Returns the output directory containing buildings.ply / roads.ply /
    terrain.ply (+ scene.xml for the "sionna" format).
    """
    if os.path.exists(os.path.join(out_dir, "buildings.ply")):
        return out_dir

    blender = find_blender()
    if blender is None:
        raise BlenderNotAvailable(
            "Blender not found on PATH (set BLENDER_PATH). The OSM scene "
            "stage needs Blender with the 'blosm' addon (plus "
            "'mitsuba-blender' for Sionna scenes).")

    os.makedirs(out_dir, exist_ok=True)
    script_path = os.path.join(out_dir, "_osm_export.py")
    with open(script_path, "w") as f:
        f.write(build_blender_script(gps_bbox, out_dir, formats=formats,
                                     addons_dir=addons_dir))

    cmd = [blender, "--background", "--python", script_path]
    result = subprocess.run(cmd, capture_output=True, text=True,
                            timeout=timeout)
    log_path = os.path.join(out_dir, "blender.log")
    with open(log_path, "w") as f:
        f.write(result.stdout + "\n--- stderr ---\n" + result.stderr)
    if result.returncode != 0 or \
            not os.path.exists(os.path.join(out_dir, "buildings.ply")):
        raise RuntimeError(
            f"Blender OSM export failed (see {log_path})")
    return out_dir

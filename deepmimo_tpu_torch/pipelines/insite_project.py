"""Programmatic Wireless InSite project generation (setup/XML/txrx).

Both files are built from ``rt_params`` alone: the study area, waveform,
ray-tracing model, antenna, feature references and TX/RX sets are
constructed as data (InsiteNode trees for the .setup, remcom::rxapi:: node
structure for the XML) and serialized. No user-supplied template is
required. The emitted project is loadable by the port's converter
(``convert`` on a folder holding the generated files plus ray-tracer
outputs). Host code, copied from ``deepmimo_tpu/pipelines/insite_project.py``
on the port's ``converter/insite/tokenfmt.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..converter.insite.tokenfmt import InsiteNode, serialize_insite_text

FLOAT = "%.17g"


# ============================================================================
# .setup generation (InsiteNode tree -> begin_/end_ grammar)
# ============================================================================

def _node(kind: str, name: str = "", values: Optional[Dict] = None,
          children: Sequence[InsiteNode] = (), labels: Sequence[str] = (),
          data: Sequence[Tuple] = ()) -> InsiteNode:
    n = InsiteNode(kind=kind, name=name)
    n.values.update(values or {})
    n.labels.extend(labels)
    n.data.extend(tuple(r) for r in data)
    for ch in children:
        n.children.append(ch)
        n.values.setdefault(ch.kind, ch)
    return n


def build_setup_nodes(rt_params: Dict, bbox_xy: Optional[np.ndarray] = None
                      ) -> List[InsiteNode]:
    """Construct the .setup document for one run from rt_params alone.

    rt_params keys consumed (all optional, engine defaults otherwise):
    frequency, bandwidth, max_reflections, max_diffractions,
    max_transmissions, ray_spacing, path_depth, diffuse_* flags,
    zmin/zmax, origin_lat/origin_lon. ``bbox_xy`` is the [4, 2] study-area
    polygon (meters); a +-500 m square is used when absent.
    """
    g = rt_params.get

    if bbox_xy is None:
        r = float(g("study_area_radius", 500.0))
        bbox_xy = np.array([[-r, -r], [-r, r], [r, r], [r, -r]])
    zmin = float(g("zmin", -5.0))
    zmax = float(g("zmax", 150.0))

    output_requests = _node("OutputRequests", values={
        "ComplexImpulseResponse": True, "DirectionOfArrival": True,
        "DirectionOfDeparture": True, "Paths": True, "TimeOfArrival": True,
        "CEF": False, "DelaySpread": False, "ElectroMagneticFields": False,
        "FSPathloss": False, "FSPower": False, "MeanDirectionOfArrival": False,
        "MeanDirectionOfDeparture": False, "MeanTimeOfArrival": False,
        "Pathloss": False, "Power": False, "XPathloss": False,
    })

    model = _node("model", labels=["x3d"], values={
        "num_threads": int(g("num_threads", 4)),
        "initial_ray_mode": "uniform_sweep",
        "ray_spacing": float(g("ray_spacing", 0.25)),
        "max_reflections": int(g("max_reflections", 4)),
        "max_transmissions": int(g("max_transmissions", 0)),
        "max_wedge_diffractions": int(g("max_diffractions", 1)),
        "terrain_diffractions": "Yes" if g("terrain_diffraction") else "No",
        "foliage_model": 0,
        "foliage_attenuation_vert": 1,
        "foliage_attenuation_hor": 1,
        "plane_wave_phase_reference": "automatic",
    }, children=[output_requests])

    apg = _node("apg_acceleration", values={
        "use_apg": True,
        "path_depth": int(g("max_path_depth",
                            int(g("max_reflections", 4)) +
                            int(g("max_diffractions", 1)) +
                            int(g("max_transmissions", 0)))),
        "workflow_mode": "calculation",
    })

    diffuse = _node("diffuse_scattering", values={
        "enabled": bool(g("max_scattering", 0)),
        "diffuse_reflections": int(g("diffuse_reflections", 0)),
        "diffuse_diffractions": int(g("diffuse_diffractions", 0)),
        "diffuse_transmissions": int(g("diffuse_transmissions", 0)),
        "final_interaction_only": bool(
            g("diffuse_final_interaction_only", True)),
    })

    reference = _node("reference", labels=["cartesian", "terrain"], values={
        "latitude": float(g("origin_lat", 0.0)),
        "longitude": float(g("origin_lon", 0.0)),
        "visible": False,
    })
    boundary = _node("boundary", children=[reference], values={
        "zmin": zmin, "zmax": zmax,
        "nVertices": len(bbox_xy),
    }, data=[(float(x), float(y), 0.0) for x, y in np.asarray(bbox_xy)])

    studyarea = _node("studyarea", name="study_area",
                      children=[model, apg, diffuse, boundary])

    antenna = _node("antenna", name="Isotropic", values={
        "antenna": 0, "type": "isotropic", "waveform": 0,
        "polarization": "vertical", "power_threshold": -250,
    })

    waveform = _node("Waveform", name="Sinusoid", values={
        "CarrierFrequency": float(g("frequency", 3.5e9)),
        "bandwidth": float(g("bandwidth", 10e6)),
        "waveform": 0, "type": "sinusoid", "phase": 0.0,
    })

    # Real InSite projects wrap everything in one begin_<project> node
    # (globals, then studyarea / antenna / waveform children).
    glob = _node("globals", values={"longitude": float(g("origin_lon", 0.0)),
                                    "latitude": float(g("origin_lat", 0.0))})
    project = _node("project", name=str(g("name", "project")),
                    values={"project_id": 1},
                    children=[glob, studyarea, antenna, waveform])
    return [project]


# ============================================================================
# Project XML generation (remcom::rxapi:: node structure)
# ============================================================================

def _xml_double(tag: str, value: float) -> str:
    return (f"<{tag}><remcom::rxapi::Double Value=\"{FLOAT % value}\"/>"
            f"</{tag}>")


def _xml_point(x: float, y: float, z: float) -> str:
    return f"""<ProjectedPoint>
      <remcom::rxapi::CartesianPoint>
        {_xml_double("X", x)}
        {_xml_double("Y", y)}
        {_xml_double("Z", z)}
      </remcom::rxapi::CartesianPoint>
    </ProjectedPoint>"""


def _xml_antenna(kind: str, rotation=(0.0, 0.0, 0.0),
                 polarization: str = "Vertical",
                 power_threshold: float = -250.0) -> str:
    """Transmitter/Receiver block with an isotropic antenna + rotations
    (node structure per the InSite project format; both converters'
    readers consume exactly these fields)."""
    return f"""<{kind}><remcom::rxapi::{kind}>
      <Antenna><remcom::rxapi::Isotropic>
        <Polarization>
          <remcom::rxapi::PolarizationEnum Value="{polarization}"/>
        </Polarization>
        {_xml_double("PowerThreshold", power_threshold)}
      </remcom::rxapi::Isotropic></Antenna>
      <AntennaRotations><remcom::rxapi::Rotations>
        {_xml_double("Bearing", rotation[0])}
        {_xml_double("Pitch", rotation[1])}
        {_xml_double("Roll", rotation[2])}
      </remcom::rxapi::Rotations></AntennaRotations>
      </remcom::rxapi::{kind}></{kind}>"""


def xml_txrx_point_set(name: str, points: np.ndarray, output_id: int,
                       is_tx: bool, rotation=(0.0, 0.0, 0.0)) -> str:
    pts = "\n".join(_xml_point(*p) for p in np.atleast_2d(points))
    role = _xml_antenna("Transmitter" if is_tx else "Receiver", rotation)
    return f"""<TxRxSet><remcom::rxapi::PointSet>
      <ControlPoints><remcom::rxapi::ProjectedPointList>
        {pts}
      </remcom::rxapi::ProjectedPointList></ControlPoints>
      <OutputID><remcom::rxapi::Integer Value="{output_id}"/></OutputID>
      <ShortDescription><remcom::rxapi::String Value="{name}"/>
      </ShortDescription>
      {role}
    </remcom::rxapi::PointSet></TxRxSet>"""


def xml_txrx_grid_set(name: str, origin: np.ndarray, length_x: float,
                      length_y: float, spacing: float, output_id: int,
                      rotation=(0.0, 0.0, 0.0)) -> str:
    return f"""<TxRxSet><remcom::rxapi::GridSet>
      <ControlPoints><remcom::rxapi::ProjectedPointList>
        {_xml_point(*origin)}
      </remcom::rxapi::ProjectedPointList></ControlPoints>
      {_xml_double("LengthX", length_x)}
      {_xml_double("LengthY", length_y)}
      {_xml_double("Spacing", spacing)}
      <OutputID><remcom::rxapi::Integer Value="{output_id}"/></OutputID>
      <ShortDescription><remcom::rxapi::String Value="{name}"/>
      </ShortDescription>
      {_xml_antenna("Receiver", rotation)}
    </remcom::rxapi::GridSet></TxRxSet>"""


def _xml_geometry(feature_file: str) -> str:
    kind = "City" if feature_file.endswith(".city") else "Terrain"
    return f"""<Geometry><remcom::rxapi::{kind}Geometry>
      <Filename><remcom::rxapi::String Value="{feature_file}"/></Filename>
    </remcom::rxapi::{kind}Geometry></Geometry>"""


def build_project_xml(name: str, rt_params: Dict,
                      txrx_sets_xml: Sequence[str],
                      feature_files: Sequence[str] = (),
                      bbox_xy: Optional[np.ndarray] = None) -> str:
    """Assemble the full InSite project XML from generated components."""
    g = rt_params.get
    if bbox_xy is None:
        r = float(g("study_area_radius", 500.0))
        bbox_xy = np.array([[-r, -r], [-r, r], [r, r], [r, -r]])
    vertices = "\n".join(_xml_point(float(x), float(y), 0.0)
                         for x, y in np.asarray(bbox_xy))
    geometries = "\n".join(_xml_geometry(f) for f in feature_files)
    sets = "\n".join(txrx_sets_xml)
    return f"""<!DOCTYPE InSite>
<InSite version="3.3.0.4">
  <remcom::rxapi::Job>
    <OutputPrefix><remcom::rxapi::String Value="{name}"/></OutputPrefix>
    <PathResultsDatabase><remcom::rxapi::PathResultsDatabase>
      <Filename><remcom::rxapi::String Value="{name}.sqlite"/></Filename>
    </remcom::rxapi::PathResultsDatabase></PathResultsDatabase>
    <Model><remcom::rxapi::X3DModel>
      {_xml_double("CarrierFrequency", float(g("frequency", 3.5e9)))}
      {_xml_double("Bandwidth", float(g("bandwidth", 10e6)) / 1e6)}
      {_xml_double("RaySpacing", float(g("ray_spacing", 0.25)))}
      <MaxReflections><remcom::rxapi::Integer Value="{int(g("max_reflections", 4))}"/></MaxReflections>
      <MaxWedgeDiffractions><remcom::rxapi::Integer Value="{int(g("max_diffractions", 1))}"/></MaxWedgeDiffractions>
      <MaxTransmissions><remcom::rxapi::Integer Value="{int(g("max_transmissions", 0))}"/></MaxTransmissions>
    </remcom::rxapi::X3DModel></Model>
    <StudyArea><remcom::rxapi::StudyArea>
      {_xml_double("MinZ", float(g("zmin", -5.0)))}
      {_xml_double("MaxZ", float(g("zmax", 150.0)))}
      <Boundary><remcom::rxapi::ProjectedPointList>
        {vertices}
      </remcom::rxapi::ProjectedPointList></Boundary>
    </remcom::rxapi::StudyArea></StudyArea>
    <Scene><remcom::rxapi::Scene>
      <GeometryList><remcom::rxapi::GeometryList>
        {geometries}
      </remcom::rxapi::GeometryList></GeometryList>
      <TxRxSetList><remcom::rxapi::TxRxSetList>
        {sets}
      </remcom::rxapi::TxRxSetList></TxRxSetList>
    </remcom::rxapi::Scene></Scene>
  </remcom::rxapi::Job>
</InSite>"""


# ============================================================================
# Project writer
# ============================================================================

def infer_grid(rx_pos: np.ndarray):
    """(origin, length_x, length_y, spacing) if rx_pos is a uniform
    z-constant grid in row-major y-then-x order, else None."""
    rx = np.atleast_2d(np.asarray(rx_pos, dtype=np.float64))
    if len(rx) < 4 or not np.allclose(rx[:, 2], rx[0, 2]):
        return None
    xs = np.unique(np.round(rx[:, 0], 9))
    ys = np.unique(np.round(rx[:, 1], 9))
    if len(xs) * len(ys) != len(rx) or len(xs) < 2 or len(ys) < 2:
        return None
    dx = np.diff(xs)
    dy = np.diff(ys)
    if not (np.allclose(dx, dx[0]) and np.allclose(dy, dy[0]) and
            np.isclose(dx[0], dy[0])):
        return None
    expect = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    if not np.allclose(rx[:, :2], expect):
        return None
    origin = np.array([xs[0], ys[0], rx[0, 2]])
    return origin, float(xs[-1] - xs[0]), float(ys[-1] - ys[0]), float(dx[0])


def write_insite_project(row_dir: str, out_dir: str, tx_pos: np.ndarray,
                         rx_pos: np.ndarray, rt_params: Dict,
                         feature_files: Sequence[str] = ()) -> str:
    """Write a complete, loadable InSite project from rt_params alone.

    Emits project.setup + project.xml + project.txrx into ``out_dir``;
    returns the .setup path. ``feature_files`` are .city/.ter geometry
    files (referenced from the XML; copied by the caller).
    """
    os.makedirs(out_dir, exist_ok=True)
    name = str(rt_params.get("name", "project"))

    bbox = rt_params.get("bbox_xy")
    setup_text = serialize_insite_text(
        build_setup_nodes(rt_params,
                          None if bbox is None else np.asarray(bbox)))
    setup_path = os.path.join(out_dir, f"{name}.setup")
    with open(setup_path, "w") as f:
        f.write(setup_text)

    sets = [xml_txrx_point_set("BS", np.atleast_2d(tx_pos), 1, is_tx=True,
                               rotation=rt_params.get("bs_rotation",
                                                      (0.0, 0.0, 0.0)))]
    grid = infer_grid(rx_pos)
    if grid is not None:
        origin, lx, ly, sp = grid
        sets.append(xml_txrx_grid_set("users", origin, lx, ly, sp, 2))
    else:
        sets.append(xml_txrx_point_set("users", np.atleast_2d(rx_pos), 2,
                                       is_tx=False))

    xml_text = build_project_xml(name, rt_params, sets, feature_files,
                                 None if bbox is None else np.asarray(bbox))
    with open(os.path.join(out_dir, f"{name}.xml"), "w") as f:
        f.write(xml_text)

    _write_txrx(os.path.join(out_dir, f"{name}.txrx"), tx_pos, rx_pos)
    return setup_path


def _write_txrx(path: str, tx_pos: np.ndarray, rx_pos: np.ndarray) -> None:
    """Write a .txrx file: TX points + an RX point list."""
    lines = ["Format type:keyword version: 1.1.0"]

    for i, pos in enumerate(np.atleast_2d(tx_pos)):
        lines += [
            f"begin_<points> BS_{i}",
            "project_id 1",
            "begin_<location>",
            "begin_<reference>",
            "cartesian",
            "end_<reference>",
            "nVertices 1",
            f"{pos[0]:.6f} {pos[1]:.6f} {pos[2]:.6f}",
            "end_<location>",
            "transmitter",
            "end_<points>",
        ]

    rx_pos = np.atleast_2d(rx_pos)
    lines += [
        "begin_<points> users",
        "project_id 2",
        "begin_<location>",
        "begin_<reference>",
        "cartesian",
        "end_<reference>",
        f"nVertices {len(rx_pos)}",
    ]
    lines += [f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in rx_pos]
    lines += [
        "end_<location>",
        "receiver",
        "end_<points>",
    ]

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

"""TX/RX set extraction from Wireless InSite project XML files.

The project XML stores TxRx sets under remcom::rxapi:: namespaced nodes
(GridSet / PointSet / ...), each with ControlPoints, grid dimensions and
Transmitter/Receiver antenna blocks. Copied from
``deepmimo_tpu/converter/insite/txrx.py``, on the port's ``txrx``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...txrx import TxRxSet


def xml_to_dict(element: ET.Element):
    """Recursively convert an InSite XML element to nested dicts.

    Leaf elements carry a ``Value`` attribute, coerced to int/float/bool.
    Repeated child tags become lists.
    """
    if "Value" in element.attrib:
        value = element.attrib["Value"]
        try:
            return float(value) if "." in value else int(value)
        except ValueError:
            if value.lower() == "true":
                return True
            if value.lower() == "false":
                return False
            return value

    result: Dict[str, Any] = dict(element.attrib)
    for child in element:
        tag = child.tag.replace("remcom::rxapi::", "remcom_rxapi_")
        child_data = xml_to_dict(child)
        if tag in result:
            if not isinstance(result[tag], list):
                result[tag] = [result[tag]]
            result[tag].append(child_data)
        else:
            result[tag] = child_data
    if not result and not element.attrib:
        return None
    return result


def parse_insite_xml(xml_file: str) -> Dict[str, Any]:
    with open(xml_file, "r", encoding="utf-8") as f:
        content = f.read()
    content = content.replace("<!DOCTYPE InSite>", "")
    content = content.replace("::", "_")
    return xml_to_dict(ET.fromstring(content))


class InsiteTxRxSet:
    """One GridSet/PointSet from the project XML."""

    def __init__(self, data: Dict[str, Any], set_type: str):
        self.data = data
        self.set_type = set_type  # 'grid' | 'point'

    # -- basic fields --------------------------------------------------------
    @property
    def output_id(self) -> int:
        return self.data["OutputID"]["remcom_rxapi_Integer"]

    @property
    def short_description(self) -> str:
        return self.data["ShortDescription"]["remcom_rxapi_String"]

    @property
    def control_points(self) -> List[Dict[str, float]]:
        pts = self.data["ControlPoints"][
            "remcom_rxapi_ProjectedPointList"]["ProjectedPoint"]
        if isinstance(pts, dict):
            pts = [pts]
        return [{
            "x": p["remcom_rxapi_CartesianPoint"]["X"]["remcom_rxapi_Double"],
            "y": p["remcom_rxapi_CartesianPoint"]["Y"]["remcom_rxapi_Double"],
            "z": p["remcom_rxapi_CartesianPoint"]["Z"]["remcom_rxapi_Double"],
        } for p in pts]

    def _grid_field(self, key: str) -> Optional[float]:
        return self.data.get(key, {}).get("remcom_rxapi_Double")

    # -- roles ---------------------------------------------------------------
    def _side(self, role: str) -> Optional[Dict[str, Any]]:
        if role not in self.data:
            return None
        return self.data[role][f"remcom_rxapi_{role}"]

    @property
    def is_tx(self) -> bool:
        return "Transmitter" in self.data

    @property
    def is_rx(self) -> bool:
        return "Receiver" in self.data

    # -- geometry ------------------------------------------------------------
    def generate_points(self) -> np.ndarray:
        """All point positions: expanded grid or control points verbatim."""
        if self.set_type == "grid":
            origin = self.control_points[0]
            lx = self._grid_field("LengthX")
            ly = self._grid_field("LengthY")
            spacing = self._grid_field("Spacing")
            nx = int(lx / spacing) + 1
            ny = int(ly / spacing) + 1
            x = np.linspace(origin["x"], origin["x"] + lx, nx)
            y = np.linspace(origin["y"], origin["y"] + ly, ny)
            xx, yy = np.meshgrid(x, y)
            zz = np.full_like(xx, origin["z"])
            return np.column_stack((xx.ravel(), yy.ravel(), zz.ravel()))
        return np.array([[p["x"], p["y"], p["z"]]
                         for p in self.control_points])

    def to_txrx_set(self, id_: int, n_points: int) -> TxRxSet:
        return TxRxSet(
            name=self.short_description,
            id_orig=self.output_id,
            id=id_,
            is_tx=self.is_tx,
            is_rx=self.is_rx,
            num_points=n_points,
            num_active_points=n_points,
            num_ant=1,
            dual_pol=False,
        )


def get_insite_sets_from_xml(xml_file: str) -> List[InsiteTxRxSet]:
    data = parse_insite_xml(xml_file)
    txrx_list = (data["remcom_rxapi_Job"]["Scene"]["remcom_rxapi_Scene"]
                 ["TxRxSetList"]["remcom_rxapi_TxRxSetList"]["TxRxSet"])
    if isinstance(txrx_list, dict):
        txrx_list = [txrx_list]
    out = []
    for entry in txrx_list:
        set_kind = list(entry.keys())[0]
        set_type = "grid" if set_kind == "remcom_rxapi_GridSet" else "point"
        out.append(InsiteTxRxSet(entry[set_kind], set_type))
    return out


def read_txrx(folder: str) -> Tuple[Dict[str, Any], Dict[int, np.ndarray]]:
    """Read TX/RX sets from the project XML in ``folder``.

    Returns (txrx_dict keyed 'txrx_set_<id>', {id: point positions}).
    """
    xml_files = list(Path(folder).glob("*.xml"))
    if not xml_files:
        raise ValueError(f"No .xml file found in {folder}")
    if len(xml_files) > 1:
        raise ValueError(f"Multiple .xml files found in {folder}")

    print(f"Reading xml file: {os.path.basename(str(xml_files[0]))}")
    insite_sets = get_insite_sets_from_xml(str(xml_files[0]))

    txrx_dict: Dict[str, Any] = {}
    point_locations: Dict[int, np.ndarray] = {}
    for i, iset in enumerate(insite_sets):
        points = iset.generate_points()
        tset = iset.to_txrx_set(id_=i, n_points=len(points))
        txrx_dict[f"txrx_set_{i}"] = tset.to_dict()
        point_locations[i] = points
    return txrx_dict, point_locations

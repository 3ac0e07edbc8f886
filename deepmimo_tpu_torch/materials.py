"""Material data model (scenario-format schema).

Electromagnetic + scattering material description stored in params.json under
``materials`` (scattering model after Degli-Esposti et al., IEEE TAP 2007).
Host code, copied from ``deepmimo_tpu.materials`` so the port reads the
same scenarios without importing the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict, astuple
from typing import ClassVar, Dict, List, Set


@dataclass
class Material:
    """Material with electrical and diffuse-scattering properties."""

    SCATTERING_NONE: ClassVar[str] = "none"
    SCATTERING_LAMBERTIAN: ClassVar[str] = "lambertian"
    SCATTERING_DIRECTIVE: ClassVar[str] = "directive"

    id: int = -1
    name: str = ""

    permittivity: float = 0.0
    conductivity: float = 0.0

    scattering_model: str = SCATTERING_NONE
    scattering_coefficient: float = 0.0
    cross_polarization_coefficient: float = 0.0

    # Directive scattering lobe parameters
    alpha_r: float = 4.0
    alpha_i: float = 4.0
    lambda_param: float = 0.5

    roughness: float = -1.0
    thickness: float = -1.0

    vertical_attenuation: float = 0.0
    horizontal_attenuation: float = 0.0


class MaterialList:
    """Deduplicating container of materials with automatic ID assignment."""

    def __init__(self):
        self._materials: List[Material] = []

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return self._materials[idx]
        out = MaterialList()
        out.add_materials([self._materials[i] for i in idx])
        return out

    def __len__(self) -> int:
        return len(self._materials)

    def __iter__(self):
        return iter(self._materials)

    def __repr__(self) -> str:
        return str(self._materials)

    def add_materials(self, materials: List[Material]) -> None:
        self._materials.extend(materials)
        self._filter_duplicates()
        for i, mat in enumerate(self._materials):
            mat.id = i

    def _filter_duplicates(self) -> None:
        unique: List[Material] = []
        seen: Set[tuple] = set()
        for mat in self._materials:
            key = astuple(mat)[1:]  # all fields except id
            if key not in seen:
                seen.add(key)
                unique.append(mat)
        self._materials = unique

    def to_dict(self) -> Dict:
        return {f"material_{mat.id}": asdict(mat) for mat in self._materials}

    @classmethod
    def from_dict(cls, materials_dict: Dict) -> "MaterialList":
        out = cls()
        materials = []
        for _, mat_data in materials_dict.items():
            data = dict(mat_data)
            for key, value in data.items():
                if isinstance(value, str):
                    try:
                        data[key] = float(value)
                    except ValueError:
                        pass
            materials.append(Material(**data))
        out.add_materials(materials)
        return out

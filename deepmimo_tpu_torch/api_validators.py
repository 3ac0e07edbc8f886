"""Server-side upload validators for the scenario database.

CLI-style validators taking a scenario zip path and emitting
``{"valid": bool, "error": str}`` JSON: the upload-validation contract of
the scenario database. Copied from ``deepmimo_tpu/api_validators.py``.
"""

from __future__ import annotations

import json
import os
import sys
import zipfile
from typing import Dict

from . import consts as c

ALLOWED_EXTENSIONS = {".mat", ".json", ".city", ".ter", ".veg", ".txrx",
                      ".setup", ".xml", ".png", ".zip"}
MAX_FILES = 2000
MAX_SIZE_BYTES = 20 * (1 << 30)  # 20 GB extracted


def validate_extensions(zip_path: str) -> Dict:
    """Check the archive only contains allowed file types."""
    try:
        with zipfile.ZipFile(zip_path) as zf:
            names = zf.namelist()
    except (zipfile.BadZipFile, OSError) as e:
        return {"valid": False, "error": f"unreadable zip: {e}"}
    if len(names) > MAX_FILES:
        return {"valid": False,
                "error": f"too many files ({len(names)} > {MAX_FILES})"}
    for name in names:
        if name.endswith("/"):
            continue
        ext = os.path.splitext(name)[1].lower()
        if ext not in ALLOWED_EXTENSIONS:
            return {"valid": False,
                    "error": f"extension not allowed: {name}"}
    return {"valid": True, "error": ""}


def validate_structure(zip_path: str) -> Dict:
    """Check the archive is a loadable scenario: params.json + matrices."""
    try:
        with zipfile.ZipFile(zip_path) as zf:
            names = [n for n in zf.namelist() if not n.endswith("/")]
            basenames = {os.path.basename(n) for n in names}
            if f"{c.PARAMS_FILENAME}.json" not in basenames:
                return {"valid": False, "error": "missing params.json"}
            params_name = next(n for n in names if os.path.basename(n) ==
                               f"{c.PARAMS_FILENAME}.json")
            params = json.loads(zf.read(params_name))
    except Exception as e:
        return {"valid": False, "error": f"unreadable scenario: {e}"}

    for key in (c.RT_PARAMS_PARAM_NAME, c.TXRX_PARAM_NAME,
                c.SCENE_PARAM_NAME):
        if key not in params:
            return {"valid": False, "error": f"params.json missing '{key}'"}

    # At least one TX-RX pair's core matrices must be present
    has_power = any(os.path.basename(n).startswith("power_t")
                    for n in names)
    if not has_power:
        return {"valid": False, "error": "no path matrices (power_t*.mat)"}

    total = sum(zi.file_size for zi in zipfile.ZipFile(zip_path).infolist())
    if total > MAX_SIZE_BYTES:
        return {"valid": False,
                "error": f"extracted size {total} exceeds limit"}
    return {"valid": True, "error": ""}


def validate_scenario_zip(zip_path: str) -> Dict:
    """Run all validators; first failure wins."""
    for validator in (validate_extensions, validate_structure):
        result = validator(zip_path)
        if not result["valid"]:
            return result
    return {"valid": True, "error": ""}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print(json.dumps({"valid": False,
                          "error": "usage: validate <scenario.zip>"}))
        return 2
    result = validate_scenario_zip(argv[0])
    print(json.dumps(result))
    return 0 if result["valid"] else 1


if __name__ == "__main__":
    sys.exit(main())

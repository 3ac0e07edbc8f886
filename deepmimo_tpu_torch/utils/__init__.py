"""Utility subpackage: containers, scenario paths and naming, mat and JSON
IO, zip, profiling (``utils.profiling``, imported on its own)."""

from .dotdict import DotDict, PrintIfVerbose, compare_two_dicts
from .files import (
    check_scen_name,
    get_available_scenarios,
    get_mat_filename,
    get_params_path,
    get_scenario_folder,
    get_scenarios_dir,
    get_txrx_str_id,
    load_dict_from_json,
    load_mat,
    save_dict_as_json,
    save_mat,
    unzip,
    zip,
)

__all__ = [
    "DotDict", "PrintIfVerbose", "compare_two_dicts", "check_scen_name",
    "get_available_scenarios", "get_mat_filename", "get_params_path",
    "get_scenario_folder", "get_scenarios_dir", "get_txrx_str_id",
    "load_dict_from_json", "load_mat", "save_dict_as_json", "save_mat",
    "unzip", "zip",
]

"""Utility subpackage: containers, scenario paths and naming."""

from .dotdict import DotDict, compare_two_dicts
from .files import (
    check_scen_name,
    get_mat_filename,
    get_scenario_folder,
    get_scenarios_dir,
    get_txrx_str_id,
    load_dict_from_json,
)

__all__ = [
    "DotDict", "compare_two_dicts", "check_scen_name", "get_mat_filename",
    "get_scenario_folder", "get_scenarios_dir", "get_txrx_str_id",
    "load_dict_from_json",
]

"""Converters: other scenario formats -> the port's datasets.

Only the legacy v3 loader is ported; the ray-tracer converters (InSite,
Sionna, AODT) wait for ROADMAP item 15.
"""

from .legacy_v3 import is_v3_scenario, load_v3_scenario

__all__ = ["is_v3_scenario", "load_v3_scenario"]

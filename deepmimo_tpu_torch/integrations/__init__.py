"""Downstream integrations: export to the legacy v3 MATLAB layout.

The Sionna adapter and the NR CDL export wait for ROADMAP item 17.
"""

from .matlab_export import export_matlab

__all__ = ["export_matlab"]

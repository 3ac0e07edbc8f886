"""Converters: ray-tracer outputs and other scenario formats -> the port's
scenarios.

``convert`` turns a Wireless InSite, Sionna RT or AODT output folder into
the on-disk format that ``load`` reads (host code: numpy, scipy, pickle,
XML; pandas only inside the AODT reader); the legacy v3 loader reads
DeepMIMO v3 folders.
"""

from .converter import convert
from .legacy_v3 import is_v3_scenario, load_v3_scenario

__all__ = ["convert", "is_v3_scenario", "load_v3_scenario"]

"""Downstream integrations: Sionna link-level sims, MATLAB toolchain.

``DeepMIMOSionnaAdapter`` yields Sionna CIRs from the port's time-domain
channels, ``export_cdl`` / ``save_cdl_mat`` / ``synthesize_cdl_cir`` the
5G NR CDL parameters for MATLAB's ``nrCDLChannel``, ``export_matlab`` the
legacy v3 folder that the MATLAB generator files read.
"""

import os as _os

from .sionna_adapter import DeepMIMOSionnaAdapter
from .matlab_export import export_matlab
from .nr_cdl import CDLConfig, export_cdl, save_cdl_mat, synthesize_cdl_cir


def matlab_code_path() -> str:
    """Folder of the shipped MATLAB generator (.m files).

    ``export_matlab(dataset, out)`` + ``addpath(matlab_code_path())`` +
    ``DeepMIMO_TPU_generate(out, default_params())`` reproduces channel
    generation inside MATLAB.
    """
    return _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                         "matlab")


__all__ = ["DeepMIMOSionnaAdapter", "export_matlab", "matlab_code_path",
           "CDLConfig", "export_cdl", "save_cdl_mat", "synthesize_cdl_cir"]

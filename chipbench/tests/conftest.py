import pytest


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.fixture
def cpu_port():
    """The port on the CPU, its device set back afterwards."""
    import deepmimo_tpu_torch as dmt
    old = dmt.config.get("device")
    dmt.config.set("device", "cpu")
    yield dmt
    dmt.config.set("device", old)

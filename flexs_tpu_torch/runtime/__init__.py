"""Runners that keep every round's work on the device."""
from flexs_tpu_torch.runtime.jit_runner import (  # noqa: F401
    AdaleadConfig,
    DeviceAdaleadNAM,
    run_adalead_nam,
)

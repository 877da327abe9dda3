"""Runners that keep every round's work on the device, and their trained surrogates."""
from flexs_tpu_torch.runtime import surrogate  # noqa: F401
from flexs_tpu_torch.runtime.jit_runner import (  # noqa: F401
    AdaleadConfig,
    DeviceAdaleadNAM,
    run_adalead_nam,
)
from flexs_tpu_torch.runtime.surrogate import SurrogateSpec  # noqa: F401

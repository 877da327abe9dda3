"""Runners that keep every round's work on the device, and their trained surrogates."""
from flexs_tpu_torch.runtime import surrogate  # noqa: F401
from flexs_tpu_torch.runtime.bo_runner import (  # noqa: F401
    DeviceBONAM,
    run_bo_nam,
)
from flexs_tpu_torch.runtime.cbas_runner import (  # noqa: F401
    DeviceCbASNAM,
    VAEConfig,
    run_cbas_nam,
)
from flexs_tpu_torch.runtime.cmaes_runner import (  # noqa: F401
    DeviceCMAESNAM,
    run_cmaes_nam,
)
from flexs_tpu_torch.runtime.dqn_runner import (  # noqa: F401
    DeviceDQNNAM,
    run_dqn_nam,
)
from flexs_tpu_torch.runtime.dyna_ppo_mutative_runner import (  # noqa: F401
    DeviceDynaPPOMutativeNAM,
    run_dyna_ppo_mutative_nam,
)
from flexs_tpu_torch.runtime.dyna_ppo_runner import (  # noqa: F401
    DeviceDynaPPONAM,
    run_dyna_ppo_nam,
)
from flexs_tpu_torch.runtime.ga_runner import (  # noqa: F401
    DeviceGeneticAlgorithmNAM,
    run_ga_nam,
)
from flexs_tpu_torch.runtime.gpr_bo_runner import (  # noqa: F401
    DeviceGPRBONAM,
    run_gpr_bo_nam,
)
from flexs_tpu_torch.runtime.jit_runner import (  # noqa: F401
    AdaleadConfig,
    DeviceAdaleadNAM,
    run_adalead_nam,
)
from flexs_tpu_torch.runtime.ppo_runner import (  # noqa: F401
    DevicePPONAM,
    run_ppo_nam,
)
from flexs_tpu_torch.runtime.random_runner import (  # noqa: F401
    DeviceRandomNAM,
    run_random_nam,
)
from flexs_tpu_torch.runtime.surrogate import SurrogateSpec  # noqa: F401

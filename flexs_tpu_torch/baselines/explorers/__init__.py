"""Baseline explorers."""
from flexs_tpu_torch.baselines.explorers.adalead import Adalead  # noqa: F401
from flexs_tpu_torch.baselines.explorers.bo import BO, GPR_BO  # noqa: F401
from flexs_tpu_torch.baselines.explorers import environments  # noqa: F401
from flexs_tpu_torch.baselines.explorers.cbas_dbas import VAE, CbAS  # noqa: F401
from flexs_tpu_torch.baselines.explorers.cmaes import CMAES  # noqa: F401
from flexs_tpu_torch.baselines.explorers.dqn import DQN  # noqa: F401
from flexs_tpu_torch.baselines.explorers.dyna_ppo import (  # noqa: F401
    DynaPPO,
    DynaPPOEnsemble,
    DynaPPOMutative,
)
from flexs_tpu_torch.baselines.explorers.genetic_algorithm import (  # noqa: F401
    GeneticAlgorithm,
)
from flexs_tpu_torch.baselines.explorers.ppo import PPO  # noqa: F401
from flexs_tpu_torch.baselines.explorers.random import Random  # noqa: F401

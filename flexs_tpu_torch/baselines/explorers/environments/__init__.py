"""Environments for RL-based explorers (PPO, DynaPPO)."""
from flexs_tpu_torch.baselines.explorers.environments.ppo import (  # noqa: F401
    PPOEnvironment,
)

"""RL building blocks (PPO) for the RL-based explorers.

The reference delegates its RL stack to TF-Agents (reference ppo.py,
dyna_ppo.py); here the agent is a small PyTorch actor-critic trained with a
clipped-surrogate PPO update, as in the JAX package's `rl` subpackage.
"""
from flexs_tpu_torch.rl.ppo import ActorCritic, PPOAgent  # noqa: F401

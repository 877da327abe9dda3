"""PPO explorer.

Contract (reference baselines/explorers/ppo.py):
  * name "PPO_Agent" (:46); actor/value nets fc[128], 10 train epochs per
    round (:65-91) — here the TF-Agents PPOAgent is replaced by the
    clipped-surrogate agent of flexs_tpu_torch.rl.ppo with standard
    PPO hyperparameters (Adam 3e-4, entropy 0.01, observation
    normalization; documented deviation from the reference's bare 1e-5 —
    TF-Agents' built-in normalizers supplied the missing learning signal).
  * Collect full episodes on the mutation-walk environment until the
    model-query budget is spent (:143-146), then ONE training call on the
    gathered trajectories (:147-149).
  * Episode-boundary observer records the episode's final sequence and
    reseeds the environment from a random sequence within 90% of the best
    fitness found so far (:93-116).
  * Proposes the top `sequences_batch_size` novel sequences by recorded
    fitness (:152-160).
"""
from typing import Optional, Tuple

import numpy as np
import pandas as pd

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.explorers.environments.ppo import PPOEnvironment
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.rl.ppo import PPOAgent


class PPO(Explorer):
    """Explorer that collects mutation-walk episodes and trains PPO on them."""

    def __init__(
        self,
        model: Model,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        alphabet: str,
        log_file: Optional[str] = None,
        seed: int = 0,
        device=None,
    ):
        """Create PPO explorer; its agent lives on `device` (default "cuda")."""
        super().__init__(
            model,
            "PPO_Agent",
            rounds,
            sequences_batch_size,
            model_queries_per_batch,
            starting_sequence,
            log_file,
        )
        self.alphabet = as_alphabet(alphabet)
        self._rng = np.random.default_rng(seed)

        self.env = PPOEnvironment(
            alphabet=self.alphabet,
            starting_seq=starting_sequence,
            model=self.model,
            max_num_steps=self.model_queries_per_batch,
        )
        obs_dim = self.env.seq_len * len(self.alphabet)
        self.agent = PPOAgent(
            obs_dim=obs_dim,
            num_actions=self.env.num_actions,
            fc_layers=(128,),
            train_epochs=10,
            seed=seed,
            device=device,
        )

    def _reseed_env(self, sequences):
        """Reseed the walk from the top (>= 90% of best) recorded sequences."""
        if not sequences:
            return
        top_fitness = max(sequences.values())
        top_sequences = [
            seq for seq, fit in sequences.items() if fit >= 0.9 * top_fitness
        ]
        pool = top_sequences if top_sequences else list(sequences.keys())
        self.env.seq = str(self._rng.choice(pool))

    def propose_sequences(
        self, measured_sequences_data: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top `sequences_batch_size` sequences for evaluation."""
        sequences = {}
        traj = {k: [] for k in ["obs", "actions", "logprobs", "rewards", "dones", "values"]}

        previous_model_cost = self.model.cost
        while self.model.cost - previous_model_cost < self.model_queries_per_batch:
            obs = self.env.reset()
            done = False
            while not done:
                flat = obs.reshape(1, -1)
                action, logprob, value = self.agent.act(flat)
                next_obs, reward, done = self.env.step(int(action[0]))

                traj["obs"].append(flat[0])
                traj["actions"].append(int(action[0]))
                traj["logprobs"].append(float(logprob[0]))
                traj["rewards"].append(float(reward))
                traj["dones"].append(done)
                traj["values"].append(float(value[0]))
                obs = next_obs

                if self.model.cost - previous_model_cost >= self.model_queries_per_batch:
                    done = True

            # Episode boundary: record the final sequence and reseed.
            seq = self.env.get_state_string()
            sequences[seq] = self.env.fitness
            self._reseed_env(sequences)

        self.agent.train({k: np.asarray(v) for k, v in traj.items()})

        sequences = {
            seq: fitness
            for seq, fitness in sequences.items()
            if seq not in set(measured_sequences_data["sequence"])
        }
        if not sequences:
            # Degenerate case (tiny budgets): fall back to the env seed.
            seq = self.env.seq
            sequences = {seq: float(np.asarray(self.model.get_fitness([seq]))[0])}

        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        sorted_order = np.argsort(preds)[: -self.sequences_batch_size : -1]

        return new_seqs[sorted_order], preds[sorted_order]

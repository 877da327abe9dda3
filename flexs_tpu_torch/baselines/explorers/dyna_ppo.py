"""DyNA-PPO explorers (constructive and mutative).

Contract (reference baselines/explorers/dyna_ppo.py):
  * `DynaPPOEnsemble` (:32-130): 11 default candidate models (3 neural +
    8 sklearn); `train` holds out 25% and records per-model Pearson r^2
    (constant predictions score 0); `_fitness_function` averages only the
    models with r^2 >= 0.5, falling back to the single best otherwise.
  * `DynaPPO` (:133-319): name "DynaPPO_Agent_{E}_{M}"; constructive
    batched env (`env_batch_size` parallel episodes); per round, an
    experiment-based phase collects episodes scored on the TRUE landscape
    until `sequences_batch_size` budget is spent, trains PPO, clears; then
    `num_model_rounds` model-based phases each spending
    `model_queries_per_batch / num_model_rounds` surrogate queries; top
    novel sequences from the model phase are proposed.
  * `DynaPPOMutative` (:322-524): same ensemble; mutates the full
    sequence; experiment budget annealed
    `(rounds - r + 1) / rounds * batch / 2` (:475-481); episode-boundary
    reseeding from sequences within 90% of the best.
  * The PPO agent (TF-Agents in the reference, :213-231) is the
    clipped-surrogate agent of flexs_tpu_torch.rl.ppo (fc[128], 10 epochs).
    Documented deviation: the agent uses standard PPO hyperparameters
    (Adam 3e-4, entropy 0.01, running observation normalization) instead
    of the reference's bare Adam 1e-5 — TF-Agents got its learning signal
    from built-in observation/reward normalizers the raw rate hides.

Networks, generators and the density cache live on `device` (default
"cuda"); the explorers' own draws come from seeded numpy Generators in the
JAX package's order.  sklearn is imported only for the reference's sklearn
member stack (`tpu_native_members=False`).
"""
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines import models as baseline_models
from flexs_tpu_torch.baselines.explorers.environments.dyna_ppo import (
    DynaPPOEnvironment as DynaPPOEnv,
)
from flexs_tpu_torch.baselines.explorers.environments.dyna_ppo import (
    DynaPPOEnvironmentMutative as DynaPPOEnvMut,
)
from flexs_tpu_torch.baselines.models.adaptive_ensemble import _pearson_r2
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.model import Model
from flexs_tpu_torch.rl.ppo import PPOAgent
from flexs_tpu_torch.utils import sequence_utils as s_utils


def tpu_native_default_models(seq_len: int, alphabet: str, device=None) -> List[Model]:
    """The 11 default ensemble members, each with a tensor implementation.

    The counterparts of the JAX package's device-side members (reference
    dyna_ppo.py:51-85), at its widths and defaults: the three nets, exact
    linear regression, tree ensembles, k-NN, Lasso, Bayesian ridge, the
    Gaussian process, gradient boosting and the extra tree, all on
    `device` (default "cuda").
    """
    dev = {} if device is None else {"device": device}
    return [
        baseline_models.GlobalEpistasisModel(seq_len, 100, alphabet, **dev),
        baseline_models.MLP(seq_len, 200, alphabet, **dev),
        baseline_models.CNN(seq_len, 32, 100, alphabet, **dev),
        baseline_models.TorchRidgeRegression(alphabet, alpha=0.0, name="linear_regression", **dev),
        baseline_models.TorchRandomForest(alphabet, **dev),
        baseline_models.TorchKNNRegressor(alphabet, **dev),
        baseline_models.TorchLasso(alphabet, **dev),
        baseline_models.TorchBayesianRidge(alphabet, **dev),
        baseline_models.TorchGaussianProcessRegressor(alphabet, **dev),
        baseline_models.TorchGradientBoosting(alphabet, **dev),
        baseline_models.TorchExtraTree(alphabet, **dev),
    ]


def sklearn_default_models(seq_len: int, alphabet: str, device=None) -> List[Model]:
    """The reference's byte-faithful member stack: three nets and 8 sklearn regressors."""
    import sklearn.ensemble
    import sklearn.gaussian_process
    import sklearn.linear_model
    import sklearn.neighbors
    import sklearn.tree

    dev = {} if device is None else {"device": device}
    return [
        baseline_models.GlobalEpistasisModel(seq_len, 100, alphabet, **dev),
        baseline_models.MLP(seq_len, 200, alphabet, **dev),
        baseline_models.CNN(seq_len, 32, 100, alphabet, **dev),
        baseline_models.LinearRegression(alphabet),
        baseline_models.RandomForest(alphabet),
        baseline_models.SklearnRegressor(
            sklearn.neighbors.KNeighborsRegressor(), alphabet, "nearest_neighbors"
        ),
        baseline_models.SklearnRegressor(sklearn.linear_model.Lasso(), alphabet, "lasso"),
        baseline_models.SklearnRegressor(
            sklearn.linear_model.BayesianRidge(), alphabet, "bayesian_ridge"
        ),
        baseline_models.SklearnRegressor(
            sklearn.gaussian_process.GaussianProcessRegressor(), alphabet,
            "gaussian_process",
        ),
        baseline_models.SklearnRegressor(
            sklearn.ensemble.GradientBoostingRegressor(), alphabet, "gradient_boosting"
        ),
        baseline_models.SklearnRegressor(sklearn.tree.ExtraTreeRegressor(), alphabet, "extra_trees"),
    ]


class DynaPPOEnsemble(Model):
    """Ensemble gated at predict time by holdout r^2 >= threshold."""

    def __init__(
        self,
        seq_len: int,
        alphabet: str,
        r_squared_threshold: float = 0.5,
        models: Optional[List[Model]] = None,
        seed: int = 0,
        tpu_native_members: bool = True,
        device=None,
    ):
        """Create the ensemble (the reference's 11 default members).

        The default members are the tensor counterparts of the JAX
        package's (`tpu_native_default_models`), on `device` (default
        "cuda"); `tpu_native_members=False` builds the reference's sklearn
        stack instead (`sklearn_default_models`, which needs sklearn).
        """
        super().__init__(name="DynaPPOEnsemble")

        if models is None:
            defaults = (
                tpu_native_default_models if tpu_native_members else sklearn_default_models
            )
            models = defaults(seq_len, alphabet, device)

        self.models = models
        self.r_squared_vals = np.ones(len(self.models))
        self.r_squared_threshold = r_squared_threshold
        self._rng = np.random.default_rng(seed)

    def train(self, sequences, labels):
        """Train members on 75%; record holdout r^2 per member."""
        if len(sequences) < 10:
            return

        sequences = np.asarray(sequences)
        labels = np.asarray(labels)
        perm = self._rng.permutation(len(sequences))
        n_test = max(1, int(round(len(sequences) * 0.25)))
        test_idx, train_idx = perm[:n_test], perm[n_test:]
        train_x, train_y = sequences[train_idx], labels[train_idx]
        test_x, test_y = sequences[test_idx], labels[test_idx]

        for model in self.models:
            model.train(train_x, train_y)

        self.r_squared_vals = []
        for model in self.models:
            y_preds = np.asarray(model.get_fitness(test_x))
            if (y_preds[0] == y_preds).all() or (test_y[0] == test_y).all():
                self.r_squared_vals.append(0)
            else:
                self.r_squared_vals.append(
                    float(_pearson_r2(y_preds[None, :], test_y)[0])
                )

    def _fitness_function(self, sequences):
        passing = [
            model
            for model, r2 in zip(self.models, self.r_squared_vals)
            if r2 >= self.r_squared_threshold
        ]
        if len(passing) == 0:
            return self.models[int(np.argmax(self.r_squared_vals))].get_fitness(
                sequences
            )
        return np.mean([m.get_fitness(sequences) for m in passing], axis=0)


class DynaPPO(Explorer):
    """Constructive DyNA-PPO: sequences built residue-by-residue."""

    def __init__(
        self,
        landscape: Landscape,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        alphabet: str,
        log_file: Optional[str] = None,
        model: Optional[Model] = None,
        num_experiment_rounds: int = 10,
        num_model_rounds: int = 1,
        env_batch_size: int = 4,
        seed: int = 0,
        agent_kwargs: Optional[dict] = None,
        device=None,
    ):
        """Create the constructive DyNA-PPO explorer.

        Args:
            num_experiment_rounds: Kept for reference API parity (encoded
                in the name).
            num_model_rounds: Model-based training phases per round.
            env_batch_size: Episodes run in parallel per collect step.
            agent_kwargs: Overrides for the PPOAgent (e.g. learning_rate,
                normalize_observations).
            device: Where the agent, the default ensemble and the density
                cache live (default "cuda"; pass "cpu" to run on the CPU).
        """
        name = f"DynaPPO_Agent_{num_experiment_rounds}_{num_model_rounds}"

        if model is None:
            model = DynaPPOEnsemble(
                len(starting_sequence), alphabet, seed=seed, device=device
            )
            model.train(
                s_utils.generate_random_sequences(
                    len(starting_sequence),
                    10,
                    alphabet,
                    rng=np.random.default_rng(seed),
                ),
                [0] * 10,
            )

        super().__init__(
            model,
            name,
            rounds,
            sequences_batch_size,
            model_queries_per_batch,
            starting_sequence,
            log_file,
        )

        self.alphabet = as_alphabet(alphabet)
        self.num_experiment_rounds = num_experiment_rounds
        self.num_model_rounds = num_model_rounds
        self.env_batch_size = env_batch_size

        self.env = DynaPPOEnv(
            self.alphabet, len(starting_sequence), model, landscape, env_batch_size,
            device=device,
        )
        self.agent = PPOAgent(
            obs_dim=self.env.obs_dim,
            num_actions=self.env.num_actions,
            fc_layers=(128,),
            train_epochs=10,
            seed=seed,
            device=device,
            **(agent_kwargs or {}),
        )

    def _collect_episode_batch(self, traj, sequences):
        """One batched constructive episode; records boundary sequences."""
        obs = self.env.reset()
        done = False
        while not done:
            actions, logprobs, values = self.agent.act(obs)
            next_obs, rewards, done = self.env.step(actions)
            traj["obs"].append(obs)
            traj["actions"].append(actions)
            traj["logprobs"].append(logprobs)
            traj["values"].append(values)
            traj["rewards"].append(
                rewards if np.ndim(rewards) else np.full(len(actions), rewards)
            )
            traj["dones"].append(np.full(len(actions), done))
            obs = next_obs
        # Boundary: record each episode's final sequence and fitness.
        tokens = np.argmax(self.env.states[:, :, :-1], axis=2).astype(np.int32)
        for seq in self.alphabet.decode(tokens):
            sequences[seq] = self.env.get_cached_fitness(seq)

    def _train_on(self, traj):
        if not traj["obs"]:
            return
        # [T, B, ...] -> flat [T*B, ...] (episodes are independent lanes).
        batch = {
            "obs": np.concatenate([o for o in np.stack(traj["obs"], 1)]),
            "actions": np.concatenate([a for a in np.stack(traj["actions"], 1)]),
            "logprobs": np.concatenate([p for p in np.stack(traj["logprobs"], 1)]),
            "rewards": np.concatenate([r for r in np.stack(traj["rewards"], 1)]),
            "dones": np.concatenate([d for d in np.stack(traj["dones"], 1)]),
            "values": np.concatenate([v for v in np.stack(traj["values"], 1)]),
        }
        self.agent.train(batch)

    def propose_sequences(
        self, measured_sequences_data: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top `sequences_batch_size` sequences for evaluation."""
        sequences = {}

        # Experiment-based phase: episodes scored on the true landscape.
        experiment_budget = self.sequences_batch_size
        self.env.set_fitness_model_to_gt(True)
        previous_landscape_cost = self.env.landscape.cost
        traj = {k: [] for k in ["obs", "actions", "logprobs", "rewards", "dones", "values"]}
        while self.env.landscape.cost - previous_landscape_cost < experiment_budget:
            self._collect_episode_batch(traj, sequences)
        self._train_on(traj)
        sequences.clear()

        # Model-based phases.
        self.env.set_fitness_model_to_gt(False)
        previous_model_cost = self.model.cost
        for _ in range(self.num_model_rounds):
            if self.model.cost - previous_model_cost >= self.model_queries_per_batch:
                break
            traj = {
                k: []
                for k in ["obs", "actions", "logprobs", "rewards", "dones", "values"]
            }
            phase_start = self.model.cost
            phase_budget = int(self.model_queries_per_batch / self.num_model_rounds)
            while self.model.cost - phase_start < phase_budget:
                self._collect_episode_batch(traj, sequences)
            self._train_on(traj)

        measured = set(measured_sequences_data["sequence"])
        sequences = {
            seq: fitness
            for seq, fitness in sequences.items()
            if seq not in measured
        }
        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        sorted_order = np.argsort(preds)[::-1][: self.sequences_batch_size]

        return new_seqs[sorted_order], preds[sorted_order]


class DynaPPOMutative(Explorer):
    """Mutative DyNA-PPO: full-sequence mutation walks."""

    def __init__(
        self,
        landscape: Landscape,
        rounds: int,
        sequences_batch_size: int,
        model_queries_per_batch: int,
        starting_sequence: str,
        alphabet: str,
        log_file: Optional[str] = None,
        model: Optional[Model] = None,
        num_experiment_rounds: int = 10,
        num_model_rounds: int = 1,
        seed: int = 0,
        agent_kwargs: Optional[dict] = None,
        device=None,
    ):
        """Create the mutative DyNA-PPO explorer (arguments as `DynaPPO`'s)."""
        name = f"DynaPPO_Agent_{num_experiment_rounds}_{num_model_rounds}"

        if model is None:
            model = DynaPPOEnsemble(
                len(starting_sequence), alphabet, seed=seed, device=device
            )
            model.train(
                s_utils.generate_random_sequences(
                    len(starting_sequence),
                    10,
                    alphabet,
                    rng=np.random.default_rng(seed),
                ),
                [0] * 10,
            )

        super().__init__(
            model,
            name,
            rounds,
            sequences_batch_size,
            model_queries_per_batch,
            starting_sequence,
            log_file,
        )

        self.alphabet = as_alphabet(alphabet)
        self.num_experiment_rounds = num_experiment_rounds
        self.num_model_rounds = num_model_rounds
        self._rng = np.random.default_rng(seed)

        self.env = DynaPPOEnvMut(
            alphabet=self.alphabet,
            starting_seq=starting_sequence,
            model=model,
            landscape=landscape,
            max_num_steps=model_queries_per_batch,
            device=device,
        )
        obs_dim = self.env.seq_len * len(self.alphabet)
        self.agent = PPOAgent(
            obs_dim=obs_dim,
            num_actions=self.env.num_actions,
            fc_layers=(128,),
            train_epochs=10,
            seed=seed,
            device=device,
            **(agent_kwargs or {}),
        )

    def _reseed_env(self, sequences):
        if not sequences:
            return
        top_fitness = max(sequences.values())
        top = [s for s, f in sequences.items() if f >= 0.9 * top_fitness]
        pool = top if top else list(sequences.keys())
        self.env.seq = str(self._rng.choice(pool))

    def _collect_episode(self, traj, sequences, stop_fn):
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
            if stop_fn():
                done = True
        seq = self.env.get_state_string()
        sequences[seq] = self.env.fitness
        self._reseed_env(sequences)

    def _train_on(self, traj):
        if traj["obs"]:
            self.agent.train({k: np.asarray(v) for k, v in traj.items()})

    def propose_sequences(
        self, measured_sequences_data: pd.DataFrame
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Propose top sequences (annealed experiment budget, ref :475-481)."""
        current_round = measured_sequences_data["round"].max()
        experiment_budget = int(
            (self.rounds - current_round + 1)
            / self.rounds
            * self.sequences_batch_size
            / 2
        )

        sequences = {}
        traj = {k: [] for k in ["obs", "actions", "logprobs", "rewards", "dones", "values"]}
        self.env.set_fitness_model_to_gt(True)
        prev_landscape = self.env.landscape.cost
        while self.env.landscape.cost - prev_landscape < experiment_budget:
            self._collect_episode(
                traj,
                sequences,
                lambda: self.env.landscape.cost - prev_landscape
                >= experiment_budget,
            )
        self._train_on(traj)
        sequences.clear()

        self.env.set_fitness_model_to_gt(False)
        previous_model_cost = self.model.cost
        for _ in range(self.num_model_rounds):
            if self.model.cost - previous_model_cost >= self.model_queries_per_batch:
                break
            traj = {
                k: []
                for k in ["obs", "actions", "logprobs", "rewards", "dones", "values"]
            }
            phase_start = self.model.cost
            phase_budget = int(self.model_queries_per_batch / self.num_model_rounds)
            while self.model.cost - phase_start < phase_budget:
                self._collect_episode(
                    traj,
                    sequences,
                    lambda: self.model.cost - phase_start >= phase_budget,
                )
            self._train_on(traj)

        measured = set(measured_sequences_data["sequence"])
        sequences = {
            seq: fitness
            for seq, fitness in sequences.items()
            if seq not in measured
        }
        new_seqs = np.array(list(sequences.keys()))
        preds = np.array(list(sequences.values()))
        # Documented deviation from the reference slice (dyna_ppo.py:
        # 520-522 upstream, argsort[:-(B - budget):-1]): that idiom yields
        # B - budget - 1 proposals (one fewer than the budget split
        # implies) and degenerates to nearly the WHOLE pool when
        # budget >= B (a[:-0:-1] == a[:0:-1]); here the count is exactly
        # B - budget, floored at 1.
        k = max(1, self.sequences_batch_size - experiment_budget)
        sorted_order = np.argsort(preds)[: -k - 1 : -1]

        return new_seqs[sorted_order], preds[sorted_order]

"""Seeded host runs of the port's explorers reproduce the JAX package's, row for row.

Random, the genetic algorithm, BO and GPR_BO draw only from numpy
Generators, seeded alike and drawn in the same order in both packages, and
the oracles and models below give equal values in both; so sequences,
rounds and costs must be identical and scores agree to 1e-6.  DQN starts
from the JAX package's initial Q network, carried across
(`convert.qnetwork_variables_from_flax`); its walk draws from numpy too.
"""
import numpy as np
import pytest
import torch

import flexs_tpu
import flexs_tpu_torch
from flexs_tpu_torch.baselines.models.convert import qnetwork_variables_from_flax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


RNA = flexs_tpu.landscapes.rna.registry()["L14_RNA1"]
TF = flexs_tpu.landscapes.tf_binding.registry()["SIX6_REF_R1"]


def _assert_same_run(run_t, run_j, rows=None):
    (df_t, meta_t, costs_t), (df_j, meta_j, costs_j) = run_t, run_j
    if rows is not None:
        assert len(df_t) == rows
    assert df_t["sequence"].tolist() == df_j["sequence"].tolist()
    for col in ("round", "model_cost", "measurement_cost"):
        np.testing.assert_array_equal(df_t[col].to_numpy(), df_j[col].to_numpy())
    for col in ("true_score", "model_score"):
        np.testing.assert_allclose(df_t[col].to_numpy(), df_j[col].to_numpy(), atol=1e-6)
    assert costs_t == costs_j
    meta_t.pop("run_id"), meta_j.pop("run_id")
    assert meta_t == meta_j


def _rna_run(pkg, make, **device):
    landscape = pkg.landscapes.RNABinding(**RNA["params"], **device)
    model = pkg.baselines.models.NoisyAbstractModel(landscape, 0.9, seed=0, **device)
    explorer = make(pkg.baselines.explorers, model)
    df, meta = explorer.run(landscape, verbose=False)
    return df, meta, (landscape.cost, model.cost)


COMMON = dict(rounds=2, sequences_batch_size=10, model_queries_per_batch=60,
              starting_sequence=RNA["starts"][1], alphabet=flexs_tpu.RNAA)

NUMPY_EXPLORERS = {
    "random": lambda ex, m: ex.Random(m, seed=0, **COMMON),
    "random_elitist": lambda ex, m: ex.Random(m, elitist=True, seed=0, **COMMON),
    "ga_top_proportion": lambda ex, m: ex.GeneticAlgorithm(
        m, population_size=20, parent_selection_strategy="top-proportion",
        children_proportion=0.5, parent_selection_proportion=0.5, seed=0, **COMMON),
    "ga_wright_fisher": lambda ex, m: ex.GeneticAlgorithm(
        m, population_size=20, parent_selection_strategy="wright-fisher",
        children_proportion=0.5, beta=0.1, seed=0, **COMMON),
    "bo_ei": lambda ex, m: ex.BO(m, method="EI", seed=0, **COMMON),
    "bo_ucb": lambda ex, m: ex.BO(m, method="UCB", recomb_rate=0.2, seed=0, **COMMON),
}


@pytest.mark.parametrize("name", sorted(NUMPY_EXPLORERS))
def test_numpy_explorer_reproduces_jax_row_for_row(name):
    make = NUMPY_EXPLORERS[name]
    run_t = _rna_run(flexs_tpu_torch, make, device="cpu")
    run_j = _rna_run(flexs_tpu, make)
    assert run_t[0]["round"].max() == 2
    _assert_same_run(run_t, run_j)


def _table_model(pkg, seed: int, token_path: bool):
    """A deterministic per-position score table over 8-mers, in both packages."""
    table = np.random.default_rng(seed).random((8, 4))
    alphabet = pkg.Alphabet(pkg.DNAA)

    def score(tokens):
        tokens = np.asarray(tokens)
        return table[np.arange(8), tokens].sum(axis=1)

    class TableModel(pkg.Model):
        def __init__(self):
            super().__init__(name=f"table{seed}")

        def train(self, *args):
            pass

        def _fitness_function(self, sequences):
            return score(alphabet.encode(list(sequences)))

    if token_path:
        TableModel.fitness_from_tokens = lambda self, tokens: score(tokens)
    return TableModel()


def _gpr_run(pkg, method, token_path, ensemble, **device):
    landscape = pkg.landscapes.TFBinding(**TF["params"], **device)
    if ensemble:
        model = pkg.Ensemble([_table_model(pkg, s, token_path) for s in range(3)],
                             combine_with=lambda x: x)
    else:
        model = _table_model(pkg, 0, token_path)
    explorer = pkg.baselines.explorers.GPR_BO(
        model, rounds=2, sequences_batch_size=10, model_queries_per_batch=100,
        starting_sequence=TF["starts"][0], alphabet=pkg.DNAA, seq_proposal_method=method,
        seed=0,
    )
    df, meta = explorer.run(landscape, verbose=False)
    return df, meta, (landscape.cost, model.cost, explorer.best_fitness)


@pytest.mark.parametrize("token_path", [True, False], ids=["tokens", "strings"])
@pytest.mark.parametrize("method", ["Thompson", "Greedy", "UCB"])
def test_gpr_bo_reproduces_jax_row_for_row(method, token_path):
    run_t = _gpr_run(flexs_tpu_torch, method, token_path, ensemble=True, device="cpu")
    run_j = _gpr_run(flexs_tpu, method, token_path, ensemble=True)
    assert run_t[2][1] == 2 * 4**8  # the whole space scored every round
    _assert_same_run(run_t, run_j, rows=1 + 2 * 10)


def test_gpr_bo_without_ensemble_has_zero_sigma():
    """A bare model: sigma stays 0 and Thompson ranks by the mean, as in the JAX package."""
    run_t = _gpr_run(flexs_tpu_torch, "Thompson", True, ensemble=False, device="cpu")
    run_j = _gpr_run(flexs_tpu, "Thompson", True, ensemble=False)
    greedy = _gpr_run(flexs_tpu_torch, "Greedy", True, ensemble=False, device="cpu")
    _assert_same_run(run_t, run_j)
    assert run_t[0]["sequence"].tolist() == greedy[0]["sequence"].tolist()


def test_gpr_bo_guards_the_space_size():
    model = _table_model(flexs_tpu_torch, 0, True)
    with pytest.raises(ValueError, match="too large"):
        flexs_tpu_torch.baselines.explorers.GPR_BO(
            model, rounds=1, sequences_batch_size=10, model_queries_per_batch=100,
            starting_sequence=RNA["starts"][1], alphabet=flexs_tpu.RNAA)


def _dqn(explorers, model, **device):
    return explorers.DQN(model, seed=0, **COMMON, **device)


def test_dqn_from_carried_init_reproduces_jax_row_for_row():
    # The JAX explorer's initial Q network, as its first round builds it.
    probe = _dqn(flexs_tpu.baselines.explorers, None)
    probe.initialize_data_structures()
    carried = qnetwork_variables_from_flax(probe._params)

    landscape_t = flexs_tpu_torch.landscapes.RNABinding(**RNA["params"], device="cpu")
    model_t = flexs_tpu_torch.baselines.models.NoisyAbstractModel(
        landscape_t, 0.9, seed=0, device="cpu")
    explorer_t = _dqn(flexs_tpu_torch.baselines.explorers, model_t, device="cpu")
    explorer_t.initialize_data_structures()
    explorer_t.q_network.load_state_dict(carried)
    df_t, meta_t = explorer_t.run(landscape_t, verbose=False)

    run_j = _rna_run(flexs_tpu, _dqn)
    assert df_t["round"].max() == 2
    _assert_same_run((df_t, meta_t, (landscape_t.cost, model_t.cost)), run_j)

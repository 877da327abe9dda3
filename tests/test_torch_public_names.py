"""Every name a ported subpackage of the JAX package exports exists in the port.

Each JAX `__init__.py` is read with `ast` (no JAX import), and each name it
binds at top level must exist in the port's counterpart, unless the port
names it differently (`RENAMED`) or has not ported it yet (`NOT_PORTED`,
with its ROADMAP.md item number).
"""
import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBPACKAGES = (
    "", "ops", "landscapes", "baselines.models", "baselines.explorers", "runtime",
    "parallel", "utils",
)

# The port's name for a JAX name.
RENAMED = {
    ("baselines.models", "FlaxModel"): "TorchModel",
    **{("baselines.models", f"Jax{n}"): f"Torch{n}" for n in (
        "RidgeRegression", "Lasso", "BayesianRidge", "GaussianProcessRegressor",
        "KNNRegressor", "RandomForest", "GradientBoosting", "ExtraTree",
    )},
}

# Names not ported yet -> ROADMAP.md item.
NOT_PORTED = {
    ("", "rl"): 14,
    **{("baselines.explorers", n): 14 for n in (
        "BO", "GPR_BO", "environments", "VAE", "CbAS", "CMAES", "DQN", "DynaPPO",
        "DynaPPOEnsemble", "DynaPPOMutative", "GeneticAlgorithm", "PPO", "Random",
    )},
    **{("runtime", n): 16 for n in (
        "DeviceBONAM", "run_bo_nam", "DeviceCbASNAM", "VAEConfig", "run_cbas_nam",
        "DeviceCMAESNAM", "run_cmaes_nam", "DeviceDQNNAM", "run_dqn_nam",
        "DeviceDynaPPONAM", "run_dyna_ppo_nam", "DeviceDynaPPOMutativeNAM",
        "run_dyna_ppo_mutative_nam", "DeviceGPRBONAM", "run_gpr_bo_nam",
        "DeviceGeneticAlgorithmNAM", "run_ga_nam", "DevicePPONAM", "run_ppo_nam",
        "DeviceRandomNAM", "run_random_nam",
    )},
    ("utils", "checkpointing"): 17,
    ("utils", "profiling"): 17,
    ("utils", "replay_buffers"): 14,
    ("utils", "vae"): 14,
    ("utils", "VAE_utils"): 14,
}


def _exported(sub: str):
    """Names bound at the top level of `flexs_tpu/<sub>/__init__.py`."""
    path = os.path.join(ROOT, "flexs_tpu", *filter(None, sub.split(".")), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def _port(sub: str):
    return importlib.import_module(".".join(filter(None, ("flexs_tpu_torch", sub))))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "flexs_tpu")
def test_every_exported_name_is_ported_or_listed(sub):
    port = _port(sub)
    missing = [
        name for name in _exported(sub)
        if (sub, name) not in NOT_PORTED
        and not hasattr(port, RENAMED.get((sub, name), name))
    ]
    assert not missing, f"flexs_tpu_torch.{sub} lacks {missing}"


def test_not_ported_table_is_current():
    """A listed name that the port now has must leave the table; so must a stale one."""
    stale = [(sub, n) for sub, n in NOT_PORTED if hasattr(_port(sub), n)]
    assert not stale, f"ported, still listed as not ported: {stale}"
    unknown = [(sub, n) for sub, n in list(NOT_PORTED) + list(RENAMED) if n not in _exported(sub)]
    assert not unknown, f"listed but not exported by the JAX package: {unknown}"
    for (sub, name), new in RENAMED.items():
        assert hasattr(_port(sub), new) and not hasattr(_port(sub), name), (sub, name, new)


def test_repaired_names():
    from flexs_tpu_torch import landscapes, ops
    from flexs_tpu_torch.baselines import models
    from flexs_tpu_torch.ops import hamming

    assert ops.edit_distance_matrix is hamming.edit_distance_matrix
    assert ops.hamming_distance_matrix is hamming.hamming_distance_matrix
    assert models.KerasModel is models.TorchModel
    assert landscapes.bert_gfp.BertGFPBrightness is landscapes.BertGFPBrightness
    assert landscapes.rna.RNAFolding is landscapes.RNAFolding


def test_item_13_names_are_ported():
    from flexs_tpu_torch.baselines import models

    assert not [key for key, item in NOT_PORTED.items() if item == 13]
    for name in ("AdaptiveEnsemble", "r2_weights", "LinearRegression", "LogisticRegression",
                 "RandomForest", "SklearnClassifier", "SklearnModel", "SklearnRegressor"):
        assert hasattr(models, name), name
    assert issubclass(models.LogisticRegression, models.SklearnRegressor)  # the reference's quirk

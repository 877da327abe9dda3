"""Every name a ported subpackage of the JAX package exports exists in the port.

Each JAX `__init__.py` is read with `ast` (no JAX import), and each name it
binds at top level must exist in the port's counterpart, unless the port
names it differently (`RENAMED`) or has not ported it yet (`NOT_PORTED`,
with its ROADMAP.md item number).  The functions that take JAX's
arguments positionally (the sweeps, `multihost`, `ops.cmaes`, the fused
`run_*_nam`, and the infrastructure modules) keep JAX's positional
parameters, in JAX's order, before any parameter of the port's own.
"""
import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBPACKAGES = (
    "", "ops", "landscapes", "baselines.models", "baselines.explorers",
    "baselines.explorers.environments", "runtime", "parallel", "rl", "utils",
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
NOT_PORTED = {}

# JAX's parameter name -> the port's.
RENAMED_PARAMS = {"key": "generator", "keys": "generators"}


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


def test_item_14_names_are_ported():
    from flexs_tpu_torch import rl, utils
    from flexs_tpu_torch.baselines import explorers

    assert not [key for key, item in NOT_PORTED.items() if item == 14]
    for name in _exported("baselines.explorers"):
        assert hasattr(explorers, name), name
    assert utils.VAE_utils is utils.vae and explorers.VAE is utils.vae.VAE
    assert explorers.environments.PPOEnvironment is not None
    assert rl.PPOAgent is rl.ppo.PPOAgent
    assert utils.replay_buffers.PrioritizedReplayBuffer is not None


def test_item_16_runner_names_are_ported():
    """Every fused runner of the JAX package (and VAEConfig) is ported, the RL four too."""
    from flexs_tpu_torch import runtime

    for name in ("DeviceRandomNAM", "run_random_nam", "DeviceGeneticAlgorithmNAM", "run_ga_nam",
                 "DeviceCMAESNAM", "run_cmaes_nam", "DeviceBONAM", "run_bo_nam",
                 "DeviceGPRBONAM", "run_gpr_bo_nam", "DeviceCbASNAM", "run_cbas_nam",
                 "VAEConfig", "DeviceDQNNAM", "run_dqn_nam", "DeviceDynaPPONAM",
                 "run_dyna_ppo_nam", "DeviceDynaPPOMutativeNAM", "run_dyna_ppo_mutative_nam",
                 "DevicePPONAM", "run_ppo_nam"):
        assert hasattr(runtime, name), name
    assert not [key for key, item in NOT_PORTED.items() if item == 16]
    assert not [n for n in _exported("runtime") if ("runtime", n) in NOT_PORTED]


def test_item_17_modules_are_ported():
    """The last five JAX modules have counterparts, with every public top-level name."""
    from flexs_tpu_torch import utils

    assert not NOT_PORTED
    assert utils.checkpointing.save_state and utils.profiling.trace
    for module in ("parallel/multihost.py", "utils/checkpointing.py", "utils/profiling.py",
                   "cli.py", "native.py"):
        names = [n for n in _top_level_functions(module) if not n.startswith("_")]
        port = importlib.import_module("flexs_tpu_torch." + module[:-3].replace("/", "."))
        assert names and not [n for n in names if not hasattr(port, n)], (module, names)


def _script_tree(script: str):
    path = os.path.join(ROOT, "scripts", script)
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _script_constant(script: str, name: str):
    """The literal bound to `name` at the top level of scripts/<script>."""
    for node in _script_tree(script).body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == [name]:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_item_18_paper_table_and_northstar_names():
    """REFERENCE, make's leading parameters and FAMILIES are the scripts'."""
    from flexs_tpu_torch import bench_northstar, run_paper_table

    assert run_paper_table.REFERENCE == _script_constant("run_paper_table.py", "REFERENCE")
    assert bench_northstar.FAMILIES == _script_constant("bench_northstar.py", "FAMILIES")
    make = next(n for n in ast.walk(_script_tree("run_paper_table.py"))
                if isinstance(n, ast.FunctionDef) and n.name == "make")
    want = [a.arg for a in make.args.args]
    got = _top_level_functions("run_paper_table.py", root="flexs_tpu_torch")["make"]
    assert got[:len(want)] == want == ["name", "model", "landscape", "start"], got


def _dict_keys(script: str, name: str) -> list:
    """The keys of the dict literal bound to `name` at the top level of scripts/<script>."""
    for node in _script_tree(script).body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == [name]:
            return [ast.literal_eval(k) for k in node.value.keys]
    raise KeyError(name)


def test_item_18_scaling_and_profiler_names():
    """STEPS and PROFILES are the scripts'; each script's functions have a counterpart."""
    from flexs_tpu_torch import profile_compile, profile_surrogate_sweep

    assert list(profile_surrogate_sweep.STEPS) == _dict_keys("profile_surrogate_sweep.py", "STEPS")
    assert list(profile_compile.PROFILES) == _dict_keys("profile_compile.py", "PROFILES")
    counterparts = {
        "bench_scaling.py": {"cpu_mesh_checks": "cpu_mesh_checks",
                             "tpu_grid_scaling": "grid_scaling", "main": "main"},
        "profile_fused_run.py": {"bench": "bench", "main": "main"},
        "profile_surrogate_sweep.py": {"_landscape": "_landscape", "_median3": "_median3",
                                       "_single": "_single", "_sweep": "_sweep",
                                       **{f"h{i}": f"h{i}" for i in range(8)}},
        "profile_compile.py": {"_paper_args": "_paper_args",
                               **{f"profile_{n}": f"profile_{n}"
                                  for n in _dict_keys("profile_compile.py", "PROFILES")}},
    }
    for script, names in counterparts.items():
        want = {n.name for n in _script_tree(script).body if isinstance(n, ast.FunctionDef)}
        assert want - {"_measure"} == set(names), (script, want)
        got = _top_level_functions(script, root="flexs_tpu_torch")
        assert set(names.values()) <= set(got), (script, sorted(got))


def _top_level_functions(module: str, root: str = "flexs_tpu") -> dict:
    """{name: positional parameter names} of the top-level functions of `<root>/<module>`."""
    path = os.path.join(ROOT, root, *module.split("/"))
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    return {
        node.name: [a.arg for a in node.args.posonlyargs + node.args.args]
        for node in tree.body if isinstance(node, ast.FunctionDef)
    }


def _positional_cases():
    """(JAX module, function) pairs whose positional parameters the port must keep."""
    cases = [("parallel/sweep.py", n) for n in _exported("parallel")]
    cases += [("parallel/multihost.py", n) for n in _top_level_functions("parallel/multihost.py")]
    cases += [("ops/cmaes.py", n) for n in _top_level_functions("ops/cmaes.py")
              if not n.startswith("_")]
    for name in sorted(os.listdir(os.path.join(ROOT, "flexs_tpu", "runtime"))):
        if name.endswith("_runner.py"):
            module = f"runtime/{name}"
            cases += [(module, n) for n in _top_level_functions(module)
                      if n.startswith("run_") and n.endswith("_nam")]
    for module in ("utils/checkpointing.py", "utils/profiling.py", "cli.py", "native.py"):
        cases += [(module, n) for n in _top_level_functions(module) if not n.startswith("_")]
    return cases


@pytest.mark.parametrize("module,name", _positional_cases(), ids=lambda x: x)
def test_positional_parameters_follow_jax(module, name):
    """JAX's positional parameters are the port's first ones, in order (the key is the generator)."""
    want = [RENAMED_PARAMS.get(p, p) for p in _top_level_functions(module)[name]]
    got = _top_level_functions(module, "flexs_tpu_torch").get(name)
    assert got is not None, f"flexs_tpu_torch/{module} has no {name}"
    assert got[:len(want)] == want, f"{module}:{name}: JAX {want}, port {got}"


def test_positional_cases_cover_the_faults():
    cases = _positional_cases()
    for case in (("parallel/sweep.py", "sweep_adalead_nam"), ("ops/cmaes.py", "tell"),
                 ("parallel/multihost.py", "gather_to_host"), ("cli.py", "main")):
        assert case in cases, case
    runners = {n for m, n in cases if m.startswith("runtime/")}
    assert {f"run_{a}_nam" for a in ("adalead", "random", "ga", "cmaes", "bo", "gpr_bo",
                                     "cbas", "dqn", "ppo", "dyna_ppo",
                                     "dyna_ppo_mutative")} == runners
    sweep_params = _top_level_functions("parallel/sweep.py", "flexs_tpu_torch")
    assert sweep_params["sweep_adalead_nam"][6] == "mesh"


def test_cmaes_tell_takes_jax_popsize():
    import numpy as np
    import torch

    from flexs_tpu_torch.ops import cmaes

    state = cmaes.init(np.zeros(4, np.float32), 0.5, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    sols = cmaes.ask(state, gen, 6)
    fits = sols.square().sum(dim=1)
    for a, b in zip(cmaes.tell(state, sols, fits, 6), cmaes.tell(state, sols, fits)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    with pytest.raises(ValueError, match="popsize 5"):
        cmaes.tell(state, sols, fits, 5)


def test_fused_runner_takes_positional_hyperparameters():
    """A JAX-style positional call of `run_ga_nam` equals the keyword call."""
    import torch

    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.runtime import AdaleadConfig, run_ga_nam

    land = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    start = torch.as_tensor(flexs.Alphabet(flexs.DNAA).encode_one(tf_binding.STARTS[0]))
    cfg = AdaleadConfig(rounds=1, sequences_batch_size=4, model_queries_per_batch=16,
                        alphabet_size=4)
    results = []
    for positional in (True, False):
        gen = torch.Generator()
        gen.manual_seed(1)
        hyper = (8, "wright-fisher", 0.5, 0.3, 0.05)
        if positional:
            results.append(run_ga_nam(*land.device_fitness(), start, cfg, 0.9, gen, *hyper))
        else:
            names = ("population_size", "parent_selection_strategy", "children_proportion",
                     "parent_selection_proportion", "beta")
            results.append(run_ga_nam(*land.device_fitness(), start, cfg, 0.9, gen,
                                      **dict(zip(names, hyper))))
    for a, b in zip(*results):
        assert torch.equal(a, b)

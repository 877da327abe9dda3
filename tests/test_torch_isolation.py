"""The PyTorch port imports neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "flexs_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "flexs_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_are_found():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("flexs_tpu_torch", "ops", "cuda_duplex.py") in names
    for module in ("runtime/surrogate.py", "landscapes/rosetta.py",
                   "landscapes/additive_aav_packaging.py", "ops/pdb.py",
                   "baselines/models/torch_model.py", "baselines/models/cnn.py",
                   "baselines/models/mlp.py", "baselines/models/global_epistasis_model.py",
                   "baselines/models/convert.py", "ops/rna_fold.py", "landscapes/bert_gfp.py",
                   "profile_fold.py", "baselines/models/torch_linear.py",
                   "baselines/models/torch_gp.py", "baselines/models/torch_trees.py",
                   "baselines/models/sklearn_models.py",
                   "baselines/models/adaptive_ensemble.py", "utils/replay_buffers.py",
                   "utils/vae.py", "ops/cmaes.py", "rl/__init__.py", "rl/ppo.py",
                   "baselines/explorers/random.py", "baselines/explorers/genetic_algorithm.py",
                   "baselines/explorers/cmaes.py", "baselines/explorers/bo.py",
                   "baselines/explorers/cbas_dbas.py", "baselines/explorers/dqn.py",
                   "baselines/explorers/ppo.py", "baselines/explorers/dyna_ppo.py",
                   "baselines/explorers/environments/__init__.py",
                   "baselines/explorers/environments/ppo.py",
                   "baselines/explorers/environments/dyna_ppo.py",
                   "runtime/random_runner.py", "runtime/ga_runner.py", "runtime/cmaes_runner.py",
                   "runtime/bo_runner.py", "runtime/gpr_bo_runner.py", "runtime/cbas_runner.py",
                   "runtime/dqn_runner.py", "runtime/ppo_runner.py",
                   "runtime/dyna_ppo_runner.py", "runtime/dyna_ppo_mutative_runner.py",
                   "parallel/multihost.py", "utils/checkpointing.py", "utils/profiling.py",
                   "cli.py", "native.py", "bench.py", "bench_sweep.py", "bench_fold.py",
                   "bench_surrogate.py", "run_paper_table.py", "bench_northstar.py",
                   "aggregate_northstar.py", "tutorial.py"):
        assert os.path.join("flexs_tpu_torch", *module.split("/")) in names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_match_is_exact():
    assert "flexs_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "flexs_tpu.ops".split(".")[0] in FORBIDDEN


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, flexs_tpu_torch, flexs_tpu_torch.runtime, flexs_tpu_torch.parallel, "
        "flexs_tpu_torch.evaluate, flexs_tpu_torch.landscapes.tf_binding, "
        "flexs_tpu_torch.landscapes.rosetta, flexs_tpu_torch.landscapes.additive_aav_packaging, "
        "flexs_tpu_torch.ops.pdb, flexs_tpu_torch.runtime.surrogate, "
        "flexs_tpu_torch.baselines.models.torch_model, flexs_tpu_torch.baselines.models.convert, "
        "flexs_tpu_torch.ops.rna_fold, flexs_tpu_torch.landscapes.bert_gfp, "
        "flexs_tpu_torch.profile_fold, flexs_tpu_torch.rl, flexs_tpu_torch.baselines.explorers, "
        "flexs_tpu_torch.baselines.explorers.environments, flexs_tpu_torch.utils.vae, "
        "flexs_tpu_torch.ops.cmaes, flexs_tpu_torch.runtime.random_runner, "
        "flexs_tpu_torch.runtime.ga_runner, flexs_tpu_torch.runtime.cmaes_runner, "
        "flexs_tpu_torch.runtime.bo_runner, flexs_tpu_torch.runtime.gpr_bo_runner, "
        "flexs_tpu_torch.runtime.cbas_runner, flexs_tpu_torch.runtime.dqn_runner, "
        "flexs_tpu_torch.runtime.ppo_runner, flexs_tpu_torch.runtime.dyna_ppo_runner, "
        "flexs_tpu_torch.runtime.dyna_ppo_mutative_runner, flexs_tpu_torch.parallel.multihost, "
        "flexs_tpu_torch.utils.checkpointing, flexs_tpu_torch.utils.profiling, "
        "flexs_tpu_torch.cli, flexs_tpu_torch.native, flexs_tpu_torch.bench, "
        "flexs_tpu_torch.bench_sweep, flexs_tpu_torch.bench_fold, "
        "flexs_tpu_torch.bench_surrogate, flexs_tpu_torch.run_paper_table, "
        "flexs_tpu_torch.bench_northstar, flexs_tpu_torch.aggregate_northstar, "
        "flexs_tpu_torch.tutorial; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_imports_without_sklearn():
    """The machine with the card has no sklearn: only the sklearn wrappers' constructors need it."""
    code = (
        "import sys; sys.modules['sklearn'] = None; "
        "import flexs_tpu_torch, flexs_tpu_torch.baselines.models as m; "
        "m.AdaptiveEnsemble([m.TorchKNNRegressor('ACGU', device='cpu')]); "
        "import flexs_tpu_torch.baselines.explorers.dyna_ppo as d; "
        "d.DynaPPOEnsemble(8, 'ACGU', device='cpu'); "
        "m.SklearnModel; "
        "assert 'sklearn.linear_model' not in sys.modules\n"
        "try:\n    m.LinearRegression('ACGU')\nexcept ImportError:\n    sys.exit(0)\n"
        "sys.exit(1)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""`flexs_tpu_torch.run_paper_table` on the CPU, against scripts/run_paper_table.py.

The script is loaded from its path, as tests/test_northstar.py loads its
script, never imported as a package.  Held: the `REFERENCE` table and the
flags; for each of the 21 names, the constructor call the script makes
(caught before the JAX object is built) against the one the port's `make`
makes, and the port's object built by it; the row function's lines; the
host Random, Adalead and GA rows against JAX's explorers at the same
sizes (their seeded numpy draws reproduce JAX's runs); the fused GA and
CMA-ES rows inside the range of JAX's fused runner over eight seeds.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import flexs_tpu
import flexs_tpu.runtime as jax_runtime
import flexs_tpu.utils.vae as jax_vae
import flexs_tpu_torch
import flexs_tpu_torch.runtime as port_runtime
import flexs_tpu_torch.utils.vae as port_vae
from flexs_tpu_torch import run_paper_table
from flexs_tpu_torch.landscapes import rosetta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CLASSES = ("Random", "Adalead", "GeneticAlgorithm", "BO", "CMAES", "CbAS", "DynaPPO", "DQN",
                "PPO", "DynaPPOMutative")
FUSED_CLASSES = ("DeviceRandomNAM", "DeviceAdaleadNAM", "DeviceGeneticAlgorithmNAM",
                 "DeviceCMAESNAM", "DeviceDQNNAM", "DeviceBONAM", "DeviceCbASNAM",
                 "DevicePPONAM", "DeviceDynaPPONAM")
# The row test's size: 1 start, 1 round, 100 proposals of a 200-query budget.
# Adalead's takes 400: at 200 both packages' Adalead raise "No sequences
# generated" (its rollouts need more queries than one batch of proposals).
ROW = dict(rounds=1, model_queries_per_batch=200)
ROW_BUDGET = {"adalead": 400}
BAND_SEEDS = range(8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "run_paper_table_script", os.path.join(ROOT, "scripts", "run_paper_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _usage(main, monkeypatch):
    """argparse's usage text of `main()` under --help, whitespace normalized."""
    monkeypatch.setattr(sys, "argv", ["prog", "--help"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main()
    return " ".join(out.getvalue().split("\n\n")[0].split())


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_reference_and_flags_equal_the_script(monkeypatch):
    script = _load_script()
    assert run_paper_table.REFERENCE == script.REFERENCE
    assert len(run_paper_table.REFERENCE) == 21
    usage = _usage(lambda: run_paper_table.main(["--help"]), monkeypatch)
    assert usage == _usage(script.main, monkeypatch)
    for flag in ("--explorers", "--starts", "--start-offset", "--rounds", "--cpu",
                 "--env-batch", "--density-metric"):
        assert flag in usage


class _Built(Exception):
    """Raised by a JAX constructor in place of building the explorer."""


def _calls(module, names, record, build: bool, monkeypatch):
    """Record each constructor call of `module.<name>` as (class, args, kwargs)."""
    for name in names:
        cls = getattr(module, name)
        original = cls.__init__

        def init(self, *args, _cls=cls, _original=original, **kwargs):
            if type(self) is _cls:  # not a subclass's super().__init__
                record.append((_cls.__name__, args, kwargs))
            if not build:
                raise _Built()
            _original(self, *args, **kwargs)
        monkeypatch.setattr(cls, "__init__", init)


def _plain(values):
    """Scalars as they are, any other value as its class's name."""
    if isinstance(values, dict):
        return {k: _plain(v) for k, v in values.items()}
    if isinstance(values, (list, tuple)):
        return [_plain(v) for v in values]
    return values if isinstance(values, (int, float, str, bool, type(None))) else \
        type(values).__name__


@pytest.mark.parametrize("name", sorted(run_paper_table.REFERENCE))
def test_make_builds_the_scripts_explorer(name, monkeypatch):
    """The port's `make` calls the counterpart class with every argument the script passes."""
    script, jax_calls, port_calls = _load_script(), [], []
    _calls(flexs_tpu.baselines.explorers, HOST_CLASSES, jax_calls, False, monkeypatch)
    _calls(jax_runtime, FUSED_CLASSES, jax_calls, False, monkeypatch)
    # The VAE is built before CbAS: its arguments are recorded, nothing is built.
    monkeypatch.setattr(jax_vae.VAE, "__init__",
                        lambda self, *a, **kw: jax_calls.append(("VAE", a, kw)))
    monkeypatch.setattr(sys, "argv", ["prog", "--explorers", name, "--starts", "1"])
    with pytest.raises(_Built), contextlib.redirect_stdout(io.StringIO()):
        script.main()

    _calls(flexs_tpu_torch.baselines.explorers, HOST_CLASSES, port_calls, True, monkeypatch)
    _calls(port_runtime, FUSED_CLASSES, port_calls, True, monkeypatch)
    _calls(port_vae, ("VAE",), port_calls, True, monkeypatch)
    land = rosetta.RosettaFolding(**rosetta.registry()["3msi"]["params"], device="cpu")
    start = run_paper_table.paper_starts(1)[0]
    obj = run_paper_table.make(name, flexs_tpu_torch.LandscapeAsModel(land), land, start,
                               device="cpu")

    for call in port_calls:
        call[2].pop("device", None)
    assert [c[0] for c in port_calls] == [c[0] for c in jax_calls] == \
        [c[0] for c in jax_calls if c[0] == "VAE"] + [type(obj).__name__]
    for (_, jax_args, jax_kw), (_, args, kw) in zip(jax_calls, port_calls):
        assert _plain(args) == _plain(jax_args)
        assert _plain(kw) == _plain(jax_kw)
    # And on the object: every scalar the script sets that the object keeps.
    kept = {**vars(obj), **getattr(obj, "run_kwargs", {})}
    for key, value in jax_calls[-1][2].items():
        if key in kept and isinstance(value, (int, float, str, bool)):
            assert kept[key] == value, key
    if name.startswith("device-"):
        assert obj.cfg.perfect_model and obj.cfg.rounds == 10
        assert obj.cfg.model_queries_per_batch == 2000 and obj.seed == 0


def _size(name: str) -> dict:
    return {**ROW, "model_queries_per_batch": ROW_BUDGET.get(name, 200)}


def _jax_host_max(name: str) -> float:
    """The max of JAX's explorer `name` at the script's settings and ROW's sizes."""
    from flexs_tpu.landscapes import rosetta as jax_rosetta

    problem = jax_rosetta.registry()["3msi"]
    land = jax_rosetta.RosettaFolding(**problem["params"])
    model = flexs_tpu.LandscapeAsModel(land)
    ex = flexs_tpu.baselines.explorers
    common = dict(sequences_batch_size=100, alphabet=flexs_tpu.AAS, **_size(name),
                  starting_sequence=list(problem["starts"].values())[0], seed=0)
    explorer = {
        "random": lambda: ex.Random(model, **common),
        "adalead": lambda: ex.Adalead(model, **common),
        "genetic": lambda: ex.GeneticAlgorithm(
            model, population_size=100, parent_selection_strategy="wright-fisher",
            children_proportion=0.2, beta=0.05, **common),
    }[name]()
    return float(explorer.run(land, verbose=False)[0]["true_score"].max())


def _row(name: str, capsys) -> dict:
    line = run_paper_table.run_row(name, run_paper_table.paper_starts(1), device="cpu",
                                   **_size(name))
    text = capsys.readouterr().out
    assert _json_lines(text) == [line]
    assert list(line) == ["explorer", "starts", "start_offset", "rounds", "maxes", "mean",
                          "best", "reference", "wall_s", "card"]
    assert line["explorer"] == name and line["starts"] == 1 and line["rounds"] == 1
    assert line["card"] == "cpu" and line["reference"] == list(run_paper_table.REFERENCE[name])
    assert line["mean"] == line["best"] == line["maxes"][0]
    assert f"  {name} start 1/1: max {line['maxes'][0]:.3f}" in text
    return line


@pytest.mark.parametrize("name", ["random", "adalead", "genetic"])
def test_host_row_equals_jax(name, capsys):
    line = _row(name, capsys)
    assert abs(line["maxes"][0] - _jax_host_max(name)) <= 1e-6, line


@pytest.mark.parametrize("name", ["device-ga", "device-cmaes"])
def test_fused_row_in_the_band_of_jax(name, capsys):
    """The row's max lies in the range of JAX's fused runner over eight seeds, same sizes."""
    from flexs_tpu.landscapes import rosetta as jax_rosetta

    line = _row(name, capsys)
    problem = jax_rosetta.registry()["3msi"]
    land = jax_rosetta.RosettaFolding(**problem["params"])
    cls, kw = {"device-ga": (jax_runtime.DeviceGeneticAlgorithmNAM, {}),
               "device-cmaes": (jax_runtime.DeviceCMAESNAM, dict(maximize=True))}[name]
    tops = [float(cls(land, flexs_tpu.AAS, sequences_batch_size=100,
                      starting_sequence=list(problem["starts"].values())[0], model="perfect",
                      seed=s, **ROW, **kw).run(verbose=False)[0]["true_score"].max())
            for s in BAND_SEEDS]
    assert min(tops) <= line["maxes"][0] <= max(tops), (line["maxes"], tops)


def test_main_prints_the_header_and_each_row(capsys):
    assert run_paper_table.main(["--explorers", "random", "device-random", "--starts", "2",
                                 "--start-offset", "1", "--rounds", "1", "--cpu"],
                                model_queries_per_batch=200) == 0
    text = capsys.readouterr().out
    assert text.splitlines()[0].split() == ["explorer", "ours", "mean/best", "reference", "time"]
    lines = _json_lines(text)
    assert [line["explorer"] for line in lines] == ["random", "device-random"]
    for line in lines:
        assert line["starts"] == len(line["maxes"]) == 2 and line["start_offset"] == 1
    assert run_paper_table.paper_starts(2, 1) == run_paper_table.paper_starts(3)[1:]


def test_without_a_card_exits_nonzero():
    """No card and no --cpu: it raises before printing any line."""
    proc = subprocess.run([sys.executable, "-m", "flexs_tpu_torch.run_paper_table"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr

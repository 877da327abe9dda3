"""`bench_scaling`, `profile_fused_run`, `profile_surrogate_sweep` and `profile_compile` on the CPU.

Each module is the counterpart of a script of the same name under
scripts/.  The scripts are read with `ast` and never imported: their
flags, hypothesis and program names, loops and configurations must be the
modules'.  The scaling grid's cells and start fitness are held to the JAX
package's sweep, `--cpu-mesh` runs at 1 and 2 gloo ranks, each module's
JSON lines are checked at tiny sizes with `--cpu`, and without a card and
without `--cpu` each module must exit 1 and print nothing.
"""
import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flexs_tpu_torch import (
    bench_scaling,
    profile_compile,
    profile_fused_run,
    profile_surrogate_sweep,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("bench_scaling", "profile_fused_run", "profile_surrogate_sweep", "profile_compile")
# The one argument each module runs with in the no-card check: its default mode.
NO_CARD_ARGS = {"bench_scaling": [], "profile_fused_run": [], "profile_surrogate_sweep": ["h0"],
                "profile_compile": ["adalead_surrogate"]}
TINY_RUN = dict(rounds=1, sequences_batch_size=5, model_queries_per_batch=20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _tree(path):
    with open(os.path.join(ROOT, path)) as f:
        return ast.parse(f.read(), filename=path)


def _script(name):
    return _tree(os.path.join("scripts", name + ".py"))


def _flags(tree):
    """The option strings of every `add_argument` call in a module."""
    return {
        node.args[0].value for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
        and node.args and isinstance(node.args[0], ast.Constant)
    }


def _dict_keys(tree, name):
    """The keys of the dict literal bound to `name` at the top level."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == [name]:
            return [ast.literal_eval(k) for k in node.value.keys]
    raise KeyError(name)


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _calls(node, name):
    """Calls of `name` (a bare name or an attribute) inside `node`, in source order."""
    found = [n for n in ast.walk(node) if isinstance(n, ast.Call)
             and getattr(n.func, "id", getattr(n.func, "attr", None)) == name]
    return sorted(found, key=lambda n: (n.lineno, n.col_offset))


def _literal_kwargs(call):
    """The keyword arguments of a call whose values are literals."""
    out = {}
    for kw in call.keywords:
        try:
            out[kw.arg] = ast.literal_eval(kw.value)
        except ValueError:
            pass
    return out


def _loop_tuples(node):
    """{loop variable: the literal tuple it runs over} of the `for` loops inside `node`."""
    return {n.target.id: ast.literal_eval(n.iter) for n in ast.walk(node)
            if isinstance(n, ast.For) and isinstance(n.target, ast.Name)
            and isinstance(n.iter, ast.Tuple)}


def _printed(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("module,extra", [
    ("bench_scaling", {"--cpu"}), ("profile_fused_run", {"--cpu"}),
])
def test_flags_are_the_scripts_plus_cpu(module, extra):
    assert _flags(_tree(f"flexs_tpu_torch/{module}.py")) == _flags(_script(module)) | extra


def test_hypotheses_and_programs_are_the_scripts():
    assert list(profile_surrogate_sweep.STEPS) == _dict_keys(
        _script("profile_surrogate_sweep"), "STEPS")
    assert list(profile_compile.PROFILES) == _dict_keys(_script("profile_compile"), "PROFILES")


def test_scaling_loops_and_grid_are_the_scripts():
    script = _script("bench_scaling")
    assert _loop_tuples(_function(script, "cpu_mesh_checks"))["n_dev"] == \
        bench_scaling.CPU_MESH_SIZES
    grid = _function(script, "tpu_grid_scaling")
    assert _loop_tuples(grid)["n_land"] == bench_scaling.WIDTHS
    kwargs = _literal_kwargs(_calls(grid, "dict")[0])
    assert kwargs["signal_strengths"] == list(bench_scaling.SIGNAL_STRENGTHS)
    assert kwargs["chunk_size"] == bench_scaling.CHUNK
    assert {k: kwargs[k] for k in bench_scaling.GRID_RUN} == bench_scaling.GRID_RUN
    (cfg,) = _calls(_function(script, "cpu_mesh_checks"), "AdaleadConfig")
    assert _literal_kwargs(cfg) == {**bench_scaling.CPU_MESH_RUN, "alphabet_size": 4}


def test_scaling_grid_matches_jax():
    """The default mode's grid: the JAX sweep's cells and start fitness, at 2 landscapes."""
    from flexs_tpu.landscapes import tf_binding as jax_tf_binding
    from flexs_tpu.parallel import run_robustness_sweep as jax_sweep

    port = bench_scaling.grid_sweep(2, device="cpu", **TINY_RUN)
    names, _ = jax_tf_binding._packed_tables()
    ref = jax_sweep(landscape_names=names[:2], starts=jax_tf_binding.STARTS[:1],
                    signal_strengths=[0.0, 0.5, 0.75, 0.9, 1.0], chunk_size=40, **TINY_RUN)
    cells = ["landscape", "start", "signal_strength", "seed"]
    assert len(port) == len(ref) == 10
    assert port[cells].values.tolist() == ref[cells].values.tolist()
    np.testing.assert_array_equal(port["start_fitness"].to_numpy(),
                                  ref["start_fitness"].to_numpy())
    assert list(port.columns) == list(ref.columns)


def test_cpu_mesh_passes_at_one_and_two_ranks():
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        calls = bench_scaling.cpu_mesh_checks(sizes=(1, 2))
    lines = text.getvalue().splitlines()
    assert lines[0].startswith("ranks=1: collectives while cells run=NONE; gathers=0; "
                               "cells/rank=8 (even=True)"), lines
    assert lines[1].startswith("ranks=2: collectives while cells run=NONE; gathers=1; "
                               "cells/rank=4 (even=True)"), lines
    assert "frame == 1-rank frame bitwise" in lines[1]
    assert lines[2].startswith("cpu-mesh check PASSED"), lines
    assert calls[2] == {"cells": [], "gathers": ["all_gather_object"], "other": []}


def test_counted_calls_see_a_collective_among_the_cells():
    """The counter is not blind: a call made while the cells run is counted as such."""
    import torch.distributed as dist

    from flexs_tpu_torch.parallel import multihost, sweep

    mesh = multihost.multihost_sweep_mesh()
    run_chunk = sweep._run_chunk

    def chatty(*args, **kwargs):
        dist.barrier(group=multihost.host_group())
        return run_chunk(*args, **kwargs)

    sweep._run_chunk = chatty
    try:
        with bench_scaling.counted_dist_calls() as calls:
            sweep.sweep_adalead_nam(*bench_scaling.cpu_mesh_grid(), mesh=mesh, device="cpu")
    finally:
        sweep._run_chunk = run_chunk
    assert calls["cells"] == ["barrier"] and calls["other"] == [], calls
    assert sweep._run_chunk is run_chunk


def test_fused_run_configuration_is_the_scripts():
    import flexs_tpu
    from flexs_tpu.runtime.jit_runner import AdaleadConfig as JaxConfig

    main = _function(_script("profile_fused_run"), "main")
    loops = _loop_tuples(main)
    assert loops["n"] == profile_fused_run.LOOP_NS
    assert loops["budget"] == profile_fused_run.BUDGETS
    assert loops["rounds"] == profile_fused_run.ROUNDS
    budget_cfg, rounds_cfg, trace_cfg = (_literal_kwargs(c) for c in _calls(main, "AdaleadConfig"))
    assert budget_cfg["rounds"] == profile_fused_run.BUDGET_ROUNDS
    assert rounds_cfg["model_queries_per_batch"] == profile_fused_run.ROUNDS_BUDGET
    assert trace_cfg["rounds"] == profile_fused_run.BUDGET_ROUNDS
    assert trace_cfg["model_queries_per_batch"] == profile_fused_run.ROUNDS_BUDGET
    for kw in (budget_cfg, rounds_cfg, trace_cfg):
        assert kw["sequences_batch_size"] == profile_fused_run.BATCH
    port = profile_fused_run.config(10, 2000)._asdict()
    ref = JaxConfig(rounds=10, sequences_batch_size=100, model_queries_per_batch=2000,
                    alphabet_size=4)._asdict()
    assert {k: port[k] for k in ref} == ref
    # The run: SIX6_REF_R1's first start; NAM 0.9 and key 0 in the script.
    run = profile_fused_run.FusedRun(torch.device("cpu"))
    problem = flexs_tpu.landscapes.tf_binding.registry()["SIX6_REF_R1"]
    start = flexs_tpu.alphabet.as_alphabet(flexs_tpu.DNAA).encode_one(problem["starts"][0])
    assert run.start.tolist() == list(start)
    (call,) = _calls(main, "run_adalead_nam")
    assert ast.literal_eval(call.args[4]) == 0.9
    assert ast.literal_eval(_calls(main, "PRNGKey")[0].args[0]) == 0


def test_compile_configuration_is_the_scripts():
    from flexs_tpu.landscapes import tf_binding as jax_tf_binding

    from flexs_tpu_torch.alphabet import as_alphabet
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    paper = _function(_script("profile_compile"), "_paper_args")
    (cfg_call,) = _calls(paper, "AdaleadConfig")
    (spec_call,) = _calls(paper, "SurrogateSpec")
    (args_call,) = _calls(paper, "device_run_args")
    letters, _, ss, seed = (ast.literal_eval(a) if isinstance(a, ast.Constant) else None
                            for a in args_call.args)
    for model in ("surrogate", "nam"):
        _, _, start, cfg, port_ss = profile_compile._paper_args(torch.device("cpu"), 10, model)
        kw = _literal_kwargs(cfg_call)
        assert {k: getattr(cfg, k) for k in kw} == kw
        assert cfg.perfect_model is False
        if model == "surrogate":
            assert cfg.surrogate._asdict() == SurrogateSpec(
                **_literal_kwargs(spec_call))._asdict()
        else:
            assert cfg.surrogate is None
        assert port_ss == ss and letters == "TGCA" and seed == 0
        encoded = as_alphabet(letters).encode_one(jax_tf_binding.STARTS[0])
        assert start.tolist() == list(encoded)
    parts = _function(_script("profile_compile"), "profile_surrogate_parts")
    assert _literal_kwargs(_calls(parts, "SurrogateSpec")[0]) == {"ensemble_size": 3}


def test_surrogate_sweep_configuration_is_the_scripts(monkeypatch):
    """Each hypothesis builds the script's spec, single runs and sweeps (starts, seeds, mode)."""
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    mod = profile_surrogate_sweep
    starts = mod._starts()
    made = []

    class Run:
        def run(self, verbose=True):
            return None

    def fake_single(spec, start=0, sizes=mod.SIZES, device=None):
        made.append(("single", spec, start))
        return Run()

    def fake_sweep(spec, starts=None, seeds=None, cell_mode="vmap", sizes=mod.SIZES,
                   device=None):
        made.append(("sweep", spec, starts, seeds, cell_mode))
        return lambda: [None] * sizes.cells

    monkeypatch.setattr(mod, "_single", fake_single)
    monkeypatch.setattr(mod, "_sweep", fake_sweep)
    monkeypatch.setattr(mod, "_median3", lambda fn, device: (fn(), (1.0, [1.0] * 3))[1])
    monkeypatch.setattr(mod, "timed", lambda fn, device: (fn(), 1.0))

    script = _script("profile_surrogate_sweep")
    namespace = {"STARTS": starts, "SurrogateSpec": SurrogateSpec}
    modes = {}
    for name in mod.STEPS:
        made.clear()
        with contextlib.redirect_stdout(io.StringIO()):
            reading, _ = mod.STEPS[name](mod.SIZES, "cpu")
        want, fn = [], _function(script, name)
        local = dict(namespace)
        for node in fn.body:  # the hypothesis's own names, e.g. h3's `spec`
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
                with contextlib.suppress(Exception):
                    local[node.targets[0].id] = eval(
                        compile(ast.Expression(node.value), "script", "eval"), local)
        for call in _calls(fn, "_single") + _calls(fn, "_sweep"):
            spec_node = call.args[0]
            spec = eval(compile(ast.Expression(spec_node), "script", "eval"), local)
            kw = {k.arg: eval(compile(ast.Expression(k.value), "script", "eval"), local)
                  for k in call.keywords}
            if call.func.id == "_single":
                want.append(("single", spec, kw.get("start", 0)))
            else:
                want.append(("sweep", spec, kw.get("starts"), kw.get("seeds"),
                             kw.get("cell_mode", "vmap")))
        assert sorted(map(repr, made)) == sorted(map(repr, want)), (name, made, want)
        modes[name] = reading["cell_mode"]
    assert modes == {"h0": "single", "h1": "serial", "h2": "vmap", "h3": "vmap", "h4": "vmap",
                     "h5": "single", "h6": "vmap", "h7": "map"}
    sweep_fn = _function(script, "_sweep")
    assert ast.literal_eval(sweep_fn.args.defaults[0]) == mod.SIZES.cells
    assert mod.sweep_grid(20) == (starts, [0, 1, 2, 3])
    cfg = _literal_kwargs(_calls(_function(script, "_single"), "DeviceAdaleadNAM")[0])
    assert cfg == {"rounds": mod.SIZES.rounds,
                   "sequences_batch_size": mod.SIZES.sequences_batch_size,
                   "model_queries_per_batch": mod.SIZES.model_queries_per_batch,
                   "model": "surrogate"}


def _check_card_and_launches(lines):
    assert lines
    for line in lines:
        assert line["card"] == "cpu" and line["duplex_launches"] == 0, line


def test_bench_scaling_lines_on_the_cpu():
    text = _printed(lambda: bench_scaling.grid_scaling(
        widths=(1, 2), warm_landscapes=1, device="cpu", **TINY_RUN))
    lines = _json_lines(text)
    _check_card_and_launches(lines)
    assert [list(line) for line in lines] == [
        ["cells", "wall_s", "cells_per_s", "seqs_per_s", "n_ranks", "duplex_launches",
         "card"]] * 2
    assert [line["cells"] for line in lines] == [5, 10]
    assert [line["n_ranks"] for line in lines] == [1, 1]
    assert "grid-width scaling on 1 rank(s) of cpu" in text


def test_device_ops_counts_ops_on_the_device_without_views():
    x = torch.ones(3)
    with profile_fused_run.DeviceOps(torch.device("cpu")) as ops:
        y = (x * 2).view(3, 1)
        y.add_(1)
    assert ops.n == 2
    with profile_fused_run.DeviceOps(torch.device("cuda")) as ops:
        x * 2
    assert ops.n == 0


def test_profile_fused_run_lines_on_the_cpu(tmp_path):
    trace = str(tmp_path / "trace")
    text = _printed(lambda: profile_fused_run.main(
        ["--cpu", "--trace", trace], loop_ns=(20,), budgets=(20, 40), rounds=(1, 2), reps=2,
        batch=5, budget_rounds=2, rounds_budget=20))
    lines = _json_lines(text)
    _check_card_and_launches(lines)
    assert [line["reading"] for line in lines] == [
        "host_loop", "host_loop", "budget", "budget", "rounds", "rounds", "trace"]
    for line in lines[2:6]:
        assert line["host_syncs"] > 0 and line["draw_calls"] > 0 and line["wall_s"] > 0, line
        assert line["device_ops"] > 0, line
        assert line["device_ops_per_sync"] == line["device_ops"] / line["host_syncs"], line
    assert [line["sync_each"] for line in lines[:2]] == [False, True]
    assert lines[-1]["files"] == os.listdir(trace) and len(lines[-1]["files"]) == 1
    assert "wall vs budget (rounds=2, B=5):" in text and "  budget 40:" in text
    assert "host loop x20, a sync each:" in text


def test_profile_surrogate_sweep_lines_on_the_cpu():
    sizes = profile_surrogate_sweep.Sizes(1, 5, 20, 2)
    text = _printed(lambda: profile_surrogate_sweep.main(["--cpu", "h0", "h7"], sizes=sizes))
    lines = _json_lines(text)
    _check_card_and_launches(lines)
    keys = ["hypothesis", "median_s", "walls_s", "s_per_cell", "cells", "cell_mode",
            "single_median_s", "duplex_launches", "card"]
    assert [list(line) for line in lines] == [keys, keys]
    assert [(l["hypothesis"], l["cells"], l["cell_mode"]) for l in lines] == [
        ("h0", 1, "single"), ("h7", 2, "map")]
    assert all(len(l["walls_s"]) == 3 and l["median_s"] in l["walls_s"] for l in lines)
    assert "h0 single cnn run:" in text and "h7 shipped grid" in text


def test_h7_cell_equals_a_standalone_run():
    from flexs_tpu_torch.runtime.surrogate import SurrogateSpec

    sizes = profile_surrogate_sweep.Sizes(1, 5, 20, 2)
    with contextlib.redirect_stdout(io.StringIO()):
        _, frame = profile_surrogate_sweep.h7(sizes, "cpu")
    df, _ = profile_surrogate_sweep._single(SurrogateSpec(), sizes=sizes, device="cpu").run(
        verbose=False)
    assert frame["max_fitness"].iloc[0] == max(df["true_score"].max(),
                                               frame["start_fitness"].iloc[0])


def test_profile_compile_lines_on_the_cpu():
    text = _printed(lambda: profile_compile.main(["--cpu", "surrogate_parts"], rounds=1))
    lines = _json_lines(text)
    _check_card_and_launches(lines)
    assert [l["program"] for l in lines] == [
        "surrogate.train 3xCNN cap1002", "surrogate 16x4096 predict", "1-round train+score"]
    for line in lines:
        assert list(line) == ["profile", "program", "import_context_s", "first_run_s",
                              "second_run_s", "first_minus_second_s", "duplex_launches", "card"]
        assert line["import_context_s"] > 0 and line["first_run_s"] > 0
        assert line["first_minus_second_s"] == line["first_run_s"] - line["second_run_s"]


def test_unknown_names_are_refused():
    with pytest.raises(SystemExit):
        profile_compile.main(["--cpu", "nope"])
    with pytest.raises(SystemExit):
        profile_surrogate_sweep.main(["--cpu", "h9"])


@pytest.fixture(scope="module")
def no_card_runs():
    """Each module run as a program with no card visible and without --cpu, all at once."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    procs = {m: subprocess.Popen([sys.executable, "-m", f"flexs_tpu_torch.{m}",
                                  *NO_CARD_ARGS[m]], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m in MODULES}
    return {m: (p.communicate(timeout=120), p.returncode) for m, p in procs.items()}


@pytest.mark.parametrize("module", MODULES)
def test_without_a_card_exits_1_and_prints_nothing(module, no_card_runs):
    (out, err), rc = no_card_runs[module]
    assert rc == 1, (rc, err[-2000:])
    assert out == "", out
    assert "CUDA was requested" in err

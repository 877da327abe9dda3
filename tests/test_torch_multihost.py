"""`mesh=` on torch.distributed: the port's counterpart of the JAX multihost tests.

tests/test_multihost_sweep.py runs one sweep over two coordinated JAX
processes; here two processes join a gloo group and run the same 8-cell
SIX6_REF_R1 grid over `multihost_sweep_mesh()`.  Both ranks must gather
the same frame, equal bitwise to the port's `mesh=None` run, since a
cell's result is its own.  The same workers resume a checkpointed sweep
written with world size 1, and fit a CNN data-parallel.

tests/test_mesh_all_algorithms.py shards every fused family over 8
devices.  Here each family's split over a world of 4 runs in this process
rank by rank (the mesh's share and gather replaced by the rank's view),
and the ranks' rows, put together, equal the unsharded frame bitwise; a
real one-rank mesh also equals `mesh=None` bitwise.

Against the JAX package only the grid is compared (cells, start fitness,
schema): JAX's sweep draws from `jax.random`, the port's from
`torch.Generator`.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import flexs_tpu
from flexs_tpu.parallel.sweep import run_landscape_robustness_sweep as jax_sweep

import flexs_tpu_torch as flexs
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.parallel import multihost, run_landscape_robustness_sweep, sweep
from flexs_tpu_torch.runtime import VAEConfig

import torch_multihost_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 300

# The families and budgets of tests/test_mesh_all_algorithms.py.
FAMILIES = {
    "adalead": {},
    "random": {"batch": 8},
    "ga": {"population_size": 8, "children_proportion": 0.5},
    "cmaes": {"population_size": 6, "max_iter": 10},
    "bo": {"num_chains": 4},
    "gpr_bo": {},
    "dqn": {"memory_size": 128, "train_epochs": 2},
    "ppo": {"train_epochs": 2},
    "dynappo": {"env_batch_size": 4, "train_epochs": 2},
    "dynappo_mutative": {"env_batch_size": 4, "episode_len": 8, "train_epochs": 2},
    "cbas": {"vae_cfg": VAEConfig(intermediate_dim=16, epochs=2), "cycle_batch_size": 12},
    "dbas": {"vae_cfg": VAEConfig(intermediate_dim=16, epochs=2), "cycle_batch_size": 12},
}
FAMILY_GRID = dict(starts=tf_binding.STARTS[:4], signal_strengths=[1.0], seeds=[0, 1],
                   rounds=2, sequences_batch_size=3, model_queries_per_batch=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel worker processes."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def one_rank_mesh():
    return multihost.multihost_sweep_mesh()


def _family_sweep(algorithm, mesh, **kw):
    landscape = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device="cpu")
    return run_landscape_robustness_sweep(
        [landscape], flexs.DNAA, mesh=mesh, algorithm=algorithm,
        algorithm_kwargs=FAMILIES[algorithm], device="cpu", **{**FAMILY_GRID, **kw},
    )


@pytest.fixture(scope="module")
def unsharded():
    """{algorithm: the mesh=None frame}, each family run once for the module."""
    frames = {}

    def get(algorithm):
        if algorithm not in frames:
            frames[algorithm] = _family_sweep(algorithm, None)
        return frames[algorithm]

    return get


def _rank_rows(n: int, chunk_size, size: int, rank: int) -> list:
    """The cells (frame rows) that `rank` of `size` runs, as the sweep splits them."""
    if chunk_size is not None:
        chunk_size = -(-chunk_size // size) * size
    if chunk_size is None or chunk_size >= n:
        chunk_size = None
        chunks = [(0, n)]
    else:
        chunks = [(i, min(i + chunk_size, n)) for i in range(0, n, chunk_size)]
    rows = []
    for lo, hi in chunks:
        dispatched = chunk_size or -(-(hi - lo) // size) * size
        share = dispatched // size
        rows += [lo + p for p in range(rank * share, (rank + 1) * share) if p < hi - lo]
    return rows


def _split_by_rank(monkeypatch, run, size: int):
    """`run(mesh)` once per rank of a world of `size`, in this process.

    The mesh's share is the rank's, and the gather hands back the rank's
    own share in every rank's place: the rows of the rank's cells are then
    the rank's results.  Returns ({rank: frame}, the cells of each share
    the rank ran).
    """
    frames, shares = {}, []

    def gather(tree, mesh):
        shares.append(len(tree[0]))
        return type(tree)(*(np.concatenate([x.cpu().numpy()] * size) for x in tree))

    for rank in range(size):
        monkeypatch.setattr(multihost, "mesh_share", lambda mesh, r=rank: (r, size))
        monkeypatch.setattr(multihost, "gather_to_host", gather)
        frames[rank] = run(object())
    monkeypatch.undo()
    return frames, shares


@pytest.mark.parametrize("algorithm", list(FAMILIES))
def test_family_split_over_four_ranks_equals_unsharded(monkeypatch, unsharded, algorithm):
    want = unsharded(algorithm)
    frames, shares = _split_by_rank(
        monkeypatch, lambda mesh: _family_sweep(algorithm, mesh), 4
    )
    assert shares == [2] * 4  # each rank ran its 2 of the 8 cells
    got = pd.concat([frames[r].iloc[_rank_rows(len(want), None, 4, r)] for r in range(4)])
    pd.testing.assert_frame_equal(got.sort_index(), want, check_exact=True)
    assert len(want) == 8 and (want["model_cost"] > 0).all()
    assert (want["max_fitness"] >= want["start_fitness"]).all()
    assert want["start_fitness"].nunique() > 1


@pytest.mark.parametrize("algorithm", list(FAMILIES))
def test_one_rank_mesh_equals_no_mesh(one_rank_mesh, unsharded, algorithm):
    assert tuple(one_rank_mesh.shape) == (1, 1)
    got = _family_sweep(algorithm, one_rank_mesh)
    pd.testing.assert_frame_equal(got, unsharded(algorithm), check_exact=True)


@pytest.mark.parametrize("chunk_size,cells", [(3, 8), (2, 5), (None, 5)])
def test_chunked_split_pads_and_drops(monkeypatch, chunk_size, cells):
    """Chunks round up to the mesh's size; short grids pad by wrapping; padding is dropped."""
    starts = tf_binding.STARTS[:cells]

    def run(mesh):
        return sweep.run_robustness_sweep(
            ["SIX6_REF_R1"], starts, signal_strengths=[0.9], rounds=2, sequences_batch_size=3,
            model_queries_per_batch=12, mesh=mesh, chunk_size=chunk_size, device="cpu",
        )

    want = run(None)
    frames, shares = _split_by_rank(monkeypatch, run, 4)
    chunk = -(-(chunk_size or cells) // 4) * 4
    assert shares == [chunk // 4] * (4 * -(-cells // chunk))
    got = pd.concat([frames[r].iloc[_rank_rows(cells, chunk_size, 4, r)] for r in range(4)])
    assert sorted(got.index) == list(range(cells))
    pd.testing.assert_frame_equal(got.sort_index(), want, check_exact=True)


def test_pad_cells_to_mesh_wraps():
    np.testing.assert_array_equal(sweep._pad_cells_to_mesh(4, np.arange(5)),
                                  [0, 1, 2, 3, 4, 0, 1, 2])
    np.testing.assert_array_equal(sweep._pad_cells_to_mesh(8, np.arange(3)),
                                  [0, 1, 2, 0, 1, 2, 0, 1])
    np.testing.assert_array_equal(sweep._pad_cells_to_mesh(2, np.arange(4)), np.arange(4))


def test_gather_and_share_on_one_rank(one_rank_mesh):
    tree = sweep.RunResult(*([torch.arange(3)] * len(sweep.RunResult._fields)))
    out = multihost.gather_to_host(tree, one_rank_mesh)
    assert isinstance(out, sweep.RunResult)
    assert all(isinstance(x, np.ndarray) and list(x) == [0, 1, 2] for x in out)
    assert multihost.mesh_share(one_rank_mesh) == (0, 1)
    assert multihost.mesh_share(None) == (0, 1)
    assert multihost.broadcast_from_first("first", one_rank_mesh) == "first"


def test_host_frames_use_a_gloo_group_under_another_default_backend(one_rank_mesh,
                                                                   monkeypatch):
    """Under an NCCL default group the gathers get a gloo group of their own, made once."""
    assert multihost.host_group() is None  # the default group is gloo here
    monkeypatch.setattr(multihost.dist, "get_backend", lambda group=None: "nccl")
    group = multihost.host_group()
    assert group is not None and multihost.host_group() is group
    monkeypatch.undo()
    x = torch.arange(3.0)
    torch.distributed.all_reduce(x, group=group)
    assert x.tolist() == [0.0, 1.0, 2.0]


def test_torch_model_one_rank_mesh_is_the_unsharded_fit(one_rank_mesh):
    torch.testing.assert_close(
        torch.as_tensor(worker.fit(one_rank_mesh)), torch.as_tensor(worker.fit(None)),
        rtol=0, atol=0,
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sweep_over_gloo(tmp_path, one_rank_mesh):
    # A one-rank run writes its checkpoints; the two ranks resume them with
    # the last chunk gone.
    ckpt = str(tmp_path / "ckpt")
    written = worker.sweep(one_rank_mesh, chunk_size=2, checkpoint_dir=ckpt)
    chunks = sorted(f for f in os.listdir(ckpt) if f.endswith(".npz"))
    assert len(chunks) == 4
    os.remove(os.path.join(ckpt, chunks[-1]))
    kept = {f: os.stat(os.path.join(ckpt, f)).st_mtime_ns for f in chunks[:-1]}

    port, world = _free_port(), 2
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_multihost_worker.py"),
             str(port), str(world), str(rank), str(tmp_path), ckpt],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    ref_path = str(tmp_path / "ref.csv")
    ref = worker.sweep(None)
    ref.to_csv(ref_path, index=False)
    ref = pd.read_csv(ref_path)
    frames = [pd.read_csv(tmp_path / f"sweep_{r}.csv") for r in range(world)]
    assert len(frames[0]) == 8
    # Every rank gathered the same full result, equal to the mesh=None run.
    for frame in frames:
        pd.testing.assert_frame_equal(frame, ref, check_exact=True)

    # The resumed sweep: the kept chunks were loaded, the missing one run
    # over both ranks and written by rank 0 alone.
    pd.testing.assert_frame_equal(written, worker.sweep(None), check_exact=True)
    for r in range(world):
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / f"resumed_{r}.csv"), ref,
                                      check_exact=True)
    assert {f: os.stat(os.path.join(ckpt, f)).st_mtime_ns for f in chunks[:-1]} == kept
    assert os.path.exists(os.path.join(ckpt, chunks[-1]))

    # The data-parallel fit: both ranks hold the same weights, the unsharded
    # fit's within 1e-5 of its norm (the sums run in another order).
    fits = [np.load(tmp_path / f"fit_{r}.npy") for r in range(world)]
    np.testing.assert_array_equal(fits[0], fits[1])
    want = worker.fit(None)
    assert np.linalg.norm(fits[0] - want) <= 1e-5 * np.linalg.norm(want)

    # The JAX package's run of the same grid: same cells and start fitness.
    problem = flexs_tpu.landscapes.tf_binding.registry()["SIX6_REF_R1"]
    grid = dict(worker.GRID)
    jax_ref = jax_sweep(
        [flexs_tpu.landscapes.TFBinding(**problem["params"])], flexs_tpu.DNAA,
        starts=flexs_tpu.landscapes.tf_binding.STARTS[: grid.pop("starts_count")], **grid,
    )
    cells = ["landscape", "start", "signal_strength", "seed"]
    pd.testing.assert_frame_equal(ref[cells], jax_ref[cells].astype(ref[cells].dtypes))
    np.testing.assert_allclose(ref["start_fitness"], jax_ref["start_fitness"], atol=1e-6)
    assert list(ref.columns) == list(jax_ref.columns)

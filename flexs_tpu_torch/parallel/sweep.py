"""Sweep engine: many fused runs as lockstep batches of cells.

The reference's evaluators loop serially over sweep cells (reference
evaluate.py:27-36) and its paper experiments scaled out with independent
cloud VMs (paper_code/cloud/runner.py:90-126).  Here a grid — landscape x
starting sequence x signal strength x seed — runs in chunks of cells, each
chunk one lockstep batch on one device through a fused runner's cell-axis
entry point (`algorithm=`: Adalead by default, or Random, GA, CMA-ES, BO,
GPR_BO, CbAS, DbAS, DQN, PPO, DynaPPO or mutative DynaPPO): the
counterpart of the JAX package's vmapped sweep.
A cell's result depends only on its own (landscape, start, signal
strength, seed), so it equals the standalone fused run with that seed,
whatever its chunk.

Two engines share the chunking, checkpoints and summary:
  * `run_robustness_sweep` over TF-binding landscapes: every cell carries
    an index into one stacked table tensor, so a 200-landscape sweep holds
    one [200, 65536] f32 tensor whatever the grid's size;
  * `run_landscape_robustness_sweep` over any family of landscapes that
    share one device fitness function (RNABinding, AdditiveAAVPackaging,
    RosettaFolding, TFBinding problems), with any fused model (NAM,
    perfect, or a trained surrogate).  Landscape params are not stacked
    (an RNABinding landscape's params hold its kernel plan): a chunk's
    cells are grouped by landscape, and each landscape's own oracle scores
    its cells' rows, one call per landscape present.

With `mesh=` (a `parallel.multihost.multihost_sweep_mesh()` of several
ranks), each chunk of cells is split over the mesh's ranks: every rank
runs its share in lockstep, and the chunk's result is gathered to every
rank, as in the JAX package (the cells are padded by wrapping to a
multiple of the mesh's size, and the padding is dropped).  Since a cell's
result is its own, a mesh of any size gives the `mesh=None` frame bitwise.
"""
import dataclasses
import hashlib
import json
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from flexs_tpu_torch.alphabet import Alphabet, as_alphabet
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.landscapes import tf_binding
from flexs_tpu_torch.parallel import multihost
from flexs_tpu_torch.runtime import surrogate as surrogate_lib
from flexs_tpu_torch.runtime.bo_runner import run_bo_nam_cells
from flexs_tpu_torch.runtime.cbas_runner import VAEConfig, run_cbas_nam_cells
from flexs_tpu_torch.runtime.cmaes_runner import run_cmaes_nam_cells
from flexs_tpu_torch.runtime.dqn_runner import run_dqn_nam_cells
from flexs_tpu_torch.runtime.dyna_ppo_mutative_runner import run_dyna_ppo_mutative_nam_cells
from flexs_tpu_torch.runtime.dyna_ppo_runner import SURROGATE_ERROR, run_dyna_ppo_nam_cells
from flexs_tpu_torch.runtime.ga_runner import run_ga_nam_cells
from flexs_tpu_torch.runtime.gpr_bo_runner import run_gpr_bo_nam_cells
from flexs_tpu_torch.runtime.jit_runner import (
    AdaleadConfig,
    RunResult,
    run_adalead_nam_cells,
)
from flexs_tpu_torch.runtime.ppo_runner import run_ppo_nam_cells
from flexs_tpu_torch.runtime.random_runner import run_random_nam_cells

# Each ported algorithm's cell-axis entry point and the JAX sweep's defaults
# for its hyperparameters (flexs_tpu/parallel/sweep.py, `_cell_runner`).
CELL_RUNNERS = {
    "adalead": (run_adalead_nam_cells, {}),
    "random": (run_random_nam_cells, {"batch": 64, "mu": 1.0}),
    "ga": (run_ga_nam_cells, {
        "population_size": 100, "parent_selection_strategy": "wright-fisher",
        "children_proportion": 0.2, "parent_selection_proportion": 0.3, "beta": 0.05,
    }),
    "cmaes": (run_cmaes_nam_cells, {
        "population_size": 15, "max_iter": 400, "initial_variance": 0.2, "maximize": False,
    }),
    "bo": (run_bo_nam_cells, {"num_chains": 10, "method": "EI"}),
    "gpr_bo": (run_gpr_bo_nam_cells, {"method": "Thompson"}),
    "cbas": (run_cbas_nam_cells, {
        "algo": "cbas", "vae_cfg": VAEConfig(), "Q": 0.7, "cycle_batch_size": 100,
        "mutation_rate": 0.2,
    }),
    "dbas": (run_cbas_nam_cells, {
        "algo": "dbas", "vae_cfg": VAEConfig(), "Q": 0.7, "cycle_batch_size": 100,
        "mutation_rate": 0.2,
    }),
    "dqn": (run_dqn_nam_cells, {"memory_size": 4096, "train_epochs": 20, "gamma": 0.9}),
    "ppo": (run_ppo_nam_cells, {"train_epochs": 10}),
    "dynappo": (run_dyna_ppo_nam_cells, {"env_batch_size": 16, "num_model_rounds": 1}),
    "dynappo_mutative": (run_dyna_ppo_mutative_nam_cells, {
        "env_batch_size": 16, "episode_len": 20, "num_model_rounds": 1,
    }),
}


def _cell_runner(algorithm: str, algorithm_kwargs: Optional[dict]) -> Callable:
    """`(fitness_fn, params, start_tokens, cfg, signal_strengths, generators) -> RunResult`
    of `algorithm` with `algorithm_kwargs` over its defaults."""
    fn, defaults = CELL_RUNNERS[algorithm]
    kwargs = {**defaults, **(algorithm_kwargs or {})}
    return lambda *args: fn(*args, **kwargs)


def _indexed_table_fitness(params, tokens):
    """Fitness f32[C, B] via shared stacked tables: params = (tables, table_idx[C])."""
    tables, idx = params
    return tables[idx[:, None], tf_binding.tokens_to_index(tokens)]


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _grouped_fitness(params, tokens):
    """Fitness f32[C, B] of int64[C, B, L]: each landscape's oracle on its own cells.

    params = (fitness fn, the landscapes' params, groups), a group being
    (landscape index, int64 tensor of the cells on it).
    """
    fitness_fn, land_params, groups = params
    c, b, length = tokens.shape
    if len(groups) == 1:
        return fitness_fn(land_params[groups[0][0]], tokens.reshape(c * b, length)).reshape(c, b)
    out = torch.empty((c, b), device=tokens.device)
    for li, cells in groups:
        out[cells] = fitness_fn(land_params[li], tokens[cells].reshape(-1, length)).reshape(-1, b)
    return out


def _run_chunk(fitness_fn, cell_params: Callable, start_tokens, signal_strengths, seeds, cfg,
               device, cell_mode, cell_runner: Callable = run_adalead_nam_cells):
    """RunResult (tensors, leading cell axis) of one chunk of cells.

    `cell_params(positions)` gives the oracle's params for those cells of
    the chunk (a list of positions); `cell_runner` is the algorithm's
    cell-axis entry point.
    """
    start = torch.as_tensor(start_tokens, device=device)
    gens = [_generator(s, device) for s in seeds]

    def run(pos):
        return cell_runner(
            fitness_fn, cell_params(pos), start[pos], cfg, signal_strengths[pos],
            [gens[i] for i in pos],
        )

    if cell_mode == "vmap":
        return run(list(range(len(gens))))
    # "map": one cell at a time through the same runner, so each cell's
    # loops run their own trip counts.
    outs = [run([c]) for c in range(len(gens))]
    return RunResult(*(torch.cat(xs) for xs in zip(*outs)))


def _pad_cells_to_mesh(size: int, idx: np.ndarray) -> np.ndarray:
    """Cell indices padded to a multiple of the mesh's size by wrapping.

    Wrapping pads grids smaller than the mesh fully; the padding repeats
    real cells, and their rows are dropped.
    """
    pad = (-len(idx)) % size
    return np.concatenate([idx, idx[np.arange(pad) % len(idx)]]) if pad else idx


def _run_in_chunks(n: int, chunk_size: Optional[int], checkpoint_dir: Optional[str],
                   signature: Callable, run_chunk: Callable, mesh=None) -> RunResult:
    """RunResult (numpy, leading cell axis) of n cells, `run_chunk(cell indices)` per chunk.

    The tail chunk is padded to `chunk_size` by repeating cell 0, and the
    padding is dropped.  With `checkpoint_dir`, each finished chunk is
    saved and a rerun of the same sweep (`signature(chunk_size)`) loads it.
    With a `mesh`, `chunk_size` is rounded up to a multiple of its size,
    each chunk is split over its ranks, and its result is gathered to every
    rank; the mesh's first rank alone decides whether a chunk is on disk
    and alone writes checkpoints, so the chunk files do not depend on the
    world size.
    """
    position, size = multihost.mesh_share(mesh)
    if chunk_size is not None:
        chunk_size = -(-chunk_size // size) * size
    if chunk_size is None or chunk_size >= n:
        chunk_size = None  # one exact-size batch, no padding
        chunks = [(0, n)]
    else:
        chunks = [(i, min(i + chunk_size, n)) for i in range(0, n, chunk_size)]
    writer = position == 0
    if checkpoint_dir is not None:
        _init_checkpoint_dir(checkpoint_dir, signature(chunk_size), writer)

    results = []
    for ci, (lo, hi) in enumerate(chunks):
        if checkpoint_dir is not None:
            chunk_path = _checkpoint_chunk_path(checkpoint_dir, ci)
            # Every rank must take the same branch: follow the first rank's
            # view (the load needs a file system that every rank shares).
            if multihost.broadcast_from_first(os.path.exists(chunk_path), mesh):
                with np.load(chunk_path) as data:
                    results.append(RunResult(**{k: data[k] for k in data.files}))
                continue
        idx = np.arange(lo, hi)
        if chunk_size is not None and len(idx) < chunk_size:
            idx = np.concatenate([idx, np.zeros(chunk_size - len(idx), np.int64)])
        if mesh is None:
            out = [x.cpu().numpy() for x in run_chunk(idx)]
        else:
            idx = _pad_cells_to_mesh(size, idx)
            share = len(idx) // size
            out = multihost.gather_to_host(
                run_chunk(idx[position * share:(position + 1) * share]), mesh
            )
        out = RunResult(*(x[: hi - lo] for x in out))
        if checkpoint_dir is not None and writer:
            # A crash mid-save must not leave a readable partial chunk.
            tmp = chunk_path + ".tmp.npz"
            np.savez(tmp, **out._asdict())
            os.replace(tmp, chunk_path)
        results.append(out)
    if len(results) == 1:
        return results[0]
    return RunResult(*(np.concatenate(xs, axis=0) for xs in zip(*results)))


def sweep_adalead_nam(
    tables,
    table_idx,
    start_tokens,
    signal_strengths,
    seeds,
    cfg: AdaleadConfig,
    mesh=None,
    chunk_size: Optional[int] = None,
    *,
    device=None,
    cell_mode: str = "vmap",
    checkpoint_dir: Optional[str] = None,
) -> RunResult:
    """Run a flat batch of C sweep cells on one device, or split over a mesh of ranks.

    Args:
        tables: f32[num_landscapes, 4^L] stacked score tables (shared).
        table_idx: int[C] landscape index per cell.
        start_tokens: int[C, L] starting sequence per cell.
        signal_strengths: f32[C] NAM alpha per cell.
        seeds: int[C] generator seed per cell.
        cfg: Adalead configuration (the same for every cell).
        mesh: Optional `DeviceMesh` of ranks
            (`parallel.multihost.multihost_sweep_mesh`): each chunk is
            split over its ranks, and every rank gets the whole result.
        chunk_size: Run at most this many cells per lockstep batch (each
            cell carries O(rounds * queries) device buffers, so wide grids
            must be chunked to fit device memory).  The tail chunk is
            padded to `chunk_size` by repeating cell 0; the padding is
            dropped.  With a mesh it is rounded up to a multiple of the
            mesh's size.
        device: Where this rank's cells run (default "cuda").
        cell_mode: "vmap" runs a chunk's cells in lockstep; "map" runs them
            one by one through the same runner.  Results are identical.
        checkpoint_dir: Resume point: each finished chunk is written to
            `<dir>/chunk_<i>.npz`, and a rerun of the same sweep (same
            tables, grid, configuration and chunking, pinned by a signature
            in `<dir>/manifest.json`) loads it instead of running it.  A
            different sweep in the same directory raises ValueError.  With
            a mesh, the mesh's first rank writes the files.

    Returns:
        `RunResult` of numpy arrays with a leading cell axis on every field.
    """
    if cell_mode not in ("vmap", "map"):
        raise ValueError("cell_mode must be 'vmap' or 'map'")
    device = resolve_device(device)
    tables = torch.as_tensor(tables, dtype=torch.float32, device=device)
    table_idx = np.asarray(table_idx, np.int64)
    start_tokens = np.asarray(start_tokens, np.int64)
    signal_strengths = np.asarray(signal_strengths, np.float32)
    seeds = np.asarray(seeds, np.int64)

    def run_chunk(idx):
        chunk_tables = torch.as_tensor(table_idx[idx], device=device)
        return _run_chunk(
            _indexed_table_fitness, lambda pos: (tables, chunk_tables[pos]), start_tokens[idx],
            signal_strengths[idx], seeds[idx], cfg, device, cell_mode,
        )

    return _run_in_chunks(
        len(table_idx), chunk_size, checkpoint_dir,
        lambda cs: _sweep_signature(
            "adalead", None, cfg, cs, tables, table_idx, start_tokens, signal_strengths, seeds
        ),
        run_chunk, mesh,
    )


def _algorithm_fields(algorithm: str, algorithm_kwargs: Optional[dict]) -> dict:
    """The signature's algorithm entries (a NamedTuple value enters as its fields' values)."""
    return {"algorithm": algorithm,
            "algorithm_kwargs": sorted((algorithm_kwargs or {}).items())}


def _sweep_signature(algorithm, algorithm_kwargs, cfg, chunk_size, tables, table_idx,
                     start_tokens, ss_arr, seed_arr) -> str:
    """Stable signature of everything that determines a sweep's results.

    Each landscape used enters as a content fingerprint of its table (sum,
    sum of squares and first element in f32, reduced on the device and
    fetched once), so two tables of one shape that differ only in values
    give different signatures.  Reductions are deterministic per device
    type, so resuming on another (CPU vs CUDA) is treated as another sweep.
    """
    used = np.unique(table_idx)
    rows = tables[torch.as_tensor(used, device=tables.device)]
    stats = torch.stack([rows.sum(dim=1), (rows * rows).sum(dim=1), rows[:, 0]], dim=1)
    fingerprints = {
        int(i): row.tobytes().hex() for i, row in zip(used, stats.cpu().numpy())
    }
    h = hashlib.sha256()
    h.update(
        json.dumps(
            {
                **_algorithm_fields(algorithm, algorithm_kwargs),
                "cfg": cfg._asdict(),
                "chunk_size": chunk_size,
                "fitness_fn": f"{_indexed_table_fitness.__module__}."
                f"{_indexed_table_fitness.__qualname__}",
                "tables": [list(tables.shape), str(tables.dtype), str(tables.device.type)],
                "fingerprints": fingerprints,
            },
            default=str,
            sort_keys=True,
        ).encode()
    )
    for arr in (table_idx, start_tokens, ss_arr, seed_arr):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _tensor_leaves(obj):
    """The tensors in a landscape's params (tuples, dicts, dataclasses), in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for key in sorted(obj):
            yield from _tensor_leaves(obj[key])
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensor_leaves(x)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensor_leaves(getattr(obj, f.name))


def _landscape_sweep_signature(algorithm, algorithm_kwargs, model, surrogate_spec, cfg,
                               chunk_size, landscapes, fitness_fn, land_idx, start_tokens,
                               ss_arr, seed_arr, device) -> str:
    """Stable signature of everything that determines a landscape sweep's results.

    Each landscape enters by name, by the shapes and dtypes of its params'
    tensors and by a content fingerprint of them (sum, sum of squares and
    first element in f32, reduced on the device and fetched once per
    landscape), so two problems that share a name, a fitness function and
    shapes still differ.  Only the surrogate spec's non-default fields
    enter, so a new field at its default keeps old checkpoints valid.
    """
    params_spec = []
    for land in landscapes:
        leaves = [x for x in _tensor_leaves(land.device_fitness()[1]) if x.numel()]
        stats = [
            torch.stack([x.float().sum(), x.float().square().sum(), x.reshape(-1)[0].float()])
            for x in leaves
        ]
        fingerprint = torch.cat(stats).cpu().numpy().tobytes().hex() if stats else ""
        params_spec.append([[list(x.shape), str(x.dtype)] for x in leaves] + [fingerprint])
    default_spec = surrogate_lib.SurrogateSpec()._asdict()
    h = hashlib.sha256()
    h.update(
        json.dumps(
            {
                **_algorithm_fields(algorithm, algorithm_kwargs),
                "model": model,
                "surrogate_spec": (
                    sorted((k, v) for k, v in surrogate_spec._asdict().items()
                           if v != default_spec[k])
                    if surrogate_spec else None
                ),
                "cfg": {k: v for k, v in cfg._asdict().items() if k != "surrogate"},
                "chunk_size": chunk_size,
                "landscapes": [land.name for land in landscapes],
                "fitness_fn": f"{fitness_fn.__module__}.{fitness_fn.__qualname__}",
                "params_spec": params_spec,
                "device": device.type,
            },
            default=str,
            sort_keys=True,
        ).encode()
    )
    for arr in (land_idx, start_tokens, ss_arr, seed_arr):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _checkpoint_chunk_path(checkpoint_dir: str, i: int) -> str:
    return os.path.join(checkpoint_dir, f"chunk_{i:05d}.npz")


def _init_checkpoint_dir(checkpoint_dir: str, signature: str, writer: bool) -> None:
    """Create the dir and pin the sweep signature; reject a mismatched resume.

    Only the `writer` (the mesh's first rank) writes the manifest.
    """
    os.makedirs(checkpoint_dir, exist_ok=True)
    manifest = os.path.join(checkpoint_dir, "manifest.json")
    if os.path.exists(manifest):
        try:
            with open(manifest) as f:
                prev = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir!r} has a corrupt "
                "manifest.json (interrupted initialization?); clear the "
                "directory and rerun"
            ) from e
        if prev.get("signature") != signature:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir!r} holds chunks of a "
                "DIFFERENT sweep (landscapes/grid/model/budget changed); "
                "clear it or point at a fresh directory"
            )
    elif writer:
        # Atomic write: a crash mid-write must not leave a truncated
        # manifest that poisons every future resume.
        tmp = manifest + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"signature": signature}, f)
        os.replace(tmp, manifest)


def _summary_df(result, cells) -> pd.DataFrame:
    """Per-cell summary rows, in the JAX package's columns, dtypes and order.

    `cells` yields (landscape_name, start, signal_strength, seed) per
    leading result row; result rows beyond len(cells) are dropped.
    """
    truth = np.where(result.proposal_valid, result.proposal_truth, -np.inf)
    max_fitness = np.maximum(truth.max(axis=(1, 2)), result.start_truth)
    return pd.DataFrame(
        [
            {
                "landscape": ln,
                "start": st,
                "signal_strength": ss,
                "seed": sd,
                "max_fitness": float(max_fitness[i]),
                "start_fitness": float(result.start_truth[i]),
                "model_cost": int(result.model_cost[i, -1]),
                "landscape_cost": int(result.landscape_cost[i, -1]),
            }
            for i, (ln, st, ss, sd) in enumerate(cells)
        ]
    )


def _check_options(mesh, algorithm, model, surrogate_spec, cell_mode) -> str:
    """The cell mode "auto" resolves to; raises for a wrong option.

    "auto" is "map" for a trained surrogate (a chunk's cells would run
    their data-dependent loops in lockstep while each cell's training is
    a fixed cost) and "vmap" otherwise, as in the JAX package.  A mesh that
    is not a `DeviceMesh` over every rank raises TypeError or ValueError.
    """
    multihost.mesh_share(mesh)
    if algorithm not in CELL_RUNNERS:
        raise ValueError(f"unknown fused algorithm {algorithm!r}")
    if model not in ("nam", "perfect", "surrogate"):
        raise ValueError("model must be 'nam', 'perfect' or 'surrogate'")
    if model == "surrogate":
        if algorithm in ("dynappo", "dynappo_mutative"):
            raise ValueError(SURROGATE_ERROR)
        surrogate_lib.check_spec(surrogate_spec or surrogate_lib.SurrogateSpec())
    if cell_mode == "auto":
        return "map" if model == "surrogate" else "vmap"
    if cell_mode not in ("vmap", "map"):
        raise ValueError("cell_mode must be 'auto', 'vmap' or 'map'")
    return cell_mode


def run_landscape_robustness_sweep(
    landscapes: Sequence,
    alphabet,
    starts: Sequence[str],
    signal_strengths: Sequence[float] = (0.0, 0.5, 0.75, 0.9, 1.0),
    seeds: Sequence[int] = (0,),
    rounds: int = 10,
    sequences_batch_size: int = 100,
    model_queries_per_batch: int = 2000,
    mesh=None,
    chunk_size: Optional[int] = None,
    algorithm: str = "adalead",
    algorithm_kwargs: Optional[dict] = None,
    model: str = "nam",
    surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
    checkpoint_dir: Optional[str] = None,
    cell_mode: str = "auto",
    device=None,
) -> pd.DataFrame:
    """Robustness sweep over any family of device-fitness landscapes.

    All `landscapes` must share one `device_fitness()` function (e.g.
    several RNABinding problems, or several AdditiveAAVPackaging
    phenotypes) and live on `device` (default "cuda").  Returns the summary
    frame of `run_robustness_sweep`, one row per (landscape, start, signal
    strength, seed) cell, in that order.

    `model` is "nam" (sweeps `signal_strengths`), "perfect", or
    "surrogate": a net trained in the run every round per cell
    (`runtime.surrogate.SurrogateSpec`, default the paper's CNN); then
    `signal_strengths` is ignored and should be `[1.0]`.  `cell_mode`
    "vmap" runs each chunk's cells in lockstep, "map" one by one (each a
    standalone run), "auto" picks "map" for a surrogate and "vmap"
    otherwise; a cell's result is the same in every mode.  `mesh`,
    `chunk_size` and `checkpoint_dir` are those of `sweep_adalead_nam`.

    `algorithm` selects the fused explorer ("adalead", "random", "ga",
    "cmaes", "bo", "gpr_bo", "cbas", "dbas", "dqn", "ppo", "dynappo" or
    "dynappo_mutative"; another name raises ValueError) and
    `algorithm_kwargs` its hyperparameters over the JAX sweep's defaults
    (`CELL_RUNNERS`).  "dynappo" and "dynappo_mutative" take no trained
    surrogate (ValueError, as in the JAX package).
    """
    cell_mode = _check_options(mesh, algorithm, model, surrogate_spec, cell_mode)
    if model == "surrogate":
        surrogate_spec = surrogate_spec or surrogate_lib.SurrogateSpec()
    device = resolve_device(device)
    alpha: Alphabet = as_alphabet(alphabet)
    fns_params = [land.device_fitness() for land in landscapes]
    fitness_fn = fns_params[0][0]
    if any(fn is not fitness_fn for fn, _ in fns_params):
        raise ValueError("all landscapes must share one device fitness fn")
    for land in landscapes:
        if getattr(land, "device", device) != device:
            raise ValueError(f"landscape {land.name} lives on {land.device}, the sweep on {device}")
    land_params = [p for _, p in fns_params]

    cells = [
        (li, st, ss, sd)
        for li in range(len(landscapes))
        for st in starts
        for ss in signal_strengths
        for sd in seeds
    ]
    land_idx = np.array([c[0] for c in cells], np.int64)
    start_tokens = alpha.encode([c[1] for c in cells]).astype(np.int64)
    ss_arr = np.array([c[2] for c in cells], np.float32)
    seed_arr = np.array([c[3] for c in cells], np.int64)
    cfg = AdaleadConfig(
        rounds=rounds,
        sequences_batch_size=sequences_batch_size,
        model_queries_per_batch=model_queries_per_batch,
        alphabet_size=len(alpha),
        perfect_model=(model == "perfect"),
        surrogate=surrogate_spec if model == "surrogate" else None,
    )

    def run_chunk(idx):
        chunk_land = land_idx[idx]

        def cell_params(pos):
            lands = chunk_land[pos]
            groups = [
                (li, torch.as_tensor(np.flatnonzero(lands == li), device=device))
                for li in dict.fromkeys(lands.tolist())
            ]
            return fitness_fn, land_params, groups

        return _run_chunk(
            _grouped_fitness, cell_params, start_tokens[idx], ss_arr[idx], seed_arr[idx], cfg,
            device, cell_mode, cell_runner,
        )

    cell_runner = _cell_runner(algorithm, algorithm_kwargs)
    result = _run_in_chunks(
        len(cells), chunk_size, checkpoint_dir,
        lambda cs: _landscape_sweep_signature(
            algorithm, algorithm_kwargs, model, surrogate_spec, cfg, cs, landscapes, fitness_fn,
            land_idx, start_tokens, ss_arr, seed_arr, device,
        ),
        run_chunk, mesh,
    )
    return _summary_df(result, [(landscapes[li].name, st, ss, sd) for li, st, ss, sd in cells])


class SweepCell(NamedTuple):
    """One sweep cell: landscape name, start, signal strength, seed."""

    landscape: str
    start: str
    signal_strength: float
    seed: int


def run_robustness_sweep(
    landscape_names: Sequence[str],
    starts: Sequence[str],
    signal_strengths: Sequence[float] = (0.0, 0.5, 0.75, 0.9, 1.0),
    seeds: Sequence[int] = (0,),
    rounds: int = 10,
    sequences_batch_size: int = 100,
    model_queries_per_batch: int = 2000,
    mesh=None,
    alphabet="TGCA",
    chunk_size: Optional[int] = None,
    algorithm: str = "adalead",
    algorithm_kwargs: Optional[dict] = None,
    model: str = "nam",
    surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
    checkpoint_dir: Optional[str] = None,
    cell_mode: str = "auto",
    device=None,
) -> pd.DataFrame:
    """Robustness evaluator over TF-binding landscapes as one sweep.

    The device analog of reference evaluate.robustness (evaluate.py:8-37)
    crossed with the landscape/start grid of the paper's cloud runner.
    Returns a summary DataFrame with one row per cell (max/start fitness,
    costs), in the JAX package's columns and cell order (landscape, then
    start, signal strength, seed).

    `model` is "nam" (sweeps `signal_strengths`), "perfect" or "surrogate"
    (`surrogate_spec`, default the paper's CNN).  `cell_mode` "vmap" runs
    each chunk in lockstep, "map" runs its cells one by one, "auto" picks
    "map" for a surrogate and "vmap" otherwise; scores are identical.  A
    surrogate or "map" sweep goes through `run_landscape_robustness_sweep`;
    the others gather from the stacked score tables.  `mesh`,
    `chunk_size`, `device` and `checkpoint_dir` are those of
    `sweep_adalead_nam`.
    `algorithm` and `algorithm_kwargs` are those of
    `run_landscape_robustness_sweep`, through which every algorithm but
    Adalead with its defaults runs.
    """
    cell_mode = _check_options(mesh, algorithm, model, surrogate_spec, cell_mode)
    device = resolve_device(device)
    if model == "surrogate" or cell_mode == "map" or algorithm != "adalead" or algorithm_kwargs:
        landscapes = []
        for name in landscape_names:
            land = tf_binding.TFBinding(name=name, device=device)
            land.name = name  # summary rows name the problem, not the family
            landscapes.append(land)
        return run_landscape_robustness_sweep(
            landscapes, alphabet, starts=starts, signal_strengths=list(signal_strengths),
            seeds=list(seeds), rounds=rounds, sequences_batch_size=sequences_batch_size,
            model_queries_per_batch=model_queries_per_batch, mesh=mesh, chunk_size=chunk_size,
            algorithm=algorithm, algorithm_kwargs=algorithm_kwargs, model=model,
            surrogate_spec=surrogate_spec, checkpoint_dir=checkpoint_dir, cell_mode=cell_mode,
            device=device,
        )
    alpha: Alphabet = as_alphabet(alphabet)
    names, tables = tf_binding._device_tables(device)
    name_to_idx = {n: i for i, n in enumerate(names)}

    cells: List[SweepCell] = [
        SweepCell(ln, st, ss, sd)
        for ln in landscape_names
        for st in starts
        for ss in signal_strengths
        for sd in seeds
    ]
    table_idx = np.array([name_to_idx[c.landscape] for c in cells], np.int64)
    start_tokens = alpha.encode([c.start for c in cells])
    ss_arr = np.array([c.signal_strength for c in cells], np.float32)
    seed_arr = np.array([c.seed for c in cells], np.int64)

    cfg = AdaleadConfig(
        rounds=rounds,
        sequences_batch_size=sequences_batch_size,
        model_queries_per_batch=model_queries_per_batch,
        alphabet_size=len(alpha),
        perfect_model=(model == "perfect"),
    )
    result = sweep_adalead_nam(
        tables, table_idx, start_tokens, ss_arr, seed_arr, cfg, mesh, chunk_size,
        device=device, checkpoint_dir=checkpoint_dir,
    )
    return _summary_df(result, cells)


def run_efficiency_sweep(
    landscape_names: Sequence[str],
    starts: Sequence[str],
    budgets: Sequence[Tuple[int, int]] = (
        (100, 500),
        (100, 5000),
        (1000, 5000),
        (1000, 10000),
    ),
    signal_strength: float = 0.9,
    seeds: Sequence[int] = (0,),
    rounds: int = 10,
    mesh=None,
    chunk_size: Optional[int] = None,
    algorithm: str = "adalead",
    algorithm_kwargs: Optional[dict] = None,
    model: str = "nam",
    surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
    device=None,
) -> pd.DataFrame:
    """Efficiency evaluator as sweeps (reference evaluate.py:40-74).

    Each (sequences_batch_size, model_queries_per_batch) pair sweeps its
    landscape x start x seed grid; the options are `run_robustness_sweep`'s.
    """
    frames = []
    for sequences_batch_size, model_queries_per_batch in budgets:
        df = run_robustness_sweep(
            landscape_names=landscape_names,
            starts=starts,
            signal_strengths=[signal_strength],
            seeds=seeds,
            rounds=rounds,
            sequences_batch_size=sequences_batch_size,
            model_queries_per_batch=model_queries_per_batch,
            mesh=mesh,
            chunk_size=chunk_size,
            algorithm=algorithm,
            algorithm_kwargs=algorithm_kwargs,
            model=model,
            surrogate_spec=surrogate_spec,
            device=device,
        )
        df["sequences_batch_size"] = sequences_batch_size
        df["model_queries_per_batch"] = model_queries_per_batch
        frames.append(df)
    return pd.concat(frames, ignore_index=True)


def run_adaptivity_sweep(
    landscape_names: Sequence[str],
    starts: Sequence[str],
    num_rounds: Sequence[int] = (1, 10, 100),
    total_ground_truth_measurements: int = 1000,
    total_model_queries: int = 10000,
    signal_strength: float = 0.9,
    seeds: Sequence[int] = (0,),
    mesh=None,
    chunk_size: Optional[int] = None,
    algorithm: str = "adalead",
    algorithm_kwargs: Optional[dict] = None,
    model: str = "nam",
    surrogate_spec: Optional[surrogate_lib.SurrogateSpec] = None,
    device=None,
) -> pd.DataFrame:
    """Adaptivity evaluator as sweeps (reference evaluate.py:77-112).

    A fixed total budget is split across 1/10/100 rounds; each split sweeps
    its grid; the options are `run_robustness_sweep`'s.
    """
    frames = []
    for rounds in num_rounds:
        df = run_robustness_sweep(
            landscape_names=landscape_names,
            starts=starts,
            signal_strengths=[signal_strength],
            seeds=seeds,
            rounds=rounds,
            sequences_batch_size=int(total_ground_truth_measurements / rounds),
            model_queries_per_batch=int(total_model_queries / rounds),
            mesh=mesh,
            chunk_size=chunk_size,
            algorithm=algorithm,
            algorithm_kwargs=algorithm_kwargs,
            model=model,
            surrogate_spec=surrogate_spec,
            device=device,
        )
        df["rounds"] = rounds
        frames.append(df)
    return pd.concat(frames, ignore_index=True)

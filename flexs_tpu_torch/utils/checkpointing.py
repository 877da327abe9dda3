"""Checkpoint and resume for long runs (a subsystem the reference lacks).

The reference's only recovery mechanism is its per-round log rewrite: the
measured-sequence CSV is a checkpoint of the data, but model weights,
optimizer state, RL agents and explorer state are lost in a crash.  This
module keeps both halves, as the JAX package's module does:

  * `save_run` / `load_run`: the measured DataFrame and metadata in the
    one-JSON-line + CSV log format (reference explorer.py:100-107), the
    same bytes as the JAX package writes, so a log written by either
    package loads in the other and a resumed run continues the same file;
  * `save_state` / `load_state`: a nested tree of tensors, numpy arrays,
    scalars and `torch.Generator`s, with `torch.save` and a weights-only
    `torch.load`.

`resume_explorer` restores the data half for any Explorer subclass and
retrains the surrogate from the logged history; explorer-internal state
restarts fresh (see its docstring), so snapshot that with
`save_state`/`load_state` where a bitwise resume matters.
"""
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import pandas as pd
import torch


def save_run(path: str, sequences_data: pd.DataFrame, metadata: Dict) -> None:
    """Write metadata + measured data in the standard log format.

    Atomic (tmp + rename): a crash mid-write must not destroy the
    previous complete log, the only recovery record.
    """
    dir_path, _ = os.path.split(path)
    if dir_path:
        os.makedirs(dir_path, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(metadata, f)
        f.write("\n")
        sequences_data.to_csv(f, index=False)
    os.replace(tmp, path)


def load_run(path: str) -> Tuple[pd.DataFrame, Dict]:
    """Read a run log back into (sequences_data, metadata)."""
    with open(path) as f:
        metadata = json.loads(f.readline())
        sequences_data = pd.read_csv(f)
    return sequences_data, metadata


# Tags of the leaves a weights-only load cannot rebuild by itself.
_NDARRAY, _NPSCALAR, _GENERATOR, _NAMEDTUPLE = (
    "__ndarray__", "__numpy_scalar__", "__generator__", "__namedtuple__"
)


def _encode(node):
    """`node` as tensors, Python scalars and containers of them."""
    if isinstance(node, torch.Generator):
        return {_GENERATOR: node.get_state(), "device": str(node.device)}
    if isinstance(node, np.ndarray):
        return {_NDARRAY: torch.from_numpy(np.array(node))}
    if isinstance(node, np.generic):
        return {_NPSCALAR: torch.from_numpy(np.array(node))}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {_NAMEDTUPLE: list(node._fields), "values": [_encode(x) for x in node]}
    if isinstance(node, (tuple, list)):
        return type(node)(_encode(x) for x in node)
    if isinstance(node, dict):
        return {k: _encode(v) for k, v in node.items()}
    return node


def _decode(node, template=None):
    """Undo `_encode`; tensors and generators go to `template`'s devices (else the CPU).

    A generator without a template is rebuilt on the device it was saved
    from: its state is meaningful only to that device type.
    """
    if isinstance(node, dict) and _GENERATOR in node:
        device = template.device if isinstance(template, torch.Generator) else node["device"]
        gen = torch.Generator(device=device)
        gen.set_state(node[_GENERATOR])
        return gen
    if isinstance(node, dict) and _NDARRAY in node:
        return node[_NDARRAY].numpy()
    if isinstance(node, dict) and _NPSCALAR in node:
        return node[_NPSCALAR].numpy()[()]
    if isinstance(node, dict) and _NAMEDTUPLE in node:
        subs = template if template is not None else [None] * len(node["values"])
        values = [_decode(v, t) for v, t in zip(node["values"], subs)]
        if template is not None:
            return type(template)(*values)
        return dict(zip(node[_NAMEDTUPLE], values))
    if isinstance(node, (tuple, list)):
        subs = template if template is not None else [None] * len(node)
        return type(node)(_decode(v, t) for v, t in zip(node, subs))
    if isinstance(node, dict):
        return {k: _decode(v, None if template is None else template[k]) for k, v in node.items()}
    if isinstance(node, torch.Tensor) and isinstance(template, torch.Tensor):
        return node.to(template.device)
    return node


def save_state(path: str, state) -> None:
    """Checkpoint a tree of tensors, arrays, scalars and generators to the file `path`.

    Containers are dicts, lists, tuples and NamedTuples.  Atomic (tmp +
    rename), as `save_run` is.
    """
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_encode(state), tmp)
    os.replace(tmp, path)


def load_state(path: str, template=None):
    """Restore a `save_state` checkpoint (weights only: nothing is unpickled).

    Tensors load on the CPU, or on the device of the matching tensor of
    `template` (a tree of the saved structure), which also gives
    NamedTuples their type (without it they come back as dicts).
    """
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return _decode(state, template)


def resume_explorer(
    explorer,
    landscape,
    log_file: str,
    verbose: bool = True,
) -> Tuple[pd.DataFrame, Dict]:
    """Run `explorer`, resuming from `log_file` if it exists.

    Completed rounds are replayed from the log (no oracle cost); the
    remaining rounds execute normally and keep appending to the same file.

    What is restored: the measured DataFrame, both cost counters, and the
    surrogate (retrained once on the full history; cumulative-training
    models like the NAM cache restore exactly).  What is not restored:
    explorer-internal state (RL policies, VAE snapshots, CMA-ES
    covariances); those restart fresh, so a resumed RL/generative run is
    distributionally, not bitwise, equivalent to an uninterrupted one.
    Callers that need exact internal state can snapshot it with
    `save_state`/`load_state` alongside the log.
    """
    if not os.path.exists(log_file):
        dir_path, _ = os.path.split(log_file)
        if dir_path:
            # Explorer.__init__ only makedirs for a constructor-passed
            # log_file; setting the attribute directly would crash _log.
            os.makedirs(dir_path, exist_ok=True)
        explorer.log_file = log_file
        return explorer.run(landscape, verbose=verbose)

    sequences_data, metadata = load_run(log_file)
    # Refuse to stitch two different experiments into one file.  `rounds`
    # is deliberately not checked: resuming with a higher target extends
    # a finished or interrupted run, a supported pattern.
    expect = {
        "exp_name": explorer.name,
        "model_name": explorer.model.name,
        "landscape_name": landscape.name,
        "sequences_batch_size": explorer.sequences_batch_size,
        "model_queries_per_batch": explorer.model_queries_per_batch,
    }
    bad = {
        k: (metadata.get(k), v)
        for k, v in expect.items()
        if metadata.get(k) != v
    }
    if bad:
        raise ValueError(
            f"{log_file} holds a DIFFERENT experiment; mismatched "
            f"(logged, expected) fields: {bad}"
        )
    done_rounds = int(sequences_data["round"].max())
    if done_rounds >= explorer.rounds:
        return sequences_data, metadata

    # Rebuild internal state: cost counters and the measured set.  (The
    # round loop below trains the model on the full history first thing,
    # exactly like Explorer.run.)
    landscape.add_cost(len(sequences_data))
    explorer.model.cost = int(sequences_data["model_cost"].iloc[-1])

    for r in range(done_rounds + 1, explorer.rounds + 1):
        round_start = time.time()
        explorer.model.train(
            sequences_data["sequence"].to_numpy(),
            sequences_data["true_score"].to_numpy(),
        )
        seqs, preds = explorer.propose_sequences(sequences_data)
        true_score = landscape.get_fitness(seqs)
        sequences_data = pd.concat(
            [
                sequences_data,
                pd.DataFrame(
                    {
                        "sequence": np.asarray(seqs),
                        "model_score": np.asarray(preds, dtype=np.float64),
                        "true_score": np.asarray(true_score, dtype=np.float64),
                        "round": r,
                        "model_cost": explorer.model.cost,
                        "measurement_cost": len(sequences_data) + len(seqs),
                    }
                ),
            ],
            ignore_index=True,
        )
        save_run(log_file, sequences_data, metadata)
        if verbose:
            print(
                f"round: {r}, top: {sequences_data['true_score'].max()}, "
                f"time: {time.time() - round_start:02f}s (resumed)"
            )
    return sequences_data, metadata

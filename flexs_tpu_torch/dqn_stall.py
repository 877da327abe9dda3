"""Where the fused DQN walk stalls: fresh Q networks, one replayed walk, and a seed grid.

    python -m flexs_tpu_torch.dqn_stall [--cpu]

The fused DQN runner moves by the reference's rule: an epsilon-greedy
move among the actions whose masked Q value is nonzero, a uniform move
only when all are zero.  A ReLU head can leave a walk a closed set of
states whose few nonzero moves lead back into it; no novel transition
then enters the replay ring, no training burst runs, and the walk stays.
This measures, on the card unless `--cpu`:

  1. the nonzero masked moves at TF-Bind's `STARTS[0]` of a fresh
     `QNetwork(8, 4, g)` for seeds 0..199, with `g` a generator on the
     run's device (as a sweep cell's, `parallel/sweep.py`) and on the CPU;
  2. seed 0's fused run on `SIX6_REF_R1` (NAM 0.9, 1 round), each step's
     choice replayed on the CPU through the same `_DQNRun.choose`, from
     the card's weights at that step and the card's draws (taken again
     from a copy of the cell's generator): the first step at which the
     two choices part, if any;
  3. the run's seed grid (`SIX6_REF_R1` x `STARTS[:1]` x NAM 0.9 x seeds
     0..31, 2 rounds x 100 x 2000): a walk stalls when its landscape cost
     is under 300.

Each part prints one JSON line with the card's name and power limit.
The sizes are keywords of `main`.  `patched` is the one way the package
and `chip_smoke.py` swap a `_DQNRun` method for a run.
"""
import argparse
import contextlib
import copy
import json
import sys
import types

import torch

from flexs_tpu_torch.bench import card_string
from flexs_tpu_torch.device import resolve_device

STALL_COST = 300  # landscape queries under which a walk counts as stalled
RUN = dict(sequences_batch_size=100, model_queries_per_batch=2000)
L, A = 8, 4


def _start_tokens():
    from flexs_tpu_torch.alphabet import as_alphabet
    from flexs_tpu_torch.landscapes import tf_binding

    return torch.as_tensor(as_alphabet("TGCA").encode_one(tf_binding.STARTS[0]))


def nonzero_moves(net, tokens) -> int:
    """Nonzero masked moves Q(s, a) * (1 - s) of `net` at the state `tokens` int[L]."""
    from flexs_tpu_torch.baselines.models.torch_model import one_hot

    dev = net.Dense_0.weight.device
    state = one_hot(tokens.to(dev)[None], A).reshape(1, L * A)
    with torch.no_grad():
        moves = net.all_actions(state) * (1 - state)
    return int((moves != 0).sum())


def init_moves(seeds, device) -> dict:
    """Nonzero moves at STARTS[0] of fresh Q nets on a generator of `device`, per seed."""
    from flexs_tpu_torch.baselines.explorers.dqn import QNetwork

    start = _start_tokens()
    counts = [nonzero_moves(QNetwork(L, A, torch.Generator(device).manual_seed(s)), start)
              for s in seeds]
    n = len(counts)
    return {"device": str(device), "seeds": n, "seed0": counts[0],
            "share_none": sum(c == 0 for c in counts) / n,
            "share_at_most_2": sum(c <= 2 for c in counts) / n,
            "mean": sum(counts) / n, "counts": counts}


def _cpu_choice(rec, cfg):
    """`_DQNRun.choose` on the CPU for one recorded step: the card's net, state and draws."""
    from flexs_tpu_torch.runtime.dqn_runner import _DQNRun

    run = types.SimpleNamespace(cfg=cfg, C=1, dim=L * A, steps=rec["steps"],
                                walk=rec["walk"][None], nets=[rec["net"]])
    run.all_action_q = lambda states: _DQNRun.all_action_q(run, states)
    # No generator is passed, so choose draws nothing and reads these buffers.
    run.draw_buffers = lambda gens, shape, *dtypes: (
        [rec["u"], rec["uni"]] if len(shape) == 1 else [rec["expo"][None]])
    flat, _ = _DQNRun.choose(run, [])
    return int(flat[0])


@contextlib.contextmanager
def patched(name: str, wrap):
    """`_DQNRun.<name>` replaced by `wrap(original)` inside the block."""
    from flexs_tpu_torch.runtime import dqn_runner

    original = getattr(dqn_runner._DQNRun, name)
    setattr(dqn_runner._DQNRun, name, wrap(original))
    try:
        yield
    finally:
        setattr(dqn_runner._DQNRun, name, original)


@contextlib.contextmanager
def captured_choices():
    """Every fused DQN step's choice inside the block, with what the CPU needs to replay it.

    Yields a list that gets, for the first cell of each step, the walk, the
    step count, a CPU copy of the Q network, the nonzero masked moves, the
    choice, and `choose`'s draws, taken again from a copy of the cell's
    generator in `choose`'s order and shapes.
    """
    from flexs_tpu_torch.baselines.models.torch_model import one_hot

    steps = []

    def wrap(choose):
        def recording(self, gens):
            rec = None
            if gens:
                _, g = gens[0]
                copy_g = torch.Generator(self.dev)
                copy_g.set_state(g.get_state())
                u = torch.empty(1, device=self.dev).uniform_(0, 1, generator=copy_g)
                expo = torch.empty(self.dim, device=self.dev).exponential_(
                    1.0, generator=copy_g)
                uni = torch.empty(1, dtype=torch.long, device=self.dev).random_(
                    0, self.dim, generator=copy_g)
                state = one_hot(self.walk, A).reshape(1, self.dim)
                rec = dict(walk=self.walk[0].cpu(), steps=self.steps, u=u.cpu(),
                           expo=expo.cpu(), uni=uni.cpu(),
                           net=copy.deepcopy(self.nets[0]).cpu(),
                           nonzero=int((self.all_action_q(state) * (1 - state) != 0).sum()))
            flat, value = choose(self, gens)
            if rec is not None:
                rec["flat"] = int(flat[0])
                steps.append(rec)
            return flat, value
        return recording

    with patched("choose", wrap):
        yield steps


def replay(seed: int = 0, device=None, **run) -> dict:
    """Seed `seed`'s fused DQN run (1 round) on `device`, each choice replayed on the CPU."""
    import flexs_tpu_torch as flexs
    from flexs_tpu_torch.landscapes import tf_binding

    device = resolve_device(device)
    land = flexs.landscapes.TFBinding(name="SIX6_REF_R1", device=device)
    runner = flexs.runtime.DeviceDQNNAM(
        land, "TGCA", rounds=1, starting_sequence=tf_binding.STARTS[0],
        signal_strength=0.9, seed=seed, device=device, **{**RUN, **run})
    with captured_choices() as steps:
        df, _ = runner.run(verbose=False)
    first_part = None
    for i, rec in enumerate(steps):
        cpu = _cpu_choice(rec, runner.cfg)
        if cpu != rec["flat"]:
            first_part = {"step": i, "device_choice": rec["flat"], "cpu_choice": cpu}
            break
    flats = [rec["flat"] for rec in steps]
    return {"seed": seed, "rounds": 1, "steps_compared": len(steps),
            "first_part": first_part, "landscape_cost": int(land.cost),
            "max_true_score": float(df["true_score"].max()),
            "nonzero_moves_first_40": [rec["nonzero"] for rec in steps[:40]],
            "choices_first_40": flats[:40], "distinct_choices": len(set(flats))}


def stalls(seeds, rounds: int = 2, device=None, **run) -> dict:
    """The DQN sweep over SIX6_REF_R1 x STARTS[:1] x NAM 0.9 x `seeds`; the stalled walks."""
    from flexs_tpu_torch.landscapes import tf_binding
    from flexs_tpu_torch.parallel import run_robustness_sweep

    run = {**RUN, **run}
    df = run_robustness_sweep(
        ["SIX6_REF_R1"], tf_binding.STARTS[:1], signal_strengths=[0.9], seeds=list(seeds),
        rounds=rounds, algorithm="dqn", device=resolve_device(device), **run)
    stalled = df[df["landscape_cost"] < STALL_COST]
    return {"cells": len(df), "rounds": rounds, "mean_max_fitness": float(df["max_fitness"].mean()),
            "stalled": len(stalled), "stalled_seeds": stalled["seed"].tolist(),
            "stalled_landscape_costs": stalled["landscape_cost"].tolist(),
            "landscape_costs": df["landscape_cost"].tolist()}


def main(argv=None, device=None, init_seeds: int = 200, grid_seeds: int = 32,
         grid_rounds: int = 2, run=None) -> int:
    """The three parts; the sizes and `run` (batch and budget keywords) for tests."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else device)
    card = card_string(device)
    run = run or {}
    seeds = range(init_seeds)
    inits = {"on_device": init_moves(seeds, device)}
    if device.type != "cpu":
        inits["on_cpu"] = init_moves(seeds, "cpu")
    print(json.dumps({"part": "init", **inits, "card": card}), flush=True)
    print(json.dumps({"part": "replay", **replay(0, device, **run), "card": card}), flush=True)
    print(json.dumps({"part": "grid", **stalls(range(grid_seeds), grid_rounds, device, **run),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

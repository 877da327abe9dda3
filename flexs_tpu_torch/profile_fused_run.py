"""Profile the fused single run's floor, by suspect.

    python -m flexs_tpu_torch.profile_fused_run [--trace DIR] [--cpu]

Counterpart of scripts/profile_fused_run.py, with its flag and lines.  The
JAX run is one device program; the port's rounds and generation loops
run on the host, so its floor is host dispatch and the host syncs of
`CellRun.fetch`, the cache-distance work that grows with capacity, or
something else.  The suspects, separated:

  * the control, the counterpart of the script's bare `while_loop`: a host
    loop of n iterations of one small op on a carried device scalar, timed
    with one synchronize at the end and with a host sync every iteration
    (what `CellRun.fetch` costs a step);
  * wall against the model-query budget at 10 rounds, B = 100 (the cost of
    a scoring iteration);
  * wall against rounds at budget 2000 (capacity grows with rounds).

Each reading is the script's `bench`: one warm-up run, then the mean of
`reps` runs, ended by a synchronize.  The run is `run_adalead_nam` on
TF-Bind `SIX6_REF_R1` from its first start, NAM 0.9, seed 0 (a fresh
generator each run, so every run is the same).  Each row also gives one
run's host syncs and per-cell draw calls (`jit_runner.run_counts`, as
`profile_main_path` reads them), and its device ops: the ATen ops, views
apart, that touch a tensor on the run's device (`DeviceOps`, counted in
that one untimed run), and so the ops between two host syncs.  `--trace DIR` writes one full run's
Chrome trace through `utils.profiling.trace`.  Every reading is also a
JSON line with the card's name and power limit.  `--cpu` runs on the CPU;
otherwise it needs a card.
"""
import argparse
import json
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from flexs_tpu_torch.bench import card_string
from flexs_tpu_torch.device import resolve_device

LOOP_NS = (200, 2000, 20000)
BUDGETS = (500, 1000, 2000, 4000)
ROUNDS = (1, 2, 5, 10)
REPS = 10
BATCH = 100
BUDGET_ROUNDS = 10  # the budget readings' rounds
ROUNDS_BUDGET = 2000  # the rounds readings' budget


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(fn, device, reps: int = REPS) -> float:
    """Seconds a call of `fn`: one warm-up call, then the mean of `reps`, ended by a sync."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps


def host_loop(n: int, device, sync_each: bool):
    """n iterations of one op on a carried device scalar; a host sync each if `sync_each`."""
    x = torch.ones((), device=device)
    for _ in range(n):
        x = x * 1.000001
        if sync_each:
            x.tolist()  # CellRun.fetch's sync
    return x


class FusedRun:
    """`run_adalead_nam` on SIX6_REF_R1 from STARTS[0], NAM 0.9, seed 0, on `device`."""

    def __init__(self, device):
        from flexs_tpu_torch.alphabet import as_alphabet
        from flexs_tpu_torch.landscapes import tf_binding

        problem = tf_binding.registry()["SIX6_REF_R1"]
        landscape = tf_binding.TFBinding(**problem["params"], device=device)
        self.device = device
        self.fitness_fn, self.fitness_params = landscape.device_fitness()
        self.start = torch.as_tensor(as_alphabet("TGCA").encode_one(problem["starts"][0]),
                                     device=device)

    def __call__(self, cfg):
        from flexs_tpu_torch.runtime.jit_runner import run_adalead_nam

        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        return run_adalead_nam(self.fitness_fn, self.fitness_params, self.start, cfg, 0.9, gen)


def config(rounds: int, budget: int, batch: int = BATCH):
    from flexs_tpu_torch.runtime.jit_runner import AdaleadConfig

    return AdaleadConfig(rounds=rounds, sequences_batch_size=batch,
                         model_queries_per_batch=budget, alphabet_size=4)


class DeviceOps(TorchDispatchMode):
    """Counts the ATen ops dispatched inside it that touch a tensor on `device`, views apart."""

    def __init__(self, device):
        super().__init__()
        self.device_type = device.type
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and any(
                isinstance(t, torch.Tensor) and t.device.type == self.device_type
                for t in tree_flatten((args, kwargs, out))[0]):
            self.n += 1
        return out


def counted(run, cfg, device) -> dict:
    """One run's host syncs, per-cell draw calls and device ops (not timed)."""
    from flexs_tpu_torch.runtime import jit_runner

    jit_runner.reset_run_counts()
    with DeviceOps(device) as ops:
        run(cfg)
    syncs = jit_runner.run_counts["syncs"]
    return {"host_syncs": syncs, "draw_calls": jit_runner.run_counts["draw_calls"],
            "device_ops": ops.n, "device_ops_per_sync": ops.n / max(syncs, 1)}


def main(argv=None, device=None, loop_ns=LOOP_NS, budgets=BUDGETS, rounds=ROUNDS,
         reps: int = REPS, batch: int = BATCH, budget_rounds: int = BUDGET_ROUNDS,
         rounds_budget: int = ROUNDS_BUDGET) -> int:
    """The profile; the sizes are keywords for tests and the smoke run."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--trace", default=None)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)

    from flexs_tpu_torch.ops import cuda_duplex

    device = resolve_device("cpu" if args.cpu else device)
    card = card_string(device)
    cuda_duplex.reset_launch_counts()

    def emit(reading: dict) -> None:
        print(json.dumps({**reading, "duplex_launches": sum(cuda_duplex.launch_counts().values()),
                          "card": card}), flush=True)

    print("backend:", device, card, flush=True)

    # Control: the host loop's floor, without and with a sync per iteration.
    for n in loop_ns:
        for sync_each, label in ((False, "one sync"), (True, "a sync each")):
            t = bench(lambda: host_loop(n, device, sync_each), device, reps)
            print(f"host loop x{n}, {label}: {t * 1e3:8.2f} ms ({t / n * 1e6:.1f} us/iter)",
                  flush=True)
            emit({"reading": "host_loop", "n": n, "sync_each": sync_each, "wall_s": t,
                  "us_per_iter": t / n * 1e6})

    run = FusedRun(device)
    print(f"\nwall vs budget (rounds={budget_rounds}, B={batch}):", flush=True)
    for budget in budgets:
        cfg = config(budget_rounds, budget, batch)
        counts = counted(run, cfg, device)
        t = bench(lambda: run(cfg), device, reps)
        iters = budget_rounds * budget // batch
        print(f"  budget {budget}: {t * 1e3:8.1f} ms (~{iters} scoring iters, "
              f"{t / iters * 1e6:.0f} us/iter; {counts['host_syncs']} host syncs, "
              f"{counts['draw_calls']} draw calls, {counts['device_ops']} device ops)", flush=True)
        emit({"reading": "budget", "rounds": budget_rounds, "budget": budget, "wall_s": t,
              "scoring_iters": iters, "us_per_iter": t / iters * 1e6, **counts})

    print(f"\nwall vs rounds (budget={rounds_budget}, B={batch}):", flush=True)
    for r in rounds:
        cfg = config(r, rounds_budget, batch)
        counts = counted(run, cfg, device)
        t = bench(lambda: run(cfg), device, reps)
        cap = 1 + r * (rounds_budget + 2 * batch) + 1
        print(f"  rounds {r}: {t * 1e3:8.1f} ms ({t / r * 1e3:.1f} ms/round; cache_cap {cap}; "
              f"{counts['host_syncs']} host syncs, {counts['draw_calls']} draw calls, "
              f"{counts['device_ops']} device ops)",
              flush=True)
        emit({"reading": "rounds", "rounds": r, "budget": rounds_budget, "wall_s": t,
              "ms_per_round": t / r * 1e3, "cache_cap": cap, **counts})

    if args.trace:
        from flexs_tpu_torch.utils import profiling

        cfg = config(budget_rounds, rounds_budget, batch)
        run(cfg)  # warm
        before = set(os.listdir(args.trace)) if os.path.isdir(args.trace) else set()
        with profiling.trace(args.trace):
            run(cfg)
            sync(device)
        files = sorted(set(os.listdir(args.trace)) - before)
        if not files:
            raise RuntimeError(f"no trace was written to {args.trace}")
        print("trace written to", args.trace, flush=True)
        emit({"reading": "trace", "dir": args.trace, "files": files})
    return 0


if __name__ == "__main__":
    sys.exit(main())

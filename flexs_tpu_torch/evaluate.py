"""Standardized evaluation sweeps for explorers.

Contract (reference flexs/evaluate.py):
  * `robustness` (:8-37): run the explorer with NoisyAbstractModels of signal
    strengths [0, 0.5, 0.75, 0.9, 1].
  * `efficiency` (:40-74): sweep (sequences_batch_size, model_queries_per_
    batch) budget pairs [(100, 500), (100, 5000), (1000, 5000),
    (1000, 10000)].
  * `adaptivity` (:77-112): fixed total budget split over 1/10/100 rounds.

These are the serial reference-shaped entry points; the engine that runs
a grid of cells in lockstep on one device is `flexs_tpu_torch.parallel.sweep`.
"""
from typing import Callable, List, Tuple

from flexs_tpu_torch.baselines.models import NoisyAbstractModel
from flexs_tpu_torch.explorer import Explorer
from flexs_tpu_torch.landscape import Landscape
from flexs_tpu_torch.model import Model


def robustness(
    landscape: Landscape,
    make_explorer: Callable[[Model, float], Explorer],
    signal_strengths: List[float] = [0, 0.5, 0.75, 0.9, 1],
    verbose: bool = True,
):
    """Evaluate explorer output as a function of surrogate noisiness.

    Runs the same explorer with `NoisyAbstractModel`s of different signal
    strengths, each on the landscape's device (the default device for a
    landscape that has none).
    """
    results = []
    for ss in signal_strengths:
        print(f"Evaluating for robustness with model accuracy; signal_strength: {ss}")

        model = NoisyAbstractModel(
            landscape, signal_strength=ss, device=getattr(landscape, "device", None)
        )
        explorer = make_explorer(model, ss)
        res = explorer.run(landscape, verbose=verbose)

        results.append((ss, res))

    return results


def efficiency(
    landscape: Landscape,
    make_explorer: Callable[[int, int], Explorer],
    budgets: List[Tuple[int, int]] = [
        (100, 500),
        (100, 5000),
        (1000, 5000),
        (1000, 10000),
    ],
):
    """Evaluate explorer output over ground-truth/model query budget pairs."""
    results = []
    for sequences_batch_size, model_queries_per_batch in budgets:
        print(
            f"Evaluating for sequences_batch_size: {sequences_batch_size}, "
            f"model_queries_per_batch: {model_queries_per_batch}"
        )
        explorer = make_explorer(sequences_batch_size, model_queries_per_batch)
        res = explorer.run(landscape)

        results.append(((sequences_batch_size, model_queries_per_batch), res))

    return results


def adaptivity(
    landscape: Landscape,
    make_explorer: Callable[[int, int, int], Explorer],
    num_rounds: List[int] = [1, 10, 100],
    total_ground_truth_measurements: int = 1000,
    total_model_queries: int = 10000,
):
    """For a fixed total budget, sweep the number of rounds it is split over."""
    results = []
    for rounds in num_rounds:
        print(f"Evaluating for num_rounds: {rounds}")
        explorer = make_explorer(
            rounds,
            int(total_ground_truth_measurements / rounds),
            int(total_model_queries / rounds),
        )
        res = explorer.run(landscape)

        results.append((rounds, res))

    return results

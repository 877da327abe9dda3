"""Faults planted under the timed path, each of which the comparison has to catch.

Each is a list of `(owner, attr, make)` swaps for `run.run_cell(faults=...)`:
  * `altered`: the oracle's answer altered where it is produced (its first
    row's score raised by 1% of the row's magnitude and 0.01);
  * `half_batch`: half of each oracle batch left out, the mean of the
    other half given in its place;
  * `unchanged`: a round returns the run's state as it was given it: the
    start proposed again, no query spent, nothing measured;
  * `far_dists`: the distance op returns each distance of 2 or more one
    too small, so that which rows are cached (distance 0) stays right and
    only NAM's model scores move.
A cell on one chip has no exchange between chips to leave out.
"""
import functools

import torch


def _oracle_swaps(family, make):
    return [(owner, attr, make) for owner, attr in family.ORACLE_TARGETS]


def altered(family, jit_runner):
    def make(fn):
        @functools.wraps(fn)
        def oracle(params, tokens):
            out = fn(params, tokens).clone()
            first = out[..., 0]
            out[..., 0] = first + 0.01 * (1 + first.abs())
            return out

        return oracle

    return _oracle_swaps(family, make)


def half_batch(family, jit_runner):
    def make(fn):
        @functools.wraps(fn)
        def oracle(params, tokens):
            out = fn(params, tokens).clone()
            half = out.shape[-1] // 2
            if half:
                out[..., half:] = out[..., :half].mean(dim=-1, keepdim=True)
            return out

        return oracle

    return _oracle_swaps(family, make)


def unchanged(family, jit_runner):
    def make(fn):
        @functools.wraps(fn)
        def round_(run):
            B = run.cfg.sequences_batch_size
            proposals = run.start[:, None].expand(run.C, B, run.L).clone()
            truth = run.start_truth[:, None].expand(run.C, B).clone()
            return (proposals, truth, truth.clone(), run.all_rows.clone(),
                    list(run.model_cost), list(run.landscape_cost))

        return round_

    return [(jit_runner._Run, "round", make)]


def far_dists(family, jit_runner):
    def make(fn):
        @functools.wraps(fn)
        def dists_to_cache(run, packed):
            out = fn(run, packed)
            return torch.where((out >= 2) & (out <= run.L), out - 1, out)

        return dists_to_cache

    return [(jit_runner.CellRun, "dists_to_cache", make)]


FAULTS = {"altered": altered, "half_batch": half_batch, "unchanged": unchanged,
          "far_dists": far_dists}


def swaps(name, family, jit_runner):
    return FAULTS[name](family, jit_runner)


"""The comparison that decides `correct`: the timed path's outputs against the plain reference.

For every cell of the run:
  * oracle_gap: the largest gap between a measured row's true_score (the
    start's too) and the reference's score of the same tokens, over the
    largest |reference score| of the run;
  * max_gap: the largest gap between the best true_score the program
    reported for a cell and the reference's best over the cell's rows, on
    the same scale;
  * violations: broken run invariants, counted: a round's model cost
    outside [budget, budget + B - 1] (Adalead spends its budget in passes
    of B rows); a NAM round's landscape cost not equal to 2 x the rows it
    inserted + the rows it measured, with inserted rows between the
    measured ones and the model cost; a row measured twice in a cell (the
    start counted); and, at signal strength 1, a measured row whose model
    score is not the reference's score (NAM then predicts the truth).

And over the window's sample of the distance op (`probes.DistSample`):
  * dist_errors: the distances `CellRun.dists_to_cache` returned that are
    not the plain Hamming distance of the unpacked rows
    (`reference/hamming.py`), masked rows past the cell's fill included.
    NAM's model score of a row depends on its distance to the nearest
    cached row at every signal strength but 0 and 1.  A window that
    sampled no call counts one error.
"""
import numpy as np

from benchmark.reference import hamming


def compare(cells, reference, config) -> dict:
    """{"oracle_gap", "max_gap", "violations", "rows"} over `cells` (settled `outcome.Cell`s)."""
    budget, batch = config["model_queries_per_batch"], config["sequences_batch_size"]
    nam = config["model"] == "nam"
    oracle_gap = max_gap = scale = 0.0
    violations = rows = 0
    for cell in cells:
        valid = cell.valid.astype(bool)
        measured = cell.tokens[valid]
        ref = reference.truth(cell.key, np.concatenate([cell.start[None], measured]))
        prog = np.concatenate([[cell.start_truth], cell.truth[valid].astype(np.float64)])
        rows += len(ref)
        scale = max(scale, float(np.abs(ref).max()))
        oracle_gap = max(oracle_gap, float(np.abs(prog - ref).max()))
        max_gap = max(max_gap, abs(cell.reported_max - float(ref.max())))

        prev_model, prev_land = 0, 1
        for r in range(len(cell.model_cost)):
            dm = int(cell.model_cost[r]) - prev_model
            dl = int(cell.landscape_cost[r]) - prev_land
            nv = int(valid[r].sum())
            prev_model, prev_land = int(cell.model_cost[r]), int(cell.landscape_cost[r])
            violations += not budget <= dm <= budget + batch - 1
            if nam:
                inserted, odd = divmod(dl - nv, 2)
                violations += bool(odd) or not nv <= inserted <= dm
            else:
                violations += dl != nv
        seen = {tuple(row) for row in np.concatenate([cell.start[None], measured]).tolist()}
        violations += len(ref) - len(seen)
        if nam and cell.signal_strength == 1.0:
            preds = cell.preds[valid].astype(np.float32)
            violations += int(np.sum(preds != ref[1:].astype(np.float32)))
    scale = scale or 1.0
    return {"oracle_gap": oracle_gap / scale, "max_gap": max_gap / scale,
            "violations": violations, "rows": rows}


def dist_errors(samples) -> dict:
    """{"dist_errors", "dist_sampled"}: wrong distances among the sampled ones, and how many."""
    wrong = total = 0
    for s in samples:
        ref = hamming.masked_distances(s["queries"], s["cache"], int(s["fill"]), s["bits"],
                                       s["per_word"], s["length"])
        wrong += int(np.sum(np.asarray(s["dists"], np.int64) != ref))
        total += ref.size
    return {"dist_errors": wrong if total else 1, "dist_sampled": total}

"""Aggregate per-family north-star runs into one artifact and table.

    python -m flexs_tpu_torch.aggregate_northstar northstar_*.log --out northstar.json

Counterpart of scripts/aggregate_northstar.py, with its flags and output.
`python -m flexs_tpu_torch.bench_northstar --families <f>` may run as one
process per family; each prints its family JSON line plus its own
single-family summary.  This keeps the LAST line per family (a rerun
supersedes an earlier one), recomputes the grid-wide summary, writes the
JSON artifact and prints the markdown table.  Each row keeps the `card`
of its line; the summary's `card` names the cards of all rows.  It reads
JSON lines only and runs nothing.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_families(logs) -> dict:
    """The last family line of each family in `logs`, in the order families first appear."""
    families = {}
    for log in logs:
        with open(log) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "family" in rec:  # summary lines have "metric" instead
                    families[rec["family"]] = rec
    return families


def family_baselines(path: str = os.path.join(REPO, "BASELINE_FAMILY_MEASURED.json")) -> dict:
    """seqs/s of each family whose reference run was measured, {} without the file."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {k: v["seqs_per_sec"] for k, v in json.load(f).items()}


def aggregate(rows, base_sps: float, fam_base: dict) -> dict:
    """The grid-wide summary of the family lines `rows`.

    Family-fair aggregate: the wall the reference would need for this exact
    grid, charging each family's sequences at its own measured reference
    rate (the generic Adalead rate where unmeasured).  The flat
    `vs_baseline` divides the grid's seqs/s by the Adalead rate.
    """
    total_seqs = sum(r["seqs"] for r in rows)
    total_wall = sum(r["wall_s"] for r in rows)
    ref_wall_fair = sum(r["seqs"] / fam_base.get(r["family"], base_sps) for r in rows)
    cards = sorted({r["card"] for r in rows if "card" in r})
    return {
        "metric": "northstar_all_explorers_all_landscapes",
        "families": len(rows),
        "total_cells": sum(r["cells"] for r in rows),
        "total_seqs": total_seqs,
        "total_wall_s": round(total_wall, 2),
        "seqs_per_sec": round(total_seqs / total_wall, 1),
        "reference_seqs_per_sec": base_sps,
        "vs_baseline": round(total_seqs / total_wall / base_sps, 2),
        "reference_wall_s_family_fair": round(ref_wall_fair, 1),
        "vs_baseline_family_fair": round(ref_wall_fair / total_wall, 1),
        "family_baselines_measured": sorted(fam_base),
        "card": "; ".join(cards) if cards else None,
    }


def print_table(rows, base_sps: float, fam_base: dict) -> None:
    """The markdown table; sets each row's `vs_family_baseline`."""
    print("| family | cells | wall (s) | seqs | seqs/s | vs ref Adalead"
          " (3,068/s) | vs ref same-family | mean max_fitness | min |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        fb = fam_base.get(r["family"])
        fair = f"**{r['seqs_per_sec'] / fb:.0f}x**" if fb else "—"
        r["vs_family_baseline"] = round(r["seqs_per_sec"] / fb, 1) if fb else None
        print(
            f"| {r['family']} | {r['cells']} | {r['wall_s']} | {r['seqs']:,}"
            f" | {r['seqs_per_sec']:,} | {r['seqs_per_sec'] / base_sps:.1f}x"
            f" | {fair}"
            f" | {r['mean_max_fitness']} | {r['min_max_fitness']} |"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logs", nargs="+", help="log file(s) of bench_northstar runs")
    ap.add_argument("--out", default=None, help="write the JSON artifact here")
    ap.add_argument(
        "--baseline", default=None,
        help="override BASELINE_MEASURED.json seqs_per_sec",
    )
    args = ap.parse_args(argv)

    base_sps = float(args.baseline) if args.baseline else None
    if base_sps is None:
        with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
            base_sps = json.load(f)["seqs_per_sec"]

    families = read_families(args.logs)
    if not families:
        raise SystemExit("no family lines found")
    rows = list(families.values())
    fam_base = family_baselines()
    summary = aggregate(rows, base_sps, fam_base)
    print_table(rows, base_sps, fam_base)
    print(json.dumps(summary))

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"families": rows, "summary": summary}, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

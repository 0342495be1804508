"""Spreads of repeated runs of one cell, the numbers its bounds are set
from.

    python3 -m h100_bench.spread SET1_DIR SET2_DIR [...]

Each directory holds one run's standard output per `*.json` file (the
result is its last line). Per metric and set: the median, the spread (the
distance between the first and third quartile over the median, as
`statistics.quantiles(values, n=4)` gives them), the spread with the run
farthest from the median left out, and the runs' `correct`. Then, over the
sets: the widest spread, five times it, and how far apart the sets'
medians lie.
"""

import json
import statistics
import sys
from pathlib import Path

from h100_bench.roofline import spread


def results(directory) -> list:
    out = []
    for path in sorted(Path(directory).glob("*.json")):
        lines = path.read_text().strip().splitlines()
        if lines:
            out.append(json.loads(lines[-1]))
    return out


def trimmed(values) -> float:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = values[:far] + values[far + 1:]
    return spread(rest) if len(rest) >= 2 else 0.0


def summary(sets) -> dict:
    metrics = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    out = {}
    for m in metrics:
        per = []
        for runs in sets:
            vals = [r["metrics"][m]["value"] for r in runs
                    if m in r["metrics"]]
            if len(vals) >= 2:
                per.append({"median": statistics.median(vals),
                            "spread": spread(vals),
                            "trimmed": trimmed(vals), "n": len(vals),
                            "values": vals})
        if not per:
            continue
        widest = max(p["spread"] for p in per)
        meds = [p["median"] for p in per]
        out[m] = {"sets": per, "widest": widest, "five_times": 5 * widest,
                  "medians_apart": (max(meds) - min(meds)) / min(meds)}
    out["correct"] = [[r["correct"] for r in runs] for runs in sets]
    return out


def main(argv=None) -> int:
    dirs = (argv if argv is not None else sys.argv[1:])
    print(json.dumps(summary([results(d) for d in dirs]), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... --kinds program fp8

For each seed, in one process: the cell's set-up as a run makes it (the
weights, the traffic, the warm-up; a training cell's first steps), one
finished unit (a predict cell's batch), then the compared numbers of each
kind (cell.py ``check``): "program" (the timed path, as a run compares
it), "fp8" (the control: the reference in fp8 in the program's place),
and the planted faults a cell knows ("half_batch" for training, "answer"
for predict). A step that leaves the state unchanged reads 1 on the
weights' change by that number's definition and is not run. One JSON line
a seed, then the largest program reading and the smallest of each other
kind, number by number. No measured window.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=["program", "fp8"])
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.bench import benchmark, resolve

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = resolve(benchmark(ROOT), a.workload)
    rows = []
    for seed in a.seeds:
        c = cell.driver.build(cell.cfg, cell.wl, seed, "cuda")
        c.setup()
        if not hasattr(c, "losses"):
            c.run_units(1)
        readings = c.check(a.kinds)
        diag = getattr(c, "diag", {})
        del c
        torch.cuda.empty_cache()
        rows.append(readings)
        print(json.dumps({"seed": seed, **readings, **({"diag": diag} if diag else {})}),
              flush=True)
    summary = {}
    for kind in a.kinds:
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
    print(json.dumps({"summary": summary, "seeds": a.seeds,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

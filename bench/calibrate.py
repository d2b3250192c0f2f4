#!/usr/bin/env python3
"""Readings for the limits of ``correct``: runs of one cell in one process
on consecutive seeds, each a short window, printing for every seed the
numbers compared (program against the plain reference) and, with
``--control``, the same numbers for the reference in the precision below
the configuration's put in the program's place:

    python3 bench/calibrate.py --workload <cell> --first <seed> --seeds 12 \\
        --seconds 5 [--control tf32 ...]

One JSON line a seed on standard output.  The benchmark's own runs never
run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", nargs="*", default=())
    args = ap.parse_args(argv)

    import torch

    from bench import harness
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    controls = tuple(args.control)
    for k in range(args.seeds):
        seed = args.first + k
        t0 = time.perf_counter()
        res, _ = harness.run_cell(
            bench, args.workload, seed, args.seconds, False,
            torch.device("cuda", 0), t0, controls=controls,
            log=lambda *a: print(*a, file=sys.stderr, flush=True))
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "check": {k: v["value"] for k, v in
                                    res["check"].items()},
                          "control": res.get("control", {}),
                          "rows": res.get("rows"),
                          "attempted": res["attempted"],
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``bench/cells/<cell>.json`` are set from;
the benchmark's own runs do not run this.

For each seed, all in one process, it runs the cell's timed path
without the window's length (the kind's ``readings``: one wave of a
``serve_waves`` mix).  It prints the numbers the check compares, of the
program against the float32 reference, and for the ``--control`` seeds
also the control's (the reference with every projection's inputs
rounded to float8 e4m3 for a bf16 configuration, read against the
float32 reference).

    python3 bench/limits.py --workload mixtral-eps1e-6.chat --seeds 1,2,3 \\
        --control 1,2,3 --out chiprun_out/limits.jsonl
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from bench.harness import runner, spec
    torch.set_num_threads(4)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = runner.build_context(args.workload, seed, 0.0, False, t)
        nums = spec.kind(ctx.mix["kind"]).readings(ctx,
                                                   seed in args.control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "seconds": time.perf_counter() - t, **nums})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del ctx
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads, warms up, measures for about ``--seconds``, checks the timed
path's output against the plain reference, and prints one JSON result
as the last line of standard output (``bench/README.md``).  It exits
non-zero with no result where no CUDA card is visible, where the cell
asks for more cards than there are, or where the program cannot be
imported (``src/`` missing beside ``bench/``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"

# every cache of the program and its libraries inside the checkout, at
# fixed paths, so that only the first run in a checkout builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
# one host thread: the engine is paced by the host, and idle worker
# threads only take cores from the one that launches the kernels
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        import repro_torch  # noqa: F401
        from bench.harness import runner
    except ImportError as e:
        print(f"cannot import the benchmark or the program: {e}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    try:
        runner.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), T0)
    except runner.NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    except runner.Forbidden as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())

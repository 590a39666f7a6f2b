"""Run one cell of BENCHMARK.json once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  Prints the result as the last line of
standard output (one JSON object) and each number compared with its
limit as the last lines of standard error.  Exits 2 without a result
when the cell's cards are not there, 3 when a forbidden package (JAX,
the JAX package) was loaded, 1 on any other error.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse   # noqa: E402
import json   # noqa: E402
import os   # noqa: E402
import sys   # noqa: E402
from pathlib import Path   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from portbench import harness
    try:
        out = harness.execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    except harness.NoDevice as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 2
    except harness.Leaked as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

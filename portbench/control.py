"""Run a cell's control: the plain reference at float32 in the program's
place, through the whole run and its check, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n>[,<n>...]
                                 [--seconds <s>]

Prints one JSON line per seed with its checks; every one should come
out not correct.  The control never touches the card; the benchmark's
own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.execute(args.workload, seed, args.seconds, False,
                              device="cpu", control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"],
                          "info": out["info"]["window"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

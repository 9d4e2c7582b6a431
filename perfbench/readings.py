"""Read the numbers that decide ``correct`` over many seeds in one process:
the program's (the lower readings of each limit) or the control's (the
reference in bfloat16 in the program's place: the upper readings).  The
benchmark's own runs never run this.

    python3 perfbench/readings.py --workload <cell> --program port|control \
        --seeds 1,2,3 --seconds 5 [--out chiprun_out/readings.jsonl]

Each run prints one JSON line: the seed, ``correct``, every check's number
and limit, and the run's end-to-end metrics.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", choices=("port", "control"), default="port")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    from perfbench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run(here, args.workload, seed, args.seconds,
                        bool(args.trace), program=args.program, t0=t0)
        line = json.dumps({"workload": args.workload,
                           "program": args.program, "seed": seed,
                           "correct": r["correct"], "checks": r["checks"],
                           "metrics": r["metrics"],
                           "device": r["device"],
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark of ``repro_torch`` on the machine it
starts on, and print its result as the last line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations, traffic mixes and metrics are the files named in
``BENCHMARK.json`` (see ``perfbench/harness.py``).  The kernels' build
cache stays where the program keeps it, ``build/repro_torch_kernels/`` in
the checkout; every other cache goes under ``build/perfbench-cache/`` in
the checkout, and temporary files under ``TMPDIR``.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench-cache"


def main() -> int:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    from perfbench import harness

    return harness.main(t0=T0)


if __name__ == "__main__":
    sys.exit(main())

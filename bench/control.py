"""The readings that a cell's correctness limit is set from.

    python bench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 30

For each seed, one run of the cell as the benchmark makes it (a fresh
engine, the same warm-up, loop and window, in this one process), then
the numbers of the window's sample against the float32 reference
(``check.numbers``): the program's readings. For the seeds of
``--control-seeds`` also the same numbers of the cell's control (its
check's ``control``: the reference computed in the next lower precision)
on the same sample, and the control's verdict under the cell's limits
(``control_correct``, which has to read false). One JSON line per seed.
The limit lies between the largest program reading over a dozen seeds
or more and the smallest control reading (PERF.md, §2).
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run  # noqa: E402


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    run._caches()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        res = run.run_cell(args.workload, seed, args.seconds, False, "cuda",
                           t_start=t, control=seed in ctl)
        e2e = {k: v for k, v in res["e2e"].items()
               if isinstance(v, (int, float))}
        print(json.dumps({"seed": seed, "readings": res["readings"],
                          "checks": res["checks"],
                          "sampled": res["sampled"], "e2e": e2e,
                          "peak": res["device"]["memory_peak_bytes"],
                          "seconds": time.time() - t}), flush=True)
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())

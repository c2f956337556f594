"""Path 28 of chip_smoke.py alone, cold and then warm, on one CUDA card.

    python3 tools/torch_path28.py [--runs N]

Builds the kernels (`tpu_bijectors_torch.kernels.build`), then runs
`chip_smoke.run_engines_and_flows` N times (default 2: the first pays the
card's first-use costs, the second is the warm time the path's limit
speaks of) on all six cells in one process, printing each run's JSON
line with its cells' seconds. The limit PATH28_LIMIT_S is
held on the last run only. Exits 1 when a gate failed.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_bijectors_torch.kernels import build  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_path28: CUDA is not available", file=sys.stderr)
        return 2
    t = time.perf_counter()
    build.build()
    build.load()
    print(json.dumps({"build_s": time.perf_counter() - t}), flush=True)
    for i in range(args.runs):
        line, _ = cs.run_engines_and_flows(torch.device("cuda"),
                                           time_gate=i == args.runs - 1)
        print(json.dumps({"run": i, "path28": line}), flush=True)
    if cs.failures:
        print("FAILED: " + "; ".join(cs.failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

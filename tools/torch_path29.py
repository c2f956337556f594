"""Path 29 of chip_smoke.py alone on one CUDA card: the serving export and
the sharded runners.

    python3 tools/torch_path29.py

Builds the kernels (`tpu_bijectors_torch.kernels.build`), starts path
29's two gloo ranks (`chip_smoke.start_p29_ranks`: (c)'s chain-parallel
NUTS at cell 2's settings and (d)'s parameter-parallel density and links),
then runs `chip_smoke.run_serving_and_shard` in this process ((a) and (b),
the exported artifacts; (c)'s world-size-1 run on NCCL) and waits for the
ranks. With no cell 2 run beside it, (c)'s means are held to the known
Dirichlet(1 + counts) posterior of w alone. The script's time limit
(PATH29_LIMIT_S) is not held here: the wait includes the ranks' whole run,
which chip_smoke.py overlaps with its other paths. Prints the path's JSON
line; exits 1 when a gate failed.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_bijectors_torch.kernels import build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_path29: CUDA is not available", file=sys.stderr)
        return 2
    t = time.perf_counter()
    build.build()
    build.load()
    print(json.dumps({"build_s": time.perf_counter() - t}), flush=True)
    ranks = cs.start_p29_ranks()
    line, _ = cs.run_serving_and_shard(torch.device("cuda"), ranks, time_gate=False)
    print(json.dumps({"path29": line}), flush=True)
    if cs.failures:
        print("FAILED: " + "; ".join(cs.failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Does a longer or deeper NeuTra fit shorten path 28 (f)'s NUTS trees?

    python3 tools/neutra_fit_depth.py

On one CUDA card: builds the kernels, then runs chip_smoke.py's cell (f)
(`run_p28_neutra`: `neutra_sample` of Model(bench, hier_loglik) at
P28_NEUTRA, 64 chains, 300 + 200 transitions) after each fit of FITS:
the path's own (300 steps, two 64-wide MAF layers), a longer one (800
steps, twice the MC draws) and a longer, deeper and wider one (four
layers 302 wide, twice the bench model's linked dim). Prints one JSON
line a fit: the fit's seconds and last losses, the leapfrogs a
transition a chain, ms a batched leapfrog, max R-hat, divergences, w's
distance in MCSE and the cell's gates that failed at that fit. It
measures and gates nothing itself: exits 0 when every fit ran.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_bijectors_torch.kernels import build  # noqa: E402

FITS = (
    cs.P28_NEUTRA_FIT,
    dict(n_steps=800, n_mc=64, n_layers=2, hidden=64, learning_rate=1e-2),
    dict(n_steps=800, n_mc=64, n_layers=4, hidden=302, learning_rate=5e-3),
)
KEYS = ("fit_s", "loss_first_50", "loss_last_50", "sample_s", "batched_leapfrogs",
        "ms_per_leapfrog", "leapfrogs_per_transition", "max_rhat", "divergences",
        "max_w_dev_in_mcse")


def main():
    if not torch.cuda.is_available():
        print("neutra_fit_depth: CUDA is not available", file=sys.stderr)
        return 2
    build.build()
    build.load()
    dev = torch.device("cuda")
    loglik, counts = cs.hier_loglik_and_counts(dev)
    for fit in FITS:
        n_failed = len(cs.failures)
        line, _ = cs.run_p28_neutra(dev, loglik, counts, fit)
        print(json.dumps({"fit": fit, **{k: line[k] for k in KEYS},
                          "failed": cs.failures[n_failed:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

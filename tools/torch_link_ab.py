"""Time the two matrix inverse-link kernels, #6 (`lkj_inverse`, with and
without W) and #10 (`pd_inverse`), of the PyTorch port in the checkout
given as the argument, float32 on the card: at K = 16 in the samplers'
layout (the swapped view of a transposed (151, B) state, as
`chip_smoke.py` makes it) at B = 131072 and B = 64, and #6 at K = 64,
B = 4096 on a contiguous y beside its plain version. Prints one JSON line:
the card times (CUDA events, median of 25 timings of 10 calls), each with
its byte bound's share, and the largest difference from the plain
version.

    python3 tools/torch_link_ab.py CHECKOUT

To compare two commits on one card, unpack one into a directory of the
checkout that .gitignore lists (`git archive`) and run the two in turns in
one call: A, B, B, A. The other way of writing the output tiles is timed
the same way from a copy of `tpu_bijectors_torch` with each kernel's
`kBulkStore` flipped (`csrc/lkj_inv.cu`, `csrc/pd_inverse.cu`: TMA bulk
stores or 16-byte stores from shared memory).
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# one timer, one set of states and one byte count for every checkout
from chip_smoke import C_ROWS, PD_K, PD_ROWS, PEAK_BYTES_PER_S, time_ms, time_slow_ms  # noqa: E402


def main(checkout):
    sys.path.insert(0, checkout)
    import torch

    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import pd as kp

    dev = torch.device("cuda")
    v = 0.5 * np.random.default_rng(0).standard_normal((151, 131072))
    vT = torch.as_tensor(v, dtype=torch.float32, device=dev)
    out = {"checkout": checkout}

    def row(name, fn, plain, nbytes):
        got, ref = fn(), plain()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref) if g is not None)
        ms = time_ms(fn)
        out[name] = {"ms": ms, "byte_bound_share": nbytes / PEAK_BYTES_PER_S * 1e3 / ms,
                     "max_abs_err": err}

    for B in (131072, 64):
        yc, yp = vT[C_ROWS, :B].T, vT[PD_ROWS, :B].T
        row(f"lkj_inverse (swapped, B = {B})", lambda: kl.lkj_inverse(yc, 16),
            lambda: kl.lkj_inverse_plain(yc, 16), B * 4 * (120 + 256 + 1 + 16))
        row(f"lkj_inverse with W (swapped, B = {B})", lambda: kl.lkj_inverse(yc, 16, True),
            lambda: kl.lkj_inverse_plain(yc, 16, True), B * 4 * (120 + 256 + 1 + 16 + 256))
        row(f"pd_inverse (swapped, B = {B})", lambda: kp.pd_inverse(yp, PD_K),
            lambda: kp.pd_inverse_plain(yp, PD_K), B * 4 * (136 + 256 + 1 + 256))
    K, B = 64, 4096
    P = K * (K - 1) // 2
    y = torch.as_tensor(0.5 * np.random.default_rng(6).standard_normal((B, P)),
                        dtype=torch.float32, device=dev)
    row("lkj_inverse K = 64 (contiguous, B = 4096)", lambda: kl.lkj_inverse(y, K),
        lambda: kl.lkj_inverse_plain(y, K), B * 4 * (P + K * K + 1 + K))
    out["lkj_inverse K = 64 (contiguous, B = 4096)"]["plain_ms"] = time_slow_ms(
        lambda: kl.lkj_inverse_plain(y, K))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])

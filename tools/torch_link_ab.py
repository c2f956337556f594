"""Time the link kernels of the PyTorch port in the checkout given as the
argument, float32 on the card: the matrix inverse links #6 (`lkj_inverse`,
with and without W) and #10 (`pd_inverse`) at K = 16 in the samplers'
layout (the swapped view of a transposed (151, B) state, as
`chip_smoke.py` makes it) at B = 131072 and B = 64, and #6 at K = 64,
B = 4096 on a contiguous y beside its plain version; the simplex inverse
#7 (`simplex_inverse_logdet`) at B = 64 in the swapped view and, with
the Dirichlet weights, the batch-major slice, and at B = 131072 in the
swapped view with and without them, and #8 (`simplex_inverse`, x alone) at B = 64 and 131072 in the
batch-major slice; the PD trace gradient #12 (`pd_trace_grad`, K = 16,
C = I) in both modes at B = 64 and 131072 in the batch-major slice and at
131072 in the swapped view, and the PD log-density #11 in both modes at
B = 64 and 131072 in the batch-major slice and the swapped view; the LKJ
log-det #5 (`lkj_logdet`: K = 16 on the bench state's LKJ rows, and the
Cholesky variant at K = 5 on its rows 31-40) and the simplex forward link
#9 (`simplex_forward_logdet`, K = 16 on `chip_smoke.simplex_points_T`) in
the batch-major slice, a contiguous tensor and the swapped view at
B = 64 to 131072 (LOGDET_BS). Each in the design its wrapper picks for
the batch. Prints one JSON line: the card times (CUDA events, median of 25 timings of 10 calls), each with its byte
bound's share, the largest difference from the plain version and, for
#5, #7, #8, #9, #11 and #12, a digest of the outputs' bits (equal
digests: the same outputs bit for bit; `digest_x` of the first output
alone: x, logJ or y; for #11 also of logJ and sum y_rr alone).

    python3 tools/torch_link_ab.py CHECKOUT

To compare two commits on one card, unpack one into a directory of the
checkout that .gitignore lists (`git archive`) and run the two in turns in
one call: A, B, B, A. The other way of writing the output tiles is timed
the same way from a copy of `tpu_bijectors_torch` with each kernel's
`kBulkStore` flipped (`csrc/lkj_inv.cu`, `csrc/pd_inverse.cu`: TMA bulk
stores or 16-byte stores from shared memory). #5's and #9's designs are
timed alone the same way, from copies with the batch that chooses them
moved (`kDirectMinB` in `csrc/lkj_logdet.cu`, `kStagedMinB` in
`csrc/simplex_fwd.cu`).
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# one timer, one set of states and one byte count for every checkout
from chip_smoke import (  # noqa: E402
    C_ROWS,
    PD_K,
    PD_ROWS,
    PEAK_BYTES_PER_S,
    W_ROWS,
    X_ROWS,
    digest,
    layouts,
    simplex_points_T,
    time_ms,
    time_slow_ms,
)


# #5 and #9 at the batches that place their designs' crossovers
# (csrc/lkj_logdet.cu's kDirectMinB, csrc/simplex_fwd.cu's kStagedMinB)
LOGDET_BS = (131072, 65536, 32768, 16384, 1024, 64)


def main(checkout):
    sys.path.insert(0, checkout)
    import torch

    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.kernels import simplex as ks

    dev = torch.device("cuda")
    v = 0.5 * np.random.default_rng(0).standard_normal((151, 131072))
    vT = torch.as_tensor(v, dtype=torch.float32, device=dev)
    out = {"checkout": checkout}

    def row(name, fn, plain, nbytes, bits=False):
        got, ref = fn(), plain()
        if isinstance(got, torch.Tensor):
            got, ref = (got,), (ref,)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref) if g is not None)
        ms = time_ms(fn)
        out[name] = {"ms": ms, "byte_bound_share": nbytes / PEAK_BYTES_PER_S * 1e3 / ms,
                     "max_abs_err": err}
        if bits:
            out[name]["digest"] = digest(got)
            out[name]["digest_x"] = digest(got[:1])

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
    # the simplex inverse: y (B, 15), x (B, 16), ld (B,), and wlog (B,)
    # with the Dirichlet weights: as cell 2's leapfrog calls it (the swapped
    # view, no weights) and cell 4's (the batch-major slice, weights)
    am1 = torch.arange(16, dtype=torch.float32, device=dev)
    vb = vT.T.contiguous()  # (131072, 151), batch-major
    for B, lay, y, a in ((64, "swapped", vT[W_ROWS, :64].T, None),
                         (64, "batch-major slice", vb[:64, W_ROWS], am1),
                         (131072, "swapped", vT[W_ROWS].T, None),
                         (131072, "swapped", vT[W_ROWS].T, am1)):
        row(f"simplex_inverse_logdet{'' if a is None else ' with wlog'} ({lay}, B = {B})",
            lambda y=y, a=a: ks.simplex_inverse_logdet(y, a),
            lambda y=y, a=a: ks.simplex_inverse_logdet_plain(y, a),
            B * 4 * (15 + 16 + (1 if a is None else 2)), True)
    for B in (64, 131072):
        y = vb[:B, W_ROWS]
        row(f"simplex_inverse (batch-major slice, B = {B})", lambda y=y: ks.simplex_inverse(y),
            lambda y=y: ks.simplex_inverse_plain(y), B * 4 * (15 + 16), True)
    # the PD log-density #11: y (B, 136) and C = I, logJ, sum y_rr and the
    # trace (B,); and the PD trace gradient #12, g (B, 136)
    eye = torch.eye(PD_K, device=dev)
    for mode in ("dot", "solve"):
        for B, lay, y in ((64, "batch-major slice", vb[:64, PD_ROWS]),
                          (64, "swapped", vT[PD_ROWS, :64].T),
                          (131072, "batch-major slice", vb[:, PD_ROWS]),
                          (131072, "swapped", vT[PD_ROWS].T)):
            row(f"pd_logdensity {mode} ({lay}, B = {B})",
                lambda y=y, m=mode: kp.pd_logdensity(y, PD_K, eye, m),
                lambda y=y, m=mode: kp.pd_logdensity_plain(y, PD_K, eye, m),
                B * 4 * (136 + 3) + eye.numel() * 4, True)
            out[f"pd_logdensity {mode} ({lay}, B = {B})"]["digest_logJ_sumd"] = digest(
                kp.pd_logdensity(y, PD_K, eye, mode)[:2])
        for B, lay, y in ((64, "batch-major slice", vb[:64, PD_ROWS]),
                          (131072, "batch-major slice", vb[:, PD_ROWS]),
                          (131072, "swapped", vT[PD_ROWS].T)):
            row(f"pd_trace_grad {mode} ({lay}, B = {B})",
                lambda y=y, m=mode: kp.pd_trace_grad(y, PD_K, eye, m),
                lambda y=y, m=mode: kp.pd_trace_grad_plain(y, PD_K, eye, m),
                B * 4 * (136 + 136) + eye.numel() * 4, True)
    # the LKJ log-det #5: y (B, 120), logJ (B,), log diag W (B, 16); its
    # Cholesky variant at K = 5: y (B, 10), logJ, log diag W (B, 5); the
    # simplex forward link #9: x_0..x_14 of (B, 16), y (B, 15), ld (B,)
    xT = simplex_points_T(vT)
    for B in LOGDET_BS:
        for lay, y in layouts(vT, C_ROWS, B, "batch-major slice").items():
            row(f"lkj_logdet ({lay}, B = {B})", lambda y=y: kl.lkj_logdet(y, 16),
                lambda y=y: kl.lkj_logdet_plain(y, 16), B * 4 * (120 + 1 + 16), True)
        for lay, y in layouts(vT, slice(31, 41), B, "batch-major slice").items():
            row(f"lkj_logdet_chol K = 5 ({lay}, B = {B})", lambda y=y: kl.lkj_logdet(y, 5, True),
                lambda y=y: kl.lkj_logdet_plain(y, 5, True), B * 4 * (10 + 1 + 5), True)
        for lay, x in layouts(xT, X_ROWS, B, "batch-major slice").items():
            row(f"simplex_forward_logdet ({lay}, B = {B})",
                lambda x=x: ks.simplex_forward_logdet(x),
                lambda x=x: ks.simplex_forward_logdet_plain(x), B * 4 * (15 + 15 + 1), True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])

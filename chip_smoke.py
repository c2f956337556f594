"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Builds every kernel in `tpu_bijectors_torch/kernels/csrc/` (one nvcc per
source, all at once; the ptxas report of registers and spills is printed),
then drives the bench model (8 Normal, 8 LogNormal, Dirichlet(16), LKJ(16):
linked dim 151) in float32 through the entry points a user calls, on four
paths, the PD models (tools/mega_probe.py's `pdonly`: Wishart(18, I_16)
and 15 iid N(0, 1), linked dim 136 + 15 = 151, and its twin with
InverseWishart(18, I_16)) on three more, `mvdense` (4 x
MvNormalTril(16), MvNormalCanon(16), 4 x MvStudentT(5, 16), MvLogNormal(4),
MvNormalDiag(3): linked dim 151) on three more, `families` (the JAX
package's whole-family test model: every slab-served scalar family,
arraydist, IID blocks of structured leaves, LKJCholesky, a transformed
Beta; linked dim 125) on two, eight schools on one, the #13 probe, the
traced models (`generic-traced` of tools/tpu_sweep.py: two truncated
priors, Kumaraswamy, BetaPrime, InverseGaussian, JohnsonSU,
TriangularDist, a Normal mixture and four joint order statistics, linked
dim 12; the JAX tests' truncated-leaves and vector-leaves models) on two,
the #14 probe, the engines of the thirteenth slice (ChEES with the
dense metric, dense NUTS through a checkpoint, SMC, ADVI) on four,
those of the fourteenth (MAP + Laplace with the evidence estimators,
Pathfinder and NUTS from its starts) on two, those of the fifteenth
(the flat-vector API, forward mode, parameter tangents, the samplers and
the property sweep) on one, those of the sixteenth (the remaining
bijectors, CDF/Quantile with implicit derivatives) on one, the
seventeenth's remaining distribution families on one, and the
eighteenth's engines (parallel tempering, the ensemble sampler, SBC, the
predictive checks), flows and NeuTra on one, and the nineteenth's serving
export and sharded runners on one:

1. transposed serving at B = 131072: `Model.batched_logdensity_t_fn()`
   (the slab value kernel), its `value_and_grad_fn` (the one-pass
   value-and-gradient kernel) and `torch.autograd.grad` through
   `linked_logdensity_t` (the vector-Jacobian kernel);
2. transposed NUTS with a likelihood on `Model(priors, loglik=hier_loglik)`
   (`kernel='nuts_batched_t'`), with 64 chains, max_depth 8, 300 warmup and
   200 kept transitions, target acceptance 0.95 (see TARGET_ACCEPT):
   `Model.sample` with n_samples=0 runs the warmup, `resume_sampling` the
   200 transitions from its state (the draws of one uninterrupted
   `Model.sample`, timed apart), and `Model.constrain` maps the draws.
   Every leapfrog runs the one-pass slab kernel for the prior and the
   stick-breaking and LKJ inverse-link kernels for the likelihood term;
3. batch-major serving at B = 131072 on (B, 151) states:
   `Model.batched_logdensity_fn()` and its autograd gradient (the LKJ
   log-det kernel and the simplex inverse kernel without x), the round
   trip `to_linked_vec(from_linked_vec(v))` (the simplex forward kernel),
   the classic `inverse(bijector(Dirichlet(ones(16))))` in both directions
   (the x-only simplex inverse and the simplex forward kernels), and the
   likelihood model's `batched_logdensity_fn` at 64 states;
4. batch-major NUTS with the same likelihood and settings
   (`kernel='nuts_batched'`): every leapfrog runs the simplex and LKJ
   inverse-link kernels on the (64, 151) state;
5. transposed serving of both PD models at B = 131072 on the same states:
   the three whole-model kernels with the PD loop entry (dot mode for
   Wishart, solve mode for InverseWishart);
6. batch-major serving of both PD models on (B, 151) states:
   `batched_logdensity_fn()` (the PD log-density kernel), its gradient
   (the trace-gradient kernel) and `Model.constrain` (the PD inverse);
7. the pd_conjugate cell: `Model(pdonly, loglik).sample(kernel='auto')`'s
   steps (its kernel, `nuts_batched_t`, from starts at 0.3 N(0, 1)), with
   200 observations z ~ N(0, Sigma) (loglik = 100 log det W -
   tr(W Z'Z) / 2) and the settings of path 2:
   each leapfrog runs the value-and-gradient kernel with the PD entry and
   the PD inverse kernel with its backward;
8. transposed serving of mvdense at B = 131072 on the same states, all
   four modes of the whole-model kernel with the Gaussian and t loop
   entries: `batched_logdensity_t_fn()`, its `value_and_grad_fn`,
   autograd's backward and `torch.func.jvp` of `linked_logdensity_t` (the
   forward-mode kernel, #4);
9. batch-major serving of mvdense (torch's triangular solves: no kernel),
   held to path 8, and `Model.constrain`;
10. the mv_conjugate cell: `Model(mvdense, loglik).sample(kernel='auto')`'s
   steps with 200 Gaussian observations on one MvNormalTril copy, from
   0.3 N(0, 1) starts, 300 warmup and MV_KEPT kept transitions; each
   leapfrog runs the value-and-gradient kernel with the Gaussian and t
   entries;
11. the launch-size repairs: `wide` (4000 slab rows, the table in global
   memory) in all four modes, `pdwide` (dim 1051 with a PD entry) and the
   LKJ inverse at K = 64 (its tiles in shared memory) and at K = 200 and
   337 (one element's factor packed in shared memory), against their
   plain versions; and #4 on the bench and PD models;
12. transposed serving of `families` at B = 131072 in all four modes of
   the whole-model kernel (slab rows of every term group, the exp and
   log1p groups and per-element coefficients among them, and four PD
   entries, two of them IID copies sharing a parameter block), and an
   extremes block of 64 columns at +-1e10 (the plain version's
   finite/inf pattern, no NaN);
13. batch-major serving of `families` at B = 131072: the LKJ log-det
   kernel in both variants (`chol=True` for LKJCholesky), the simplex
   kernels, the PD log-density and its backward, the round trip v -> x ->
   v;
14. eight schools, non-centered (examples/eight_schools_nuts.py):
   `Model(priors, loglik).sample(kernel='auto')`'s steps from 0.5 N(0, 1)
   starts at target 0.8, gated against the JAX package's float64 means of
   mu and tau (ES_JAX);
15. the #13 probe of the slab's per-element math: every variant against
   its plain version, then `probe.run`, which times them;
16. transposed serving of the three traced models at B = 131072 in all
   four modes of the whole-model kernel with the traced loop kind (the
   tape interpreter of kernels/csrc/traced_tape.cuh), each against its
   plain tape on the card, the float64 plain version and the float64
   composed path at bounds from the magnitudes its tape forms
   (`traced_allowances`), and an extremes block of 64 columns at +-1e10
   on generic-traced (the plain version's pattern, no NaN in lp);
17. traced sampling: `Model(generic-traced).sample(kernel='auto')`'s steps
   on the prior alone, 64 chains from 0.3 N(0, 1), target 0.8, 300 warmup
   and 1000 kept transitions (TRACED_KEPT), gated on R-hat, divergences
   and every coordinate's mean within 5 MCSE of its exact mean;
18. the #14 probe: every opcode of the traced entries' admission set as a
   one-instruction tape on the interpreter, against its plain version,
   the torch op and torch.autograd in float64 at its edge points, timed;
   then `_prep`'s first call on the generic-traced and bench models;
19. chees_dense: `Model(pdonly, loglik).sample(kernel='chees',
   metric='dense')`'s steps on cell 7's data and starts, batch-major:
   every lockstep leapfrog runs the PD log-density kernel (#11) and its
   trace-gradient kernel (#12) for the prior, the PD inverse (#10) and
   its backward for the likelihood; the trajectory length read to the
   host once a transition; gated as cell 7;
20. eight_schools_dense: cell 14 with metric='dense' on `nuts_batched_t`
   (#2's item kernel), the warmup's state through `save_sampler_state`
   and `load_sampler_state` (every field bit for bit) before
   `resume_sampling`; gated as cell 14;
21. smc_eight_schools: `run_smc(transposed=True, mutation='hmc')` on
   SMC_N = 32768 particles from eight schools' prior draws, the prior
   `Model(priors).batched_logdensity_t_fn()` (#1 for the value, #3 in the
   mutation's backward); gated on the final temperature, the means of mu
   and tau against the exact posterior means (`eight_schools_exact_means`)
   and the log evidence against the JAX package's float64 run
   (SMC_LOGEV_JAX);
22. advi_mv_conjugate: `fit_advi(Model(mvdense,
   loglik).batched_logdensity_t_fn(), q=FullRankGaussian, estimator='stl',
   transposed=True)` with n_mc 1024 (#1 and #3 with the Gaussian and t
   entries), gated on the fit's means and the likelihood block's
   variances against the known posterior;
23. map_laplace: `map_laplace(Model(bench, hier_loglik))` from zeros,
   MAP_STEPS L-BFGS steps (every line-search trial one evaluation at
   B = 1: #6 with W, #7's small design; one host read a trial), its
   Hessian one double backward at B = 151; lp and the MAP against the JAX
   package's float64 run (LAPLACE_JAX), the Laplace sd and evidence
   against the port's float64 Hessian at the card's MAP; `map_laplace` on
   cell 7's pd_conjugate model (#10-#12, #12 under the double backward)
   with its Hessian against float64; `importance_sampling_evidence` and
   `bridge_sampling_evidence` (path 2's draws) with the Laplace proposal
   at n = 4096 against the JAX package's IS evidence;
24. pathfinder: `fit_pathfinder` from zeros and `multipath_pathfinder`
   from 8 starts at 0.3 N(0, 1) on the same model (the candidates' ELBO
   draws in one density call at B = 1800 and 14400), gated on the best
   ELBO and the `w` block's means against the JAX package's float64 runs
   (PATHFINDER_JAX); then `Model.sample(init='pathfinder', kernel='auto')`
   at path 2's settings and gates;
25. the flat-vector API, forward mode, parameter tangents, the samplers
   and the property sweep (`run_flat_api_and_tangents`, under
   PATH25_LIMIT_S): the bench model's `sample` at B = 131072 (the means
   and the LKJ off-diagonal variance within 5 MCSE), `to_vec`/`from_vec`
   and `UnconstrainerBijector` bit for bit, the round trip v -> x -> v to
   path 3's bounds; the forward-mode tangents of `from_linked_vec`'s
   log-det and `linked_logdensity` (the link Functions' jvps: #5-#12) on
   the bench and Wishart(3) models against reverse mode and float64; the
   transposed density's gradient in the Dirichlet's alpha and the LKJ's
   eta at B = 64 against float64 (the composed path: link kernels, none of
   #1-#4); `testing.test_all` in float32 on the bench model's four leaves
   and the Wishart families at K = 3; #7 at K = 256 and 1024 against the
   sequential and scan plain versions;
26. the remaining bijectors and CDF/Quantile (`run_bijectors_and_quantiles`,
   under PATH26_LIMIT_S): `Stacked.from_lengths` of the bench model's
   links (Identity, Exp, inverse(SimplexBijector), inverse(VecCorrBijector)
   then Reshape) at B = 131072 against `UnconstrainerBijector`, launching
   the kernels its members launch alone (#7, #8, #6; #9 back) and none of
   #1-#4, with no copy of the state beyond its output; the same on the
   Wishart(3) model's PD links (#10); Coupling, Permute, LinearMap,
   TriangularLinearMap, ProductBijector, CorrBijector (K = 16, #6) and
   the seven scalar maps, round trips at B = 131072 and log-dets against
   torch.func.jacrev at B = 64; QuantileBijector(Gamma(2, 3)) (the
   generic quantile under `set_sync_debug_mode("error")`) and
   CDFBijector(Beta(2, 5)) at B = 131072 against the float64 quantile
   within the float32 cdf's error over the pdf; NUTS on a quantile-linked
   prior with kernel='auto' (64 chains, 200 + 300 transitions) against
   Gamma(2, rate 3)'s exact mean.
27. the remaining distribution families (`run_remaining_families`, under
   PATH27_LIMIT_S): (a) the fused model of the new scalar families both
   plans serve (`p27_served_model`: IID blocks of 4 of nineteen families,
   VonMises and Cosine through the tape's cos opcode, an Affine and a
   Censored leaf; dim 84) at B = 131072 in all four modes of #1-#4 with
   the traced kind (launching #1-#4 alone) against their plain versions
   and float64, and at +-1e10; (b) the composed model of the leaves the
   plans decline (GeneralizedPareto, Rician, the four noncentral
   families, NormalInverseGaussian, StudentizedRange, MvLogitNormal(4) on
   #7/#9, MatrixBeta(3, 6, 7) on #10, MatrixTDist, MatrixNormal) at
   B = 131072 from its draws: density and gradient per leaf against
   float64, the round trip v -> x -> v; (c) NUTS (kernel='auto' ->
   nuts_batched_t, #2's small design on every leapfrog) on VonMises(0.3,
   2), Gompertz(1, 0.1), Lindley(1.5), Chisq(3) and Semicircle(1.5) against
   their exact means; (d) the discrete families' pmfs, cdfs and draws at
   B = 131072 against scipy.stats in float64; (e) the slab+structured
   model of tools/tpu_sweep.py:79-90, fused against plain and composed;
   (f) #14 on the cos and sin opcodes.
28. the engines that need no flows, the flows and NeuTra
   (`run_engines_and_flows`; tools/torch_path28.py runs it alone, its
   last, warm run under PATH28_LIMIT_S): (a) `run_parallel_tempering`
   on the bench model's batch-major prior (#5, #7) and the likelihood
   hier_loglik(constrain(v)) (#6, #7), 4 rungs x 64 chains, 8 leapfrogs,
   with no synchronization of the card in the run, gated on the cold
   chains' w against Dirichlet(1 + counts), the TI evidence and each
   pair's swap rate; (b) `run_ensemble` with 64 walkers on a Dirichlet(4)
   and Beta conjugate model (#7) against its exact posterior means; (c)
   `sbc_ranks` (kernel='nuts_batched', 64 simulations as chains, #7 and
   #9) on a Dirichlet(4) and Normal model, every coordinate's uniformity
   p-value >= 1e-3; (d) `prior_predictive` of (c)'s model at B = 131072
   against its exact moments, `posterior_predictive` from (a)'s draws
   and `ppc_pvalue` against a recount on the host; (e) the planar,
   radial, RQS, batch-norm layers and the MAF and NSF-AR stacks at dim
   151 and B = 131072 against their float64 evaluation on the same
   weights, the round trips, the RQS's identity tails, find_alpha's
   gradient against the implicit rule; (f) `neutra_sample` on
   `Model(bench, hier_loglik)` with a MAF transport from
   `fit_neutra_flow`, 64 chains, gated on the ELBO's descent, w, R-hat
   and divergences. Cells (a) and (f) run in a third process.
29. serving export and the sharded runners (`run_serving_and_shard`;
   tools/torch_path29.py runs it alone): (a) `serving.export_logdensity`
   of the bench model's transposed density and its value and gradient at
   B = 131072, saved to bytes and loaded: the graph's `tbt::` nodes, #1 /
   #2 launched once a call, the output bit for bit the live call's, a
   wrong batch raising, an export with the kernels disabled raising; (b)
   the batch-major density (#5, #7) and `export_constrain` (#6, #7) at
   B = 4096 likewise; (c) `chain_parallel_nuts` (`kernel='nuts_batched_t'`)
   on one NCCL rank against the unsharded run bit for bit, and at cell
   2's settings over two gloo ranks on the one card (NCCL refuses two
   ranks on one device), 32 chains each: the step size and inverse mass
   bit for bit the same on both, the draws on their supports, the means
   within 5 combined MCSE of cell 2's; (d) `param_parallel_logdensity` on
   the bench prior and `param_parallel_from_linked` on two-block IID LKJ
   and Dirichlet priors at B = 131072 over the same ranks (#5-#7) against
   the unsharded density and links within RTOL_COMPOSED. The ranks are
   processes of their own, started after the build beside the others.

The dense paths also check that TF32 is off and the float32 matmul
precision 'highest'. After them, #2's small-batch design (the item kernel, which the
value-and-gradient wrapper launches at B <= SMALL_B: every sampler's
leapfrog) is held to its plain version on every model the paths drive
(`ITEM_MODELS`) at B = 1, 31, 64, 65, 200 and SMALL_B, at the allowances
of each model's own checks, bit for bit on a second launch, and on the
extremes blocks of families and generic-traced (`check_small_design`).
The sampler paths count its launches (`slab_value_and_grad_small`); the
B = 131072 serving paths must launch it no time. The simplex inverse #7
and #8 have two designs by batch too (`kernels/simplex.py::simplex_design`:
a group of lanes an element at B <= simplex.SMALL_B, its #7 launches
counted as `simplex_inverse_logdet_small`; a thread an element above): each
is held to the plain version at B = 1 ... 131072 and K = 2 ... 128 in the
three layouts, with x the same bit for bit in both designs, in #8 and on a
repeat (`check_simplex_designs`), and the sampler paths 2 and 4 must launch
the small design on every batched leapfrog. The PD trace gradient #12 is
held to its plain version and float64 in both modes at B = 1 ... 131072
and K = 1 ... 16 in the three layouts, bit for bit on a repeat, with its
log-density's backward against autograd (`check_pd_trace_grad`); the PD
log-density #11 likewise at B = 1, 15, 16, 17, 64 and 131072 and K = 1, 2,
5, 15 and 16 (`check_pd_logdensity`). The value kernel #1 walks runs of
rows (`fused_kernel.run_rows`): it is held to its plain version and
float64 on every model the paths drive and on `wide-general` (4000 {lin,
exp} rows, whose packed coefficients lie beyond shared memory: the walk's
read-only-path instantiation) at B = 1, 65 and the paths' batch, bit for
bit on a repeat, on the extremes blocks of families and generic-traced,
and on each run of families that takes the general row function, alone
(`check_run_walk`). The LKJ log-det #5 (both variants) and the simplex
forward link #9 choose their design by K and batch (`csrc/lkj_logdet.cu`,
`csrc/simplex_fwd.cu`): each is held to its plain version at B = 1, 31, 64,
65, 1000 and 131072 in the three layouts, #5 at K = 2 ... 400 (past every
design's shared memory), #9 at K = 2 ... 700, bit for bit on a repeat, at
1e10 and on the simplex's faces (`check_link_logdets`).

The launch counters are set to 0 just before each path and read just after
it; each kernel of the path must have launched. Each kernel is held against
its plain PyTorch version on the same inputs: the slab kernels at
B = 131072; the link kernels in the three input layouts they read (the
slice of a batch-major (B, 151) state, a contiguous (B, P) tensor and the
swapped view of the (151, B) state; `layouts`) at B = 131072 and 64, the
inverse links also on the 200 x 64 draws, the LKJ log-det (both variants)
and the simplex inverse and forward kernels also at a partial block, and
all at 1e10 states; each with its closed-form backward against autograd
through the plain version. The log-densities are also held against the
composed per-leaf path and the plain path in float64, the likelihood model
(at 64 and 4096 states) against its float64 plain version on the CPU, and
each sampler's draws against the known Dirichlet(1 + counts) posterior of
`w` (within 5 MCSE), with R-hat <= 1.05 and divergences <= 1%. The PD
kernels and the PD entry are held against their plain versions and float64
in both modes, at error bounds from the sums and substitutions they do
(`pd_reference`: the solve mode's scale with kappa(L)), and the
pd_conjugate draws against the Wishart(218, (I + Z'Z)^-1) posterior. The
mvdense kernels are held to their plain versions and float64 at bounds
from the sums they do (`quad_bounds`), and the mv_conjugate draws against
the posterior means of all 151 coordinates. Every
kernel is timed with CUDA events in each of its layouts, beside its plain
version (`kernel_table`, `time_kernels`), and the PD, mvdense, repair and
families variants with their bounds (`pd_variants`, `model_variants`).

Prints the card's name and power limit, one JSON line per kernel, a
`kernel_variants` line (every layout's time; #2 at 64 chains in both
designs on each sampler cell's model; #7 in both designs at 64 and
131072; #11 and #12 in both modes at 64; #5 (both variants) and #9 in each
layout at 64; #6, #7 and #10-#12 at the batches paths 23-24 launch them,
#1 and #3 at paths 21-22's; a kernel that does nothing, the launch
floor), a `slab_small_b_sweep` line (#2 in both designs at
B = 64 to 131072 on the bench, mvdense and pdonly models: the crossover
that sets SMALL_B), a `simplex_small_b_sweep` line (#7 in both designs
at B = 64 to 131072 in the swapped view and the batch-major slice: the
crossover that sets simplex.SMALL_B), a `transcend_probe` line
(every probe variant's time), a `prim_probe` line per opcode, a `prep_s`
line, an `end_to_end` line (the
entry points with host dispatch), a `phases_s` line (each phase's wall
time), a `sampler` line per cell, a `map_laplace` and a `pathfinder`
line (paths 23-24), a `path28` and a `path29` line, a `{"kernels": [...]}` line, and as
the last line `{"ok": true, "device": {...}}`. Exits non-zero, with no
result, when CUDA is absent or any check fails.
"""

import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 131072
SEED = 0
# float32 reordering of a 151-term sum: the kernel adds the rows one by one
# in a register, the plain version reduces them in another order. The lp
# tolerances are relative to the magnitude of the terms the sum carries
# (|sum of slab terms| + |c0 row sum|); the gradient is one row per element.
RTOL_LP = 2e-5
RTOL_G = 1e-5
RTOL_COMPOSED = 1e-4  # another algebra (cumsums, logcosh of packed slots)
# published peaks of the H100 SXM (NVIDIA data sheet), at a 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# operations per element of one row, per term group and kernel mode (each
# arithmetic operation, comparison, select and transcendental counts one, so
# the operation bound is a floor: an accurate expf or log1pf takes several
# instructions), plus 2 per element for the ownership select and the
# centring subtract
OPS = {
    "value": {"lin": 3, "quad": 4, "absv": 6, "sp": 8, "exp": 7, "l1p": 7},
    "value_and_grad": {"lin": 4, "quad": 7, "absv": 7, "sp": 15, "exp": 10, "l1p": 14},
    "vjp": {"lin": 2, "quad": 4, "absv": 5, "sp": 12, "exp": 6, "l1p": 9},
    # the partial, then one multiply-add with the tangent
    "jvp": {"lin": 3, "quad": 5, "absv": 6, "sp": 13, "exp": 7, "l1p": 10},
}
REPLACES = {
    "slab_value": "tpu_bijectors/vectorize/fused_kernel.py:226",
    "slab_value_and_grad": "tpu_bijectors/vectorize/fused_kernel.py:383",
    "slab_vjp": "tpu_bijectors/vectorize/fused_kernel.py:321",
    "slab_jvp": "tpu_bijectors/vectorize/fused_kernel.py:274",
    "simplex_inverse_logdet": "tpu_bijectors/kernels/simplex.py:181",
    "lkj_inverse": "tpu_bijectors/kernels/lkj.py:167",
    "lkj_logdet": "tpu_bijectors/kernels/lkj.py:88",
    "simplex_inverse": "tpu_bijectors/kernels/simplex.py:59",
    "simplex_forward_logdet": "tpu_bijectors/kernels/simplex.py:252",
    "pd_inverse": "tpu_bijectors/kernels/pd.py:73",
    "pd_logdensity": "tpu_bijectors/kernels/pd.py:177",
    "pd_trace_grad": "tpu_bijectors/kernels/pd.py:302",
    "lkj_logdet_chol": "tpu_bijectors/kernels/lkj.py:88",
    "transcend_probe": "tools/transcend_probe.py:157",
    # the traced loop kind of #1-#4 (its row: the value-and-gradient mode,
    # the leapfrog's, on generic-traced) and the per-opcode probe #14
    "slab_traced": "tpu_bijectors/vectorize/fused_kernel.py:383",
    "prim_probe": "tools/prim_lowering_probe.py:128",
    # #2's small-batch design, the samplers' (its row: cell 2's B = 64)
    "slab_value_and_grad_small": "tpu_bijectors/vectorize/fused_kernel.py:383",
    # #7's small-batch design, the samplers' (its row: cell 2's B = 64)
    "simplex_inverse_logdet_small": "tpu_bijectors/kernels/simplex.py:181",
}
CSRC = "tpu_bijectors_torch/kernels/csrc/"
SOURCES = {
    "slab_value": CSRC + "fused_slab.cu",
    "slab_value_and_grad": CSRC + "fused_slab.cu",
    "slab_vjp": CSRC + "fused_slab.cu",
    "slab_jvp": CSRC + "fused_slab.cu",
    "simplex_inverse_logdet": CSRC + "simplex_inv.cu",
    "lkj_inverse": CSRC + "lkj_inv.cu",
    "lkj_logdet": CSRC + "lkj_logdet.cu",
    "simplex_inverse": CSRC + "simplex_inv.cu",
    "simplex_forward_logdet": CSRC + "simplex_fwd.cu",
    "pd_inverse": CSRC + "pd_inverse.cu",
    "pd_logdensity": CSRC + "pd_logdensity.cu",
    "pd_trace_grad": CSRC + "pd_trace_grad.cu",
    "lkj_logdet_chol": CSRC + "lkj_logdet.cu",
    "transcend_probe": CSRC + "transcend_probe.cu",
    "slab_traced": CSRC + "traced_tape.cuh",
    "prim_probe": CSRC + "prim_probe.cu",
    "slab_value_and_grad_small": CSRC + "fused_slab.cu",
    "simplex_inverse_logdet_small": CSRC + "simplex_inv.cu",
}
# the kernels each path must launch: transposed serving (path 1), the
# inverse links of both samplers (paths 2 and 4), batch-major serving
# (path 3, which runs the inverse links too)
SLAB_KERNELS = ("slab_value", "slab_value_and_grad", "slab_vjp")
# #2's small-batch design (the item kernel), which the value-and-gradient
# wrapper launches at B <= SMALL_B: every sampler's leapfrog, never the
# B = 131072 serving paths
SMALL = "slab_value_and_grad_small"
# #7's small-batch design (a group of lanes an element), which its wrapper
# launches at B <= kernels/simplex.py's SMALL_B: every sampler's leapfrog
SIMPLEX_SMALL = "simplex_inverse_logdet_small"
LINK_KERNELS = ("simplex_inverse_logdet", "lkj_inverse")
BATCH_MAJOR_KERNELS = ("lkj_logdet", "simplex_inverse", "simplex_forward_logdet")
# the link kernels against their plain versions, float32: x and X are
# bounded by 1 and held absolutely; the log-dets and wlog are sums of 15-120
# logs held relative to their magnitude; the backward is the closed form
# against autograd through the plain version (another order of operations)
ATOL_UNIT = 2e-6
RTOL_SUM = 1e-5
# the simplex forward link's y against its plain version: the plain
# version's prefix sum (torch.cumsum) and the kernel's running sum round
# differently, and y_k = logit(z_k) + log(K-1-k) magnifies an ulp of s_k by
# 1 / ((1+eps) - s_k); y is O(1) and held absolutely (1.5e-5 at most at
# B = 131072 on the H100)
ATOL_LOGIT = 1e-4
RTOL_VJP = 1e-4
# operations per element of the link kernels (each arithmetic operation,
# comparison and transcendental counts one, so this is a floor): the
# stick-breaking step per coordinate; per packed LKJ slot, and X = W'W as
# 816 multiply-adds (2 operations each) at K = 16
OPS_SIMPLEX_COORD = 22
OPS_LKJ_SLOT = 12
# the batch-major kernels, counted alike: a logcosh and two running sums
# per LKJ slot; the x-only stick-breaking step; the forward step (z, the
# logit, and the log-det's three logs and floors) per coordinate
OPS_LKJ_LOGDET_SLOT = 8
OPS_SIMPLEX_X_COORD = 11
OPS_SIMPLEX_FWD_COORD = 22
# operations per element of the PD kernels at K = 16, counted alike (a
# multiply-add is 2): unpacking y (a copy per slot, two exps and three
# operations per diagonal slot) 216; X = LL' 816 multiply-adds; the dot
# trace 816 multiply-adds and 3 operations per packed slot; a forward
# substitution column 120 multiply-adds and 16 multiplies (256), the solve
# trace 16 columns and 16 squares each (288 a column); the dot gradient
# 1496 multiply-adds and 2 operations per slot; the solve gradient 16
# forward and 16 back substitution columns (256 each) and 16 rank-one
# updates of G (136 multiply-adds), and 2 operations per slot
def pd_ops(K):
    """The PD kernels' operation floors at K, counted as above: unpack
    P + 5K (P = K(K+1)/2 slots), X = LL' K(K+1)(K+2)/6 multiply-adds, a
    substitution column K^2 (the solve trace K^2 + 2K a column), the dot
    gradient K(K+1)(K+2)/6 + K(K+1)(K-1)/6 multiply-adds."""
    P = K * (K + 1) // 2
    unpack, xll = P + 5 * K, K * (K + 1) * (K + 2) // 6
    return {
        "inverse": unpack + 2 * xll,
        "dot": unpack + 2 * xll + 3 * P,
        "solve": unpack + K * (K * K + 2 * K),
        "dot_grad": unpack + 2 * (xll + K * (K + 1) * (K - 1) // 6) + 2 * P,
        "solve_grad": unpack + K * (2 * K * K + 2 * P) + 2 * P,
    }


PD_OPS = pd_ops(16)
# the float32 round trip v -> x -> v of the bench model. The scalar and
# simplex rows are held absolutely (1.1e-6 at most on the H100 at
# B = 131072). The LKJ rows pass through torch.linalg.cholesky of a 16 x 16
# correlation matrix X, whose error grows with its condition number kappa
# (up to 3.9e6 among these states): a row's largest error is held to
# kappa * eps32 + ATOL_ROUNDTRIP (at most 0.14 of that on the H100). The
# log-det is held relative to its magnitude (2.6e-4 at most on the H100).
ATOL_ROUNDTRIP = 1e-4
RTOL_ROUNDTRIP_LD = 1e-3
# the batch-major likelihood model's gradient against float64: as the
# transposed one's (1e-4, which it meets at 9.5e-5), plus the composed
# prior's own float32 sums of the same magnitude (1.05e-4 on the H100 at
# 64 states)
RTOL_G_BATCH_MAJOR_LIK = 2e-4
# the sampler run: bench.py's NUTS settings (64 chains, max_depth 8, 300
# warmup transitions) and 200 kept draws, at a target acceptance of 0.95.
# The likelihood's (ybar - mu)^2 / (sigma^2 + 1e-3) term makes a funnel in
# sigma; N(0, 1) starting positions reach log sigma ~ -3, six prior sd out,
# where at the default 0.8 the adapted step is unstable: a chain that
# warmup leaves there diverges at every transition (five of 64 chains in a
# run of this script at 0.8 on the H100). The JAX package's sampler strands
# chains there too (tests/test_torch_funnel.py, run as a script, counts
# them in either package). The smaller steps of 0.95 keep warmup from
# stranding chains there.
CHAINS, WARMUP, KEPT, MAX_DEPTH, TARGET_ACCEPT = 64, 300, 200, 8, 0.95

failures = []


def check(name, got, ref, rtol, scale=None):
    """Record got vs ref: |got - ref| <= rtol * scale elementwise (scale
    defaults to |ref| + 1e-3 max|ref|). Returns the max absolute error."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        failures.append(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        return float("inf")
    if scale is None:
        scale = ref.abs() + 1e-3 * ref.abs().max()
    err = (got - ref).abs()
    ratio = float((err / scale).max())
    max_abs = float(err.max())
    ok = bool(torch.isfinite(got).all()) and ratio <= rtol
    print(f"{name}: max_abs_err {max_abs:.3e} max_rel_err {ratio:.3e} rtol {rtol:g}"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"{name}: rel err {ratio:.3e} > {rtol:g}")
    return max_abs


def expect(name, cond):
    print(f"{name}: {'ok' if cond else 'FAIL'}", flush=True)
    if not cond:
        failures.append(name)


def bench_model(dists, device, dtype):
    """bench.py's model, same parameters."""
    kw = dict(device=device, dtype=dtype)
    return dists.NamedProduct.of(
        mu=dists.IIDProduct(dists.Normal(0.0, 2.0, **kw), 8),
        sigma=dists.IIDProduct(dists.LogNormal(0.0, 0.5, **kw), 8),
        w=dists.Dirichlet(np.ones(16), **kw),
        corr=dists.LKJ(16, 2.0, **kw),
    )


def hier_loglik_and_counts(dev):
    """The sampler run's likelihood (user code): the flagship likelihood of
    __graft_entry__.py at the bench widths, with a data-weighted sum over
    the correlation matrix in place of its constant trace. Its data come
    from numpy seed 1. Returns (loglik, counts): the `w` block's posterior
    is Dirichlet(1 + counts) up to the likelihood's 1e-8."""
    rng = np.random.default_rng(1)
    f32 = dict(dtype=torch.float32, device=dev)
    ybar = torch.as_tensor(rng.standard_normal(8), **f32)
    counts = rng.multinomial(200, np.full(16, 1 / 16))
    A = rng.standard_normal((16, 16))
    S = torch.as_tensor(0.05 * (A + A.T), **f32)
    c = torch.as_tensor(counts, **f32)

    def hier_loglik(x):
        return (
            -0.5 * torch.sum((ybar - x["mu"]) ** 2 / (x["sigma"] ** 2 + 1e-3))
            + torch.sum(c * torch.log(x["w"] + 1e-8))
            + torch.sum(S * x["corr"])
        )

    return hier_loglik, counts


def vjp(fn, y, cts):
    """d sum_i <ct_i, fn(y)_i> / dy by autograd, in y's layout."""
    v = y.detach().requires_grad_(True)
    loss = sum(torch.sum(o * c) for o, c in zip(fn(v), cts))
    return torch.autograd.grad(loss, v)[0]


def digest(ts):
    """The first 16 hex digits of the sha256 of the tensors' bytes (None
    entries skipped)."""
    h = hashlib.sha256()
    for t in ts:
        if t is not None:
            h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_ms(fn, reps=25, inner=10, warmup=5, device_only=True):
    """Median over `reps` CUDA-event timings of `inner` back-to-back calls.
    With `device_only` the card spins (about 2.5 ms) while the host
    enqueues the calls, so the window holds card time only; without it the
    host's dispatch time counts too (what a caller of an entry point sees)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def time_slow_ms(fn, device_only=True):
    """time_ms with fewer repetitions, for calls of a millisecond or more
    (the plain versions, the host-bound entry points)."""
    return time_ms(fn, reps=5, inner=5, warmup=2, device_only=device_only)


W_ROWS = slice(16, 31)  # the Dirichlet(16) leaf's 15 linked rows
C_ROWS = slice(31, 151)  # the LKJ(16) leaf's 120 linked rows
X_ROWS = slice(0, 16)  # the simplex points' rows of `simplex_points_T`


def layouts(xT, rows, n, first):
    """The `rows` of a (D, N) transposed state at batch n in the three
    layouts the link kernels read, keyed by name, the one the path reads
    (`first`) first: the slice of the batch-major (n, D) state, a
    contiguous (n, P) tensor, and the swapped view of the (D, n) state."""
    make = {
        "batch-major slice": lambda: xT[:, :n].T.contiguous()[:, rows],
        "contiguous": lambda: xT[rows, :n].T.contiguous(),
        "swapped": lambda: xT[rows, :n].T,
    }
    return {k: make[k]() for k in (first, *(k for k in make if k != first))}


def simplex_points_T(vT):
    """(151, B): rows X_ROWS hold the simplex points x (16, B) of vT's
    simplex rows, by the plain inverse; the simplex forward link's input."""
    from tpu_bijectors_torch.kernels import simplex as ks

    xT = torch.zeros_like(vT)
    xT[X_ROWS] = ks.simplex_inverse_plain(vT[W_ROWS].T.contiguous()).T
    return xT


def check_link_kernels(dev, vT, vxT, counts):
    """The simplex and LKJ kernels against their plain versions, and their
    closed-form backward against autograd through the plain versions: in
    the three `layouts` at B = 131072 and at the samplers' 64 chains (the
    transposed leapfrog reads the swapped view, the batch-major one the
    slice; 64 is a partial block of every kernel), and on `constrain`'s
    strided slices of the (200, 64, dim) draws; and finite outputs and
    gradients at 1e10 states. Returns the max absolute error of each
    kernel."""
    from tpu_bijectors_torch.bijectors.corr import _vec_corr_inverse_all
    from tpu_bijectors_torch.bijectors.simplex import _simplex_inverse_logdet_wlog
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import simplex as ks

    am1 = torch.as_tensor(counts, dtype=torch.float32, device=dev)  # wlog != 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = {"simplex_inverse_logdet": 0.0, "lkj_inverse": 0.0}

    def rel(t):
        return t.abs() + 1e-3 * t.abs().max()

    def one(t):
        return torch.ones_like(t)

    draws = vT[:, : KEPT * CHAINS].T.contiguous().reshape(KEPT, CHAINS, -1)
    cases = {}  # tag: (simplex y, LKJ y)
    for n in (vT.shape[1], CHAINS):
        lkj = layouts(vT, C_ROWS, n, "swapped")
        for lay, y in layouts(vT, W_ROWS, n, "swapped").items():
            cases[f"{lay}, B = {n}"] = (y, lkj[lay])
    cases[f"draws' slices, B = {KEPT * CHAINS}"] = (
        draws[..., W_ROWS].reshape(-1, 15), draws[..., C_ROWS].reshape(-1, 120)
    )
    for lay, (y, yc) in cases.items():
        xk, ldk, wlk = ks.simplex_inverse_logdet(y, am1)
        xp, ldp, wlp = ks.simplex_inverse_logdet_plain(y, am1)
        e = err["simplex_inverse_logdet"]
        e = max(e, check(f"simplex x vs plain ({lay})", xk, xp, ATOL_UNIT, one(xp)))
        e = max(e, check(f"simplex ld vs plain ({lay})", ldk, ldp, RTOL_SUM, rel(ldp)))
        e = max(e, check(f"simplex wlog vs plain ({lay})", wlk, wlp, RTOL_SUM, rel(wlp)))
        xn, ldn, _ = ks.simplex_inverse_logdet(y, None, want_x=False)
        expect(f"simplex without x or wlog gives the same ld ({lay})",
               xn is None and torch.equal(ldn, ldk))
        err["simplex_inverse_logdet"] = e

        Xk, ljk, dwk, Wk = kl.lkj_inverse(yc, 16, want_w=True)
        Xp, ljp, dwp, Wp = kl.lkj_inverse_plain(yc, 16, want_w=True)
        e = err["lkj_inverse"]
        e = max(e, check(f"lkj X vs plain ({lay})", Xk, Xp, ATOL_UNIT, one(Xp)))
        e = max(e, check(f"lkj W vs plain ({lay})", Wk, Wp, ATOL_UNIT, one(Wp)))
        e = max(e, check(f"lkj logJ vs plain ({lay})", ljk, ljp, RTOL_SUM, rel(ljp)))
        e = max(e, check(f"lkj log diag W vs plain ({lay})", dwk, dwp, RTOL_SUM, rel(dwp)))
        Xn, ljn, _, Wn = kl.lkj_inverse(yc, 16)
        expect(f"lkj without W gives the same X and logJ ({lay})",
               Wn is None and torch.equal(Xn, Xk) and torch.equal(ljn, ljk))
        expect(f"lkj X exactly symmetric ({lay})", torch.equal(Xk, Xk.mT))
        err["lkj_inverse"] = e

        # backward: the closed form (kernel forward) against autograd
        # through the plain version, on the same card and inputs
        n = y.shape[0]
        cts = (torch.randn((n, 16), generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev))
        g_k = vjp(lambda v: _simplex_inverse_logdet_wlog(v, am1), y, cts)
        g_p = vjp(lambda v: ks.simplex_inverse_logdet_plain(v, am1), y, cts)
        check(f"simplex backward vs autograd of plain ({lay})", g_k, g_p, RTOL_VJP)
        cts = (torch.randn((n, 16, 16), generator=gen, device=dev),
               torch.randn(n, generator=gen, device=dev),
               torch.randn((n, 16), generator=gen, device=dev))
        g_k = vjp(_vec_corr_inverse_all, yc, cts)
        g_p = vjp(lambda v: kl.lkj_inverse_plain(v, 16)[:3], yc, cts)
        check(f"lkj backward vs autograd of plain ({lay})", g_k, g_p, RTOL_VJP)
        del xk, xp, Xk, Xp, Wk, Wp, g_k, g_p, cts
    del draws

    # 1e10 states: finite outputs that agree with the plain versions, and
    # a finite backward
    y, yc = vxT[W_ROWS].T, vxT[C_ROWS].T
    outs = ks.simplex_inverse_logdet(y, am1)
    expect("simplex outputs finite at 1e10", all(bool(torch.isfinite(t).all()) for t in outs))
    for got, ref, nm in zip(outs, ks.simplex_inverse_logdet_plain(y, am1), ("x", "ld", "wlog")):
        check(f"1e10: simplex {nm} vs plain", got, ref, RTOL_SUM, rel(ref) + 1e-6)
    outs = kl.lkj_inverse(yc, 16, want_w=True)
    expect("lkj outputs finite at 1e10", all(bool(torch.isfinite(t).all()) for t in outs))
    for got, ref, nm in zip(outs, kl.lkj_inverse_plain(yc, 16, True), ("X", "logJ", "ldw", "W")):
        check(f"1e10: lkj {nm} vs plain", got, ref, RTOL_SUM, rel(ref) + 1e-6)
    B = y.shape[0]
    g = vjp(lambda v: _simplex_inverse_logdet_wlog(v, am1), y,
            (torch.ones((B, 16), device=dev), torch.ones(B, device=dev),
             torch.ones(B, device=dev)))
    expect("simplex backward finite at 1e10", bool(torch.isfinite(g).all()))
    g = vjp(_vec_corr_inverse_all, yc,
            (torch.ones((B, 16, 16), device=dev), torch.ones(B, device=dev),
             torch.ones((B, 16), device=dev)))
    expect("lkj backward finite at 1e10", bool(torch.isfinite(g).all()))
    return err


def launched(what, fn, names):
    """Expect one call of fn to launch each kernel of `names`."""
    from tpu_bijectors_torch import kernels

    kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    got = {k: kernels.LAUNCHES[k] for k in names}
    expect(f"{what} launches {names}: {got}", all(n > 0 for n in got.values()))


def check_link_entry_points(dev, vT, loglik, counts):
    """from_linked_vec, Model.constrain, Dirichlet.fused_linked_logdensity
    and the likelihood term of value_and_grad_fn each launch the link
    kernels on a CUDA state; the likelihood model's value and gradient agree
    with its float64 plain version on the CPU."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.bijectors import SimplexBijector

    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    u, dim = model.unconstrainer(), model.dim()
    v64 = vT[:, :64].T.contiguous()  # 64 batch-major states
    f = model.batched_logdensity_t_fn()

    links = (SIMPLEX_SMALL, "lkj_inverse")
    launched("from_linked_vec", lambda: u.from_linked_vec(v64), links)
    launched("Model.constrain of (4, 16, dim) draws",
             lambda: model.constrain(v64.reshape(4, 16, dim)), links)
    w = dists.Dirichlet(np.ones(16), device=dev, dtype=torch.float32)
    launched("Dirichlet.fused_linked_logdensity",
             lambda: w.fused_linked_logdensity(SimplexBijector(), v64[:, W_ROWS], False),
             links[:1])
    launched("value_and_grad_fn with the likelihood",
             lambda: f.value_and_grad_fn(v64.T.contiguous()),
             (SMALL,) + links)

    # the likelihood model in float32 on the card against float64 on the
    # CPU, at the leapfrog's batch of 64 chains and at 4096
    ll_cpu, _ = hier_loglik_and_counts("cpu")  # the same float32 data
    cpu = tbt.Model(bench_model(dists, "cpu", torch.float64), loglik=ll_cpu, device="cpu")
    for n in (CHAINS, 4096):
        vs = vT[:, :n].contiguous()
        lp, g = f.value_and_grad_fn(vs)
        lp64, g64 = cpu.batched_logdensity_t_fn().value_and_grad_fn(vs.double().cpu())
        check(f"likelihood model lp vs float64 CPU, B = {n}", lp.cpu(), lp64, 2e-5,
              lp64.abs() + 1e-3 * lp64.abs().max())
        # a gradient entry is a float32 sum of terms as large as the largest
        # entry (counts / w through the stick-breaking Jacobian), so its
        # error scales with max |g|
        check(f"likelihood model g vs float64 CPU, B = {n}", g.cpu(), g64, 1e-4,
              g64.abs() + 1e-2 * g64.abs().max())


SIMPLEX_KS = (2, 3, 16, 17, 33, 128)


def simplex_bs():
    """The batches #7 and #8 are checked at: around the half-warp and warp
    edges, the samplers' 64 chains and a partial tile, the crossover
    SMALL_B of kernels/simplex.py and one past it, and B = 131072."""
    from tpu_bijectors_torch.kernels import simplex as ks

    return (1, 15, 16, 17, 31, 32, 33, 64, 65, 200, ks.SMALL_B, ks.SMALL_B + 1, BATCH)


def check_simplex_designs(dev, vT, vxT):
    """#7 and #8 in the design their wrappers pick (`simplex_design`) at
    `simplex_bs()` and K in SIMPLEX_KS (y: the first K-1 rows of vT), in the
    three `layouts`, with Dirichlet weights am1 (numpy seed K): x within
    ATOL_UNIT of the sequential plain version (the kernels' recurrence; from
    K = 128 on the plain version's default is the scan, which path 25
    holds #7 to), ld and wlog within RTOL_SUM of their
    magnitude; x, ld and wlog bit for bit on a second launch; x the same
    bit for bit as #8's and as the other design's, and ld the same without
    x or wlog. Then both designs at K = 600 and 29100, past each design's
    shared memory, and the 1e10 states of `check_link_kernels`: finite and
    within RTOL_SUM of the plain version. Returns the max absolute error of
    each design (and of #8) against the plain version at the paths' K = 16
    (ld and wlog, sums of K terms, carry errors that grow with K)."""
    from tpu_bijectors_torch.kernels import simplex as ks

    err = {"simplex_inverse_logdet": 0.0, SIMPLEX_SMALL: 0.0, "simplex_inverse": 0.0}

    def rel(t):
        return t.abs() + 1e-3 * t.abs().max()

    for K in SIMPLEX_KS:
        am1 = torch.as_tensor(np.random.default_rng(K).uniform(0.0, 3.0, K),
                              dtype=torch.float32, device=dev)
        for B in simplex_bs():
            design = ks.simplex_design(B)
            key = SIMPLEX_SMALL if design == "small" else "simplex_inverse_logdet"
            for lay, y in layouts(vT, slice(0, K - 1), B, "swapped").items():
                tag = f"simplex {design} design, K = {K} ({lay}, B = {B})"
                x, ld, wl = ks.simplex_inverse_logdet(y, am1)
                xp, ldp, wlp = ks.simplex_inverse_logdet_plain(y, am1, method="sequential")
                e = max(check(f"{tag} x vs plain", x, xp, ATOL_UNIT, torch.ones_like(xp)),
                        check(f"{tag} ld vs plain", ld, ldp, RTOL_SUM, rel(ldp)),
                        check(f"{tag} wlog vs plain", wl, wlp, RTOL_SUM, rel(wlp)))
                x2, ld2, wl2 = ks.simplex_inverse_logdet(y, am1)
                expect(f"{tag}: a second launch gives x, ld and wlog bit for bit",
                       torch.equal(x, x2) and torch.equal(ld, ld2) and torch.equal(wl, wl2))
                x8 = ks.simplex_inverse(y)
                if K == 16:  # the paths' K: the errors the kernels line reports
                    err[key] = max(err[key], e)
                    err["simplex_inverse"] = max(err["simplex_inverse"],
                                                 float((x8 - xp).abs().max()))
                other = "wide" if design == "small" else "small"
                expect(f"{tag}: x equals #8's and the {other} design's bit for bit",
                       torch.equal(x, x8)
                       and torch.equal(x, ks.simplex_inverse_logdet(y, am1, design=other)[0]))
                xn, ldn, wn = ks.simplex_inverse_logdet(y, None, want_x=False)
                expect(f"{tag}: ld without x or wlog is the same",
                       xn is None and wn is None and torch.equal(ldn, ld))
    # K past the shared memory of each design: at K = 600 a block of 32
    # elements of the wide design does not fit, and the group design serves
    # it; at K = 29100 one element's y does not fit either, and the group
    # design reads y from device memory (0.5 N(0, 1), the card's generator)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for K, B in ((600, 65), (600, ks.SMALL_B + 1), (29100, 65)):
        y = 0.5 * torch.randn((B, K - 1), generator=gen, device=dev)
        am1 = torch.ones(K, device=dev)
        xp, ldp, wlp = ks.simplex_inverse_logdet_plain(y, am1, method="sequential")
        for design in ks.DESIGNS:
            tag = f"simplex {design} design, K = {K} (contiguous, B = {B})"
            x, ld, wl = ks.simplex_inverse_logdet(y, am1, design=design)
            check(f"{tag} x vs plain", x, xp, ATOL_UNIT, torch.ones_like(xp))
            check(f"{tag} ld vs plain", ld, ldp, RTOL_SUM, rel(ldp))
            check(f"{tag} wlog vs plain", wl, wlp, RTOL_SUM, rel(wlp))
            expect(f"{tag}: x equals #8's bit for bit",
                   torch.equal(x, ks.simplex_inverse(y, design=design)))
        del y, xp
    y = vxT[W_ROWS].T
    am1 = torch.ones(16, device=dev)
    ref = ks.simplex_inverse_logdet_plain(y, am1)
    for design in ks.DESIGNS:
        outs = ks.simplex_inverse_logdet(y, am1, design=design)
        expect(f"1e10: simplex {design} design outputs finite",
               all(bool(torch.isfinite(t).all()) for t in outs))
        for got, r, nm in zip(outs, ref, ("x", "ld", "wlog")):
            check(f"1e10: simplex {design} design {nm} vs plain", got, r, RTOL_SUM,
                  rel(r) + 1e-6)
    return err


def face_points(rng, n):
    """Simplex points (n, 16) on the simplex's faces, where 1e10 states
    put the inverse: vertices and points with 2 or 3 nonzero coordinates,
    with dyadic masses so that every prefix sum is exact (the images of
    1e10 states carry 1e-32 remainders beside a prefix sum of 1, where the
    forward link is infinite in the kernel and its plain version alike)."""
    x = np.zeros((n, 16))
    masses = ([1.0], [0.5, 0.5], [0.5, 0.25, 0.25])
    for r in range(n):
        m = masses[rng.integers(0, 3)]
        x[r, rng.choice(16, len(m), replace=False)] = m
    return x


def check_batch_major_kernels(dev, vT, xT, vxT, xfaces):
    """The LKJ log-det kernel (both variants), the x-only simplex inverse
    and the simplex forward kernel against their plain versions, and their
    closed-form backward against autograd through the plain versions: at
    B = 131072, 64 and 1000 (a partial block), each in the batch-major
    slice of a (B, 151) state, a contiguous (B, P) tensor, and the swapped
    view of the (dim, B) state (`layouts`; the forward kernel on the
    simplex points of `xT`); and at 1e10 states (the forward kernel at
    points on the simplex's faces). Returns the max absolute error of each
    kernel."""
    from tpu_bijectors_torch.bijectors import SimplexBijector
    from tpu_bijectors_torch.bijectors.corr import _lkj_logdet_all
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import simplex as ks

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    err = {k: 0.0 for k in BATCH_MAJOR_KERNELS}

    def rel(t):
        return t.abs() + 1e-3 * t.abs().max()

    def one(t):
        return torch.ones_like(t)

    def tagged(xT, rows, n):
        return ((f"{lay}, B = {n}", y)
                for lay, y in layouts(xT, rows, n, "batch-major slice").items())

    for n in (vT.shape[1], CHAINS, 1000):
        for lay, yc in tagged(vT, C_ROWS, n):
            for chol in (False, True):
                tag = f"lkj_logdet chol={chol} ({lay})"
                got = kl.lkj_logdet(yc, 16, chol)
                ref = kl.lkj_logdet_plain(yc, 16, chol)
                e = err["lkj_logdet"]
                e = max(e, check(f"{tag} logJ vs plain", got[0], ref[0], RTOL_SUM, rel(ref[0])))
                e = max(e, check(f"{tag} log diag W vs plain", got[1], ref[1], RTOL_SUM,
                                 rel(ref[1])))
                err["lkj_logdet"] = e
                if not chol:  # the inverse-link kernel's logJ, the same sums
                    lj_inv = kl.lkj_inverse(yc, 16)[1]
                    check(f"{tag} logJ vs lkj_inverse's", got[0], lj_inv, RTOL_SUM, rel(lj_inv))
                cts = (torch.randn(n, generator=gen, device=dev),
                       torch.randn((n, 16), generator=gen, device=dev))
                check(f"{tag} backward vs autograd of plain",
                      vjp(lambda v, c=chol: _lkj_logdet_all(v, c), yc, cts),
                      vjp(lambda v, c=chol: kl.lkj_logdet_plain(v, 16, c), yc, cts), RTOL_VJP)
        for lay, y in tagged(vT, W_ROWS, n):
            x = ks.simplex_inverse(y)
            xp = ks.simplex_inverse_plain(y)
            err["simplex_inverse"] = max(err["simplex_inverse"], check(
                f"simplex_inverse x vs plain ({lay})", x, xp, ATOL_UNIT, one(xp)))
            x7 = ks.simplex_inverse_logdet(y)[0]
            expect(f"simplex_inverse x equals simplex_inverse_logdet's bit for bit ({lay})",
                   torch.equal(x, x7))
            ct = (torch.randn((n, 16), generator=gen, device=dev),)
            check(f"simplex_inverse backward vs autograd of plain ({lay})",
                  vjp(lambda v: (SimplexBijector().inverse(v),), y, ct),
                  vjp(lambda v: (ks.simplex_inverse_plain(v),), y, ct), RTOL_VJP)
        for lay, x in tagged(xT, X_ROWS, n):
            got = ks.simplex_forward_logdet(x)
            ref = ks.simplex_forward_logdet_plain(x)
            e = err["simplex_forward_logdet"]
            e = max(e, check(f"simplex_forward y vs plain ({lay})", got[0], ref[0], ATOL_LOGIT,
                             one(ref[0])))
            e = max(e, check(f"simplex_forward ld vs plain ({lay})", got[1], ref[1], RTOL_SUM,
                             rel(ref[1])))
            err["simplex_forward_logdet"] = e
            cts = (torch.randn((n, 15), generator=gen, device=dev),
                   torch.randn(n, generator=gen, device=dev))
            check(f"simplex_forward backward vs autograd of plain ({lay})",
                  vjp(SimplexBijector().forward_and_log_det, x, cts),
                  vjp(ks.simplex_forward_logdet_plain, x, cts), RTOL_VJP)

    # 1e10 states (and points on the simplex's faces for the forward link):
    # finite outputs that agree with the plain versions, finite backward
    yc, y = vxT[C_ROWS].T, vxT[W_ROWS].T
    for chol in (False, True):
        outs = kl.lkj_logdet(yc, 16, chol)
        expect(f"1e10: lkj_logdet chol={chol} finite",
               all(bool(torch.isfinite(t).all()) for t in outs))
        for got, ref, nm in zip(outs, kl.lkj_logdet_plain(yc, 16, chol), ("logJ", "ldw")):
            check(f"1e10: lkj_logdet chol={chol} {nm} vs plain", got, ref, RTOL_SUM,
                  rel(ref) + 1e-6)
        g = vjp(lambda v, c=chol: _lkj_logdet_all(v, c), yc,
                (torch.ones(yc.shape[0], device=dev), torch.ones((yc.shape[0], 16), device=dev)))
        expect(f"1e10: lkj_logdet chol={chol} backward finite", bool(torch.isfinite(g).all()))
    x = ks.simplex_inverse(y)
    check("1e10: simplex_inverse x vs plain", x, ks.simplex_inverse_plain(y), ATOL_UNIT, one(x))
    g = vjp(lambda v: (SimplexBijector().inverse(v),), y, (torch.ones_like(x),))
    expect("1e10: simplex_inverse backward finite", bool(torch.isfinite(g).all()))
    xf = torch.as_tensor(xfaces, dtype=torch.float32, device=dev)
    outs = ks.simplex_forward_logdet(xf)
    expect("faces: simplex_forward finite", all(bool(torch.isfinite(t).all()) for t in outs))
    ref = ks.simplex_forward_logdet_plain(xf)
    check("faces: simplex_forward y vs plain", outs[0], ref[0], ATOL_LOGIT, one(ref[0]))
    check("faces: simplex_forward ld vs plain", outs[1], ref[1], RTOL_SUM, rel(ref[1]) + 1e-6)
    g = vjp(SimplexBijector().forward_and_log_det, xf,
            (torch.ones((xf.shape[0], 15), device=dev), torch.ones(xf.shape[0], device=dev)))
    expect("faces: simplex_forward backward finite", bool(torch.isfinite(g).all()))
    return err


LOGDET_BS = (1, 31, 64, 65, 1000, BATCH)
LKJ_LOGDET_KS = (2, 3, 5, 16, 17, 64, 200, 400)
# beyond every design's shared memory at one element: the direct design
# (and #9's above K = 606)
FWD_LOGDET_KS = SIMPLEX_KS + (700,)


def logdet_rtol(P):
    """#5's tolerance against its plain version at P slots an element:
    RTOL_SUM holds at the paths' K = 16 (120 slots); the rounding of the
    float32 running sums, the kernel's and the plain version's alike, grows
    as the square root of their terms (logJ sums P of them; 1.5e-5 at
    K = 400 on the H100 against RTOL_SUM's 1e-5)."""
    return RTOL_SUM * max(1.0, math.sqrt(P / 120))


def logdet_bs(P):
    """The batches #5 and #9 are checked at for P slots an element: all of
    LOGDET_BS while the plain version's (B, K, K) intermediates stay small,
    up to 1000 beyond (K = 200 and 400)."""
    return tuple(b for b in LOGDET_BS if b <= 1000 or P <= 2016)


def simplex_points_state(dev, K, B, seed):
    """A transposed (K + 9, B) state whose rows 4 .. 4 + K hold simplex
    points: the sequential plain inverse of 0.5 N(0, 1) states (numpy
    seed), as `simplex_points_T` makes them for K = 16."""
    from tpu_bijectors_torch.kernels import simplex as ks

    y = torch.as_tensor(0.5 * np.random.default_rng(seed).standard_normal((B, K - 1)),
                        dtype=torch.float32, device=dev)
    st = torch.zeros((K + 9, B), device=dev)
    st[4 : 4 + K] = ks.simplex_inverse_plain(y, method="sequential").T
    return st


def fwd_y_scale(x):
    """Per entry of y, the conditioning of y_k = logit(z_k) + log(K-1-k) in
    the prefix sum s_k: 1 / max(1 - s_k, eps) (float64), at least 1. The
    kernel's running sum and the plain version's cumsum round s_k apart, and
    y carries that difference times this factor; ATOL_LOGIT of it is held."""
    x = x.double()
    s = torch.cumsum(x, dim=1) - x
    return 1.0 / torch.clamp(1.0 - s[:, :-1], min=float(np.finfo(np.float32).eps))


def check_link_logdets(dev, vT, xT, vxT, xfaces):
    """#5 (both variants) and #9 in the designs their C entries pick
    (`csrc/lkj_logdet.cu`: the direct design unrolled for K <= 8, the
    staged design below 32768 elements, the direct design with its loads
    ahead above; `csrc/simplex_fwd.cu`: the staged design from 1024
    elements, the direct one below) against their plain versions: #5 at
    LKJ_LOGDET_KS, #9 at FWD_LOGDET_KS, each at `logdet_bs` in the three
    `layouts`, logJ and log diag W within `logdet_rtol` and ld within
    RTOL_SUM of their magnitude,
    y within ATOL_LOGIT of `fwd_y_scale`, every output bit for bit on a
    second launch; and at 1e10 (#5 at every K, B = 1000) and the faces of
    the simplex (#9 at K = 16), finite and within RTOL_SUM. The states: vT's
    LKJ rows and xT's simplex points at K = 16, else 0.5 N(0, 1) states
    made on the card from their own generator (and simplex points from
    numpy seed K). Returns the max absolute error of each kernel at the
    paths' K (16; LKJCholesky's 5 for lkj_logdet_chol)."""
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import simplex as ks

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    err = {"lkj_logdet": 0.0, "lkj_logdet_chol": 0.0, "simplex_forward_logdet": 0.0}

    def rel(t):
        return t.abs() + 1e-3 * t.abs().max()

    for K in LKJ_LOGDET_KS:
        P = K * (K - 1) // 2
        bs = logdet_bs(P)
        if K == 16:
            state, rows = vT, C_ROWS
        else:
            state = 0.5 * torch.randn((P + 9, max(bs)), generator=gen, device=dev)
            rows = slice(4, 4 + P)
        for B in bs:
            for lay, y in layouts(state, rows, B, "batch-major slice").items():
                for chol in (False, True):
                    tag = f"lkj_logdet chol={chol}, K = {K} ({lay}, B = {B})"
                    got = kl.lkj_logdet(y, K, chol)
                    ref = kl.lkj_logdet_plain(y, K, chol)
                    e = max(check(f"{tag} logJ vs plain", got[0], ref[0], logdet_rtol(P),
                                  rel(ref[0])),
                            check(f"{tag} log diag W vs plain", got[1], ref[1], logdet_rtol(P),
                                  rel(ref[1])))
                    again = kl.lkj_logdet(y, K, chol)
                    expect(f"{tag}: a second launch gives logJ and log diag W bit for bit",
                           torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
                    key = "lkj_logdet_chol" if chol else "lkj_logdet"
                    if K == (5 if chol else 16):
                        err[key] = max(err[key], e)
                    del got, ref, again
            del y
        # 1e10 states: every slot's logcosh is |y| - log 2
        yx = 1e10 * torch.randn((1000, P), generator=gen, device=dev) if K != 16 else vxT[C_ROWS].T
        for chol in (False, True):
            outs = kl.lkj_logdet(yx, K, chol)
            expect(f"1e10: lkj_logdet chol={chol}, K = {K} finite",
                   all(bool(torch.isfinite(t).all()) for t in outs))
            for got, r, nm in zip(outs, kl.lkj_logdet_plain(yx, K, chol), ("logJ", "ldw")):
                check(f"1e10: lkj_logdet chol={chol}, K = {K} {nm} vs plain", got, r,
                      logdet_rtol(P), rel(r) + 1e-6)
        del state, yx

    for K in FWD_LOGDET_KS:
        bs = logdet_bs(K)
        if K == 16:
            state, rows = xT, X_ROWS
        else:
            state, rows = simplex_points_state(dev, K, max(bs), K), slice(4, 4 + K)
        for B in bs:
            for lay, x in layouts(state, rows, B, "contiguous").items():
                tag = f"simplex_forward K = {K} ({lay}, B = {B})"
                y, ld = ks.simplex_forward_logdet(x)
                yp, ldp = ks.simplex_forward_logdet_plain(x)
                e = max(check(f"{tag} y vs plain", y, yp, ATOL_LOGIT, fwd_y_scale(x)),
                        check(f"{tag} ld vs plain", ld, ldp, RTOL_SUM, rel(ldp)))
                y2, ld2 = ks.simplex_forward_logdet(x)
                expect(f"{tag}: a second launch gives y and ld bit for bit",
                       torch.equal(y, y2) and torch.equal(ld, ld2))
                if K == 16:
                    err["simplex_forward_logdet"] = max(err["simplex_forward_logdet"], e)
        del state
    xf = torch.as_tensor(xfaces, dtype=torch.float32, device=dev)
    for B in LOGDET_BS[:-1] + (4096,):
        outs = ks.simplex_forward_logdet(xf[:B])
        expect(f"faces: simplex_forward finite (B = {B})",
               all(bool(torch.isfinite(t).all()) for t in outs))
        ref = ks.simplex_forward_logdet_plain(xf[:B])
        check(f"faces: simplex_forward y vs plain (B = {B})", outs[0], ref[0], ATOL_LOGIT,
              torch.ones_like(ref[0]))
        check(f"faces: simplex_forward ld vs plain (B = {B})", outs[1], ref[1], RTOL_SUM,
              rel(ref[1]) + 1e-6)
    return err


def run_batch_major_serving(dev, vT, scale, loglik):
    """Path 3: the batch-major entry points on (B, 151) states, with the
    launch counters zeroed just before and read just after. Checks the
    density against the fused transposed one of the same states and
    against the float64 plain path on the CPU, its gradient against
    float64, the round trip v -> x -> v and the log-det's sign, the
    classic inverse link both ways, and the likelihood model at 64 states
    against float64. Returns (launches, the entry points' times)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels

    model = tbt.Model(bench_model(dists, dev, torch.float32), device=dev)
    u = model.unconstrainer()
    lik = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    v = vT.T.contiguous()  # (B, 151), batch-major
    v64 = v[:CHAINS].contiguous()
    f, fl = model.batched_logdensity_fn(), lik.batched_logdensity_fn()
    dirichlet = dists.Dirichlet(np.ones(16), device=dev, dtype=torch.float32)
    ib = tbt.inverse(tbt.bijector(dirichlet))

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(v)
    lp_vg, g = f.value_and_grad_fn(v)
    x, ld = u.from_linked_vec(v)
    v2, ld2 = u.to_linked_vec(x)
    xw = ib.forward(v[:, W_ROWS])  # the x-only simplex inverse
    yw, ldw = ib.inverse_and_log_det(xw)  # the simplex forward link
    lpl, gl = fl.value_and_grad_fn(v64)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the batch-major serving path: {launches}", flush=True)
    for k in BATCH_MAJOR_KERNELS + LINK_KERNELS:
        expect(f"{k} launched on the batch-major serving path", launches[k] > 0)

    expect("batch-major lp (B,) and g (B, 151)",
           lp.shape == (BATCH,) and g.shape == (BATCH, 151))
    check("batch-major lp vs value_and_grad_fn lp", lp_vg, lp, RTOL_LP, scale)
    # the fused kernel's Dirichlet is un-nudged, the composed one nudged
    # (docs/kernels.md:170-183); at alpha = 1 the nudge's weights are 0
    lp_t, g_t = model.batched_logdensity_t_fn().value_and_grad_fn(vT)
    check("batch-major lp vs fused transposed lp", lp, lp_t, RTOL_COMPOSED, scale)
    check("batch-major g vs fused transposed g", g, g_t.T, RTOL_VJP,
          g_t.abs().T + 1e-2 * g_t.abs().max())
    rows = slice(0, 4096)
    cpu = tbt.Model(bench_model(dists, "cpu", torch.float64), device="cpu")
    lp64, g64 = cpu.batched_logdensity_fn().value_and_grad_fn(v[rows].double().cpu())
    check("batch-major lp vs float64 CPU, 4096 rows", lp[rows].cpu(), lp64, RTOL_COMPOSED,
          scale[rows].cpu())
    check("batch-major g vs float64 CPU, 4096 rows", g[rows].cpu(), g64, RTOL_VJP,
          g64.abs() + 1e-2 * g64.abs().max())
    del g_t, lp_t

    check("round trip v -> x -> v, scalar and simplex rows", v2[:, :31], v[:, :31],
          ATOL_ROUNDTRIP, torch.ones_like(v[:, :31]))
    # cuSOLVER's batched eigensolver refuses 131072 matrices: on the CPU
    ev = torch.linalg.eigvalsh(x["corr"].double().cpu())
    kappa = ev[:, -1] / ev[:, 0]
    row_err = (v2[:, C_ROWS] - v[:, C_ROWS]).abs().amax(dim=1).double().cpu()
    ratio = float((row_err / (kappa * np.finfo(np.float32).eps + ATOL_ROUNDTRIP)).max())
    print(f"round trip, LKJ rows: max row error {float(row_err.max()):.3e}, max kappa "
          f"{float(kappa.max()):.3e}, max error / (kappa eps32 + {ATOL_ROUNDTRIP:g}) "
          f"{ratio:.3e}", flush=True)
    expect("round trip v -> x -> v, LKJ rows within kappa(X) eps32", ratio <= 1.0)
    check("round trip: to_linked_vec's log-det is minus from_linked_vec's", ld2, -ld,
          RTOL_ROUNDTRIP_LD, ld.abs() + 1e-3 * ld.abs().max())
    expect("x-only inverse equals from_linked_vec's w bit for bit", torch.equal(xw, x["w"]))
    check("inverse(bijector(Dirichlet)) both ways: y", yw, v[:, W_ROWS], ATOL_ROUNDTRIP,
          torch.ones_like(yw))
    ldi = tbt.bijector(dirichlet).inverse_and_log_det(v[:, W_ROWS])[1]
    check("inverse(bijector(Dirichlet)) both ways: log-det", ldw, -ldi, RTOL_SUM,
          ldi.abs() + 1e-3 * ldi.abs().max())
    del x, v2, ev

    # the likelihood model at 64 states against float64 on the CPU
    ll_cpu, _ = hier_loglik_and_counts("cpu")
    cpu = tbt.Model(bench_model(dists, "cpu", torch.float64), loglik=ll_cpu, device="cpu")
    lp64, g64 = cpu.batched_logdensity_fn().value_and_grad_fn(v64.double().cpu())
    check("batch-major likelihood model lp vs float64 CPU, B = 64", lpl.cpu(), lp64, 2e-5,
          lp64.abs() + 1e-3 * lp64.abs().max())
    check("batch-major likelihood model g vs float64 CPU, B = 64", gl.cpu(), g64,
          RTOL_G_BATCH_MAJOR_LIK, g64.abs() + 1e-2 * g64.abs().max())

    # each entry point of the slice on its own, at 64 states
    lkj = u.children[u.names.index("corr")]
    launched("LeafUnconstrainer.linked_logdensity of the LKJ leaf",
             lambda: lkj.linked_logdensity(v64[:, C_ROWS]), ("lkj_logdet",))
    leaf_w = u.children[u.names.index("w")]
    w64 = leaf_w.from_linked_vec(v64[:, W_ROWS])[0]
    launched("to_linked_vec of the Dirichlet leaf", lambda: leaf_w.to_linked_vec(w64),
             ("simplex_forward_logdet",))
    launched("SimplexBijector.inverse", lambda: tbt.bijector(dirichlet).inverse(v64[:, W_ROWS]),
             ("simplex_inverse",))

    # the entry points as a caller sees them, host dispatch included
    e2e = {
        "batch_major_value_ms_B131072": time_slow_ms(lambda: f(v), device_only=False),
        "batch_major_value_and_grad_ms_B131072": time_slow_ms(
            lambda: f.value_and_grad_fn(v), device_only=False
        ),
        "batch_major_value_ms_B64": time_slow_ms(lambda: f(v64), device_only=False),
        "batch_major_value_and_grad_ms_B64": time_slow_ms(
            lambda: f.value_and_grad_fn(v64), device_only=False
        ),
        "batch_major_likelihood_value_and_grad_ms_B64": time_slow_ms(
            lambda: fl.value_and_grad_fn(v64), device_only=False
        ),
    }
    return launches, e2e


def run_sampler(dev, loglik, counts, kernel, init="random"):
    """A sampler path: NUTS on the bench model with the likelihood, with
    the transposed (`nuts_batched_t`) or the batch-major (`nuts_batched`)
    kernel, or the one kernel='auto' picks, driven through public entry
    points in two calls so that warmup and sampling are timed apart (each
    between torch.cuda.synchronize() calls): `Model.sample` with
    n_samples=0 runs the warmup (from `init`'s starts: its time includes
    the init's fit), and `resume_sampling` continues from its state (the
    draws an uninterrupted `Model.sample` would give); `Model.constrain`
    maps the linked draws. The launch counters are zeroed just before the
    first call and read after the last. Returns (the `sampler` line, the
    launches, the raw draws (KEPT, CHAINS, 151))."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, resume_sampling

    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    asked = kernel
    if kernel == "auto":
        kernel = model._auto_kernel()
        expect(f"kernel='auto' takes nuts_batched_t on the bench model (took {kernel})",
               kernel == "nuts_batched_t")
    transposed = kernel == "nuts_batched_t"
    # one launch per batched leapfrog: the fused value-and-gradient kernel
    # of the transposed density (its small design at 64 chains), the LKJ
    # inverse link of the batch-major one
    per_leapfrog = SMALL if transposed else "lkj_inverse"
    path = ((SMALL,) if transposed else ()) + (SIMPLEX_SMALL, "lkj_inverse")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    _, state, _ = model.sample(
        gen, n_chains=CHAINS, n_warmup=WARMUP, n_samples=0, max_depth=MAX_DEPTH,
        target_accept=TARGET_ACCEPT, constrained=False, kernel=asked, init=init,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, s1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    density = model.batched_logdensity_t_fn() if transposed else model.batched_logdensity_fn()
    raw, state, stats = resume_sampling(
        density, state, KEPT, kernel=kernel, max_depth=MAX_DEPTH,
    )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2, s2 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    samples = model.constrain(raw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    if init != "random":
        kernel = f"{kernel} (init={init})"
    print(f"launches on the {kernel} sampler path: {launches}", flush=True)
    for k in path:
        expect(f"{k} launched on the {kernel} sampler path", launches[k] > 0)

    during = {k: l2[k] - l1[k] for k in l2}
    leapfrogs = during[per_leapfrog]
    # both inverse links run once a batched leapfrog: #7 in its small design
    expect(f"{kernel}: {SIMPLEX_SMALL} launched by every batched leapfrog "
           f"({during[SIMPLEX_SMALL]}, lkj_inverse {during['lkj_inverse']}), "
           f"simplex_inverse_logdet by none ({during['simplex_inverse_logdet']})",
           during[SIMPLEX_SMALL] == during["lkj_inverse"] > 0
           and during["simplex_inverse_logdet"] == 0)
    sampling_s = t2 - t1
    expect(f"{kernel}: raw draws (200, 64, 151) and finite",
           tuple(raw.shape) == (KEPT, CHAINS, 151) and bool(torch.isfinite(raw).all()))
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    w = samples["w"]
    post = (1.0 + counts) / (16.0 + counts.sum())
    mcse = diagnostics.mcse_mean(w)
    dev_w = np.abs(w.double().mean(dim=(0, 1)).cpu().numpy() - post) / mcse
    n_div = int(stats.diverging.sum())
    line = {
        "kernel": kernel, "init": init,
        "chains": CHAINS, "warmup": WARMUP, "kept": KEPT, "max_depth": MAX_DEPTH,
        "target_accept": TARGET_ACCEPT,
        "warmup_s": t1 - t0,
        "sampling_s": sampling_s,
        "constrain_s": t3 - t2,
        "draws_per_s": CHAINS * KEPT / sampling_s,
        "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": (s2 - s1) / max(leapfrogs, 1),
        "step_size": float(state.eps),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "chains_with_divergences": int((stats.diverging.sum(0) > 0).sum()),
        "smallest_sigma_of_a_diverging_chain": (
            float(samples["sigma"][:, stats.diverging.any(0)].min()) if n_div else None
        ),
        "transitions": CHAINS * KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "min_ess_bulk": float(np.min(ess)),
        "max_w_dev_in_mcse": float(np.max(dev_w)),
    }
    expect(f"{kernel}: max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"{kernel}: divergences {n_div} <= 1% of {CHAINS * KEPT}",
           n_div <= 0.01 * CHAINS * KEPT)
    expect(f"{kernel}: w means within 5 MCSE of Dirichlet(1 + counts) "
           f"(max {np.max(dev_w):.2f})", bool(np.all(dev_w <= 5.0)))
    expect(f"{kernel}: constrained draws finite",
           all(bool(torch.isfinite(t).all()) for t in samples.values()))
    return line, launches, raw


# --- the Wishart families (the fourth slice) -----------------------------------

PD_K = 16
PD_ROWS = slice(0, 136)  # the Wishart leaf's packed rows of the PD models
PD_MODES = {"wishart": "dot", "invwishart": "solve"}
EPS32 = float(np.finfo(np.float32).eps)
# the pd_conjugate chains start at bench.py's 0.3 N(0, 1). From N(0, 1)
# starts (Model.sample's) the float32 sampler's warmup shrinks the step
# towards 0 and the chains do not mix; tests/test_torch_pd_witness.py, run
# as a script, samples this model from either start in either package and
# dtype (PERF.md section 7)
PD_INIT_SCALE = 0.3


def pd_model(dists, device, dtype, family, scale=None):
    """tools/mega_probe.py's `pdonly` (W = Wishart(18, I_16), m = 15 iid
    N(0, 1): linked dim 136 + 15 = 151), or its solve-mode twin with
    InverseWishart(18, I_16) for W; `scale` replaces I_16."""
    kw = dict(device=device, dtype=dtype)
    S = np.eye(PD_K) if scale is None else scale
    cls = dists.Wishart if family == "wishart" else dists.InverseWishart
    return dists.NamedProduct.of(
        W=cls(18.0, S, **kw), m=dists.IIDProduct(dists.Normal(0.0, 1.0, **kw), 15)
    )


def random_spd(seed, K=PD_K):
    """A K x K SPD matrix from numpy seed `seed` (eigenvalues above 1/2)."""
    A = np.random.default_rng(seed).standard_normal((K, K))
    return A @ A.T / K + 0.5 * np.eye(K)


def pd_c(S, mode):
    """The PD kernels' C for a scale S: S^-1 (dot), chol(S) (solve)."""
    return np.linalg.inv(S) if mode == "dot" else np.linalg.cholesky(S)


def pd_reference(y, C, mode):
    """Float64 references of the PD log-density pieces and the trace
    gradient for y (n, 136) and C, with the error a float32 result may
    carry, from the standard bounds of the sums and substitutions (eps =
    eps32, kappa = ||L||_F ||L^-1||_F per element, |.| elementwise):

      dot:   tr    within 2K eps sum_ab |C_ab| (|L| |L|')_ab
             g     within 2K eps 2 (|C| |L|)_rc (times L_rr on the diagonal)
      solve: tr    within 4K kappa eps tr   (a forward substitution)
             g     within 6K kappa eps 2 ||At||_F ||A||_F (times L_rr), two
                   substitutions and a product; the substitutions' bounds
                   are normwise, so a slot is held to the norms, not to
                   its own |At| |A'|

    K is C's. Returns (logJ, sumd, tr, g, tr_allow, g_allow, kappa)."""
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.utils import set_diag, tril_to_vec

    K = C.shape[-1]
    y64, C64 = y.double(), C.double()
    logJ, sumd, tr = kp.pd_logdensity_plain(y64, K, C64, mode)
    g = kp.pd_trace_grad_plain(y64, K, C64, mode)
    L, d = kp._unpack(y64, K)
    einv = torch.exp(-d)
    eye = torch.eye(K, dtype=torch.float64, device=y.device)
    kappa = torch.linalg.matrix_norm(L) * torch.linalg.matrix_norm(kp._forward_sub(L, einv, eye))

    def slots(M):
        return tril_to_vec(set_diag(M, torch.diagonal(M, dim1=-2, dim2=-1) * torch.exp(d)))

    if mode == "dot":
        Cs = (0.5 * (C64 + C64.T)).abs()
        tr_allow = 2 * K * EPS32 * torch.sum(Cs * (L.abs() @ L.abs().transpose(-1, -2)),
                                                 dim=(-2, -1))
        g_allow = 2 * K * EPS32 * slots(2.0 * (Cs @ L.abs()))
    else:
        A = kp._forward_sub(L, einv, C64)
        At = kp._back_sub(L, einv, A)
        tr_allow = 4 * K * EPS32 * kappa * tr
        norms = torch.linalg.matrix_norm(At) * torch.linalg.matrix_norm(A)
        g_allow = 6 * K * EPS32 * kappa[:, None] * slots(2.0 * norms[:, None, None] * torch.ones_like(L))
    return logJ, sumd, tr, g, tr_allow, g_allow, kappa


def check_pd_kernels(dev, vT, vxT):
    """The three PD kernels against their plain versions and float64, in
    the three `layouts` (the batch-major slice first) at B = 131072, 64 and
    1000 (a partial block), in both modes with a C from a random SPD
    matrix; their closed-form backward passes against autograd through the
    float64 plain versions; and, with the off-diagonal slots at 1e10, the
    inverse and the dot mode finite and equal to the plain versions. The
    solve mode's trace and gradient are held at the kappa(L)-scaled bounds
    of `pd_reference` (kappa printed). Returns the max absolute error of
    each kernel against its plain version."""
    from tpu_bijectors_torch.bijectors.pd import _pd_inverse_all, _pd_logdensity
    from tpu_bijectors_torch.kernels import pd as kp

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    err = {"pd_inverse": 0.0, "pd_logdensity": 0.0, "pd_trace_grad": 0.0}
    Cs = {m: torch.as_tensor(pd_c(random_spd(2), m), dtype=torch.float32, device=dev)
          for m in ("dot", "solve")}

    def rel(t):
        return t.abs() + 1e-3 * t.abs().max()

    for n in (vT.shape[1], CHAINS, 1000):
        y_ref = vT[PD_ROWS, :n].T.contiguous()
        refs = {m: pd_reference(y_ref, Cs[m], m) for m in Cs}
        for m, r in refs.items():
            print(f"pd {m} mode, B = {n}: kappa_F(L) max {float(r[6].max()):.3e} median "
                  f"{float(r[6].median()):.3e}", flush=True)
        X64, lj64, L64 = kp.pd_inverse_plain(y_ref.double(), PD_K)
        # logJ and sum y_rr are sums of terms of either sign: held at
        # RTOL_SUM of the sum of their magnitudes
        coeff, diag = kp.affine_coeffs(PD_K, y_ref)
        mag_lj = (coeff * y_ref.abs()).sum(-1) + PD_K * math.log(2.0)
        mag_sd = (diag * y_ref.abs()).sum(-1)
        dX = torch.sqrt(torch.diagonal(X64, dim1=-2, dim2=-1))
        x_allow = 2 * PD_K * EPS32 * dX[:, :, None] * dX[:, None, :]
        for lay, y in layouts(vT, PD_ROWS, n, "batch-major slice").items():
            tag = f"{lay}, B = {n}"
            X, lj, L = kp.pd_inverse(y, PD_K)
            Xp, ljp, Lp = kp.pd_inverse_plain(y, PD_K)
            e = err["pd_inverse"]
            e = max(e, check(f"pd_inverse X vs plain ({tag})", X, Xp, 1.0, 2 * x_allow))
            expect(f"pd_inverse X exactly symmetric ({tag})", torch.equal(X, X.mT))
            check(f"pd_inverse X vs float64 ({tag})", X, X64, 1.0, x_allow)
            e = max(e, check(f"pd_inverse L vs plain ({tag})", L, Lp, ATOL_UNIT, rel(Lp)))
            e = max(e, check(f"pd_inverse logJ vs plain ({tag})", lj, ljp, RTOL_SUM, mag_lj))
            err["pd_inverse"] = e
            cts = (torch.randn((n, PD_K, PD_K), generator=gen, device=dev),
                   torch.randn(n, generator=gen, device=dev),
                   torch.randn((n, PD_K, PD_K), generator=gen, device=dev))
            g_k = vjp(_pd_inverse_all, y, cts)
            g_64 = vjp(lambda v: kp.pd_inverse_plain(v, PD_K), y.double(),
                       tuple(c.double() for c in cts))
            check(f"pd_inverse backward vs autograd of float64 plain ({tag})", g_k, g_64,
                  RTOL_VJP, g_64.abs() + 1e-2 * g_64.abs().max())
            for m, C in Cs.items():
                lj64, sd64, tr64, gt64, tr_allow, g_allow, _ = refs[m]
                got = kp.pd_logdensity(y, PD_K, C, m)
                ref = kp.pd_logdensity_plain(y, PD_K, C, m)
                e = err["pd_logdensity"]
                e = max(e, check(f"pd_logdensity {m} logJ vs plain ({tag})", got[0], ref[0],
                                 RTOL_SUM, mag_lj))
                e = max(e, check(f"pd_logdensity {m} sumd vs plain ({tag})", got[1], ref[1],
                                 RTOL_SUM, mag_sd))
                e = max(e, check(f"pd_logdensity {m} trace vs plain ({tag})", got[2], ref[2],
                                 1.0, 2 * tr_allow))
                check(f"pd_logdensity {m} trace vs float64 ({tag})", got[2], tr64, 1.0, tr_allow)
                err["pd_logdensity"] = e
                g = kp.pd_trace_grad(y, PD_K, C, m)
                gp = kp.pd_trace_grad_plain(y, PD_K, C, m)
                expect(f"pd_trace_grad {m} in the input's layout ({tag})",
                       (g.stride(0) == 1) == (lay == "swapped"))
                err["pd_trace_grad"] = max(err["pd_trace_grad"], check(
                    f"pd_trace_grad {m} vs plain ({tag})", g, gp, 1.0, 2 * g_allow))
                check(f"pd_trace_grad {m} vs float64 ({tag})", g, gt64, 1.0, g_allow)
                # the backward of the log-density pieces (the affine slopes
                # plus ct_tr * pd_trace_grad) against autograd through the
                # float64 plain version
                cts = tuple(torch.randn(n, generator=gen, device=dev) for _ in range(3))
                g_k = vjp(lambda v, C=C, m=m: _pd_logdensity(v, PD_K, C, m), y, cts)
                g_64 = vjp(lambda v, C=C, m=m: kp.pd_logdensity_plain(v, PD_K, C.double(), m),
                           y.double(), tuple(c.double() for c in cts))
                coeff, diag = kp.affine_coeffs(PD_K, g_64)
                allow = (RTOL_VJP * (coeff * cts[0][:, None].abs() + diag * cts[1][:, None].abs())
                         + cts[2][:, None].abs() * g_allow + 1e-6)
                check(f"pd_logdensity {m} backward vs autograd of float64 plain ({tag})",
                      g_k, g_64, 1.0, allow)
        del refs, X64, L64, x_allow

    # the off-diagonal slots at 1e10: X ~ 1e20 is finite in float32, and so
    # are the dot trace and its gradient (the solve mode's L^-1 overflows)
    yx = vxT[PD_ROWS].T.contiguous()
    yx[:, [r * (r + 1) // 2 + r for r in range(PD_K)]] = 0.5
    outs = kp.pd_inverse(yx, PD_K)
    expect("1e10 off the diagonal: pd_inverse finite", all(bool(torch.isfinite(t).all()) for t in outs))
    X64, lj64, L64 = kp.pd_inverse_plain(yx.double(), PD_K)
    dX = torch.sqrt(torch.diagonal(X64, dim1=-2, dim2=-1))
    check("1e10 off the diagonal: pd_inverse X vs float64", outs[0], X64, 1.0,
          2 * PD_K * EPS32 * dX[:, :, None] * dX[:, None, :])
    check("1e10 off the diagonal: pd_inverse logJ vs float64", outs[1], lj64, RTOL_SUM,
          lj64.abs() + PD_K * math.log(2.0))
    check("1e10 off the diagonal: pd_inverse L vs float64", outs[2], L64, ATOL_UNIT, rel(L64))
    C = Cs["dot"]
    _, _, tr64, g64, tr_allow, g_allow, _ = pd_reference(yx, C, "dot")
    tr = kp.pd_logdensity(yx, PD_K, C, "dot")[2]
    expect("1e10 off the diagonal: dot trace finite", bool(torch.isfinite(tr).all()))
    check("1e10 off the diagonal: dot trace vs float64", tr, tr64, 1.0, tr_allow)
    g = kp.pd_trace_grad(yx, PD_K, C, "dot")
    expect("1e10 off the diagonal: dot trace gradient finite", bool(torch.isfinite(g).all()))
    check("1e10 off the diagonal: dot trace gradient vs float64", g, g64, 1.0, g_allow)
    return err


PD_TILE_KS = (1, 2, 3, 8, 15, 16)
PD_TILE_BS = (1, 2, 31, 32, 33, 64, 65, BATCH)


def check_pd_trace_grad(dev, vT):
    """#12 at B in PD_TILE_BS and K in PD_TILE_KS (y: the first K(K+1)/2
    rows of vT; C from a random K x K SPD matrix, numpy seed K), in both
    modes and the three `layouts`: against the plain version at twice
    `pd_reference`'s bounds and against float64 at them, g in y's layout,
    bit for bit on a second launch; at B = 2, 65 and 131072 the log-density
    pieces' backward (`_PDLogdensity`: the affine slopes plus
    ct_tr * pd_trace_grad) against autograd through the float64 plain
    version. Returns the max absolute error against the plain version."""
    from tpu_bijectors_torch.bijectors.pd import _pd_logdensity
    from tpu_bijectors_torch.kernels import pd as kp

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    err = 0.0
    for K in PD_TILE_KS:
        P = K * (K + 1) // 2
        Cs = {m: torch.as_tensor(pd_c(random_spd(K, K), m), dtype=torch.float32, device=dev)
              for m in ("dot", "solve")}
        for B in PD_TILE_BS:
            y_ref = vT[:P, :B].T.contiguous()
            for m, C in Cs.items():
                _, _, _, g64, _, g_allow, _ = pd_reference(y_ref, C, m)
                if m == "dot":
                    # pd_reference holds a dot slot to 2K eps of 2 (|C| |L|)_rc
                    # (the sums); the float32 exp of L's diagonal (2 ulp)
                    # enters a slot up to twice, 4 eps more: (2K + 4) eps in
                    # all, which matters at small K (at K = 1 the sums alone
                    # would leave the exp's error out)
                    g_allow = g_allow * (K + 2) / K
                for lay, y in layouts(vT, slice(0, P), B, "batch-major slice").items():
                    tag = f"pd_trace_grad {m}, K = {K} ({lay}, B = {B})"
                    g = kp.pd_trace_grad(y, K, C, m)
                    gp = kp.pd_trace_grad_plain(y, K, C, m)
                    expect(f"{tag} in the input's layout and bit for bit on a second launch",
                           (P == 1 or (g.stride(0) == 1) == (lay == "swapped"))
                           and torch.equal(g, kp.pd_trace_grad(y, K, C, m)))
                    err = max(err, check(f"{tag} vs plain", g, gp, 1.0, 2 * g_allow))
                    check(f"{tag} vs float64", g, g64, 1.0, g_allow)
                    if B not in (2, 65, BATCH):
                        continue
                    cts = tuple(torch.randn(B, generator=gen, device=dev) for _ in range(3))
                    g_k = vjp(lambda v, C=C, m=m: _pd_logdensity(v, K, C, m), y, cts)
                    g_64 = vjp(lambda v, C=C, m=m: kp.pd_logdensity_plain(v, K, C.double(), m),
                               y.double(), tuple(c.double() for c in cts))
                    coeff, diag = kp.affine_coeffs(K, g_64)
                    allow = (RTOL_VJP * (coeff * cts[0][:, None].abs()
                                         + diag * cts[1][:, None].abs())
                             + cts[2][:, None].abs() * g_allow + 1e-6)
                    check(f"{tag}: the log-density's backward vs autograd of float64 plain",
                          g_k, g_64, 1.0, allow)
    return err


PD_LOGDENSITY_KS = (1, 2, 5, 15, 16)
PD_LOGDENSITY_BS = (1, 15, 16, 17, 64, BATCH)


def check_pd_logdensity(dev, vT):
    """#11 at B in PD_LOGDENSITY_BS and K in PD_LOGDENSITY_KS (y: the first
    K(K+1)/2 rows of vT; C from a random K x K SPD matrix, numpy seed K),
    in both modes and the three `layouts`: logJ and sum y_rr against the
    plain version at RTOL_SUM of the sums of their terms' magnitudes, the
    trace against the plain version at twice `pd_reference`'s bound and
    against float64 at it, bit for bit on a second launch. pd_reference's
    bounds count the sums' roundings (2K eps in dot mode, 4K kappa eps in
    solve mode); the float32 exp of L's diagonal (2 ulp) enters a product
    twice, 4 eps more, which matters at small K: the trace is held at
    (K + 2) / K times them. Returns the max absolute error against the
    plain version."""
    from tpu_bijectors_torch.kernels import pd as kp

    err = 0.0
    for K in PD_LOGDENSITY_KS:
        P = K * (K + 1) // 2
        Cs = {m: torch.as_tensor(pd_c(random_spd(K, K), m), dtype=torch.float32, device=dev)
              for m in ("dot", "solve")}
        for B in PD_LOGDENSITY_BS:
            y_ref = vT[:P, :B].T.contiguous()
            coeff, diag = kp.affine_coeffs(K, y_ref)
            mag_lj = (coeff * y_ref.abs()).sum(-1) + K * math.log(2.0)
            mag_sd = (diag * y_ref.abs()).sum(-1)
            for m, C in Cs.items():
                lj64, sd64, tr64, _, tr_allow, _, _ = pd_reference(y_ref, C, m)
                tr_allow = tr_allow * (K + 2) / K
                for lay, y in layouts(vT, slice(0, P), B, "batch-major slice").items():
                    tag = f"pd_logdensity {m}, K = {K} ({lay}, B = {B})"
                    got = kp.pd_logdensity(y, K, C, m)
                    ref = kp.pd_logdensity_plain(y, K, C, m)
                    again = kp.pd_logdensity(y, K, C, m)
                    expect(f"{tag}: bit for bit on a second launch",
                           all(torch.equal(a, b) for a, b in zip(got, again)))
                    err = max(err, check(f"{tag} logJ vs plain", got[0], ref[0], RTOL_SUM, mag_lj),
                              check(f"{tag} sumd vs plain", got[1], ref[1], RTOL_SUM, mag_sd),
                              check(f"{tag} trace vs plain", got[2], ref[2], 1.0, 2 * tr_allow))
                    check(f"{tag} logJ vs float64", got[0], lj64, RTOL_SUM, mag_lj)
                    check(f"{tag} trace vs float64", got[2], tr64, 1.0, tr_allow)
    return err


def pd_entry_allowances(vT, cf64, loops64):
    """Float64 (lp, g) of a PD model's fused plain version on vT and the
    error float32 may carry: the sum of the terms at RTOL_LP / RTOL_G of
    their magnitudes, plus the trace and its gradient at `pd_reference`'s
    bounds (halved, as lp takes -tr / 2). Returns (lp64, g64, lp_allow,
    g_allow)."""
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.vectorize import fused_base as fb

    vT64 = vT.double()
    lp64, g64 = fb.slab_value_and_grad_plain(vT64, cf64, loops64)
    (code, row0, K, off), = loops64.entries
    blk = loops64.prm[off: off + K * K + 2]
    C, w, const = blk[: K * K].reshape(K, K), blk[K * K], blk[K * K + 1]
    mode = fb.PD_MODES[code]
    y = vT[PD_ROWS].T
    logJ, sumd, tr, gt, tr_allow, gt_allow, _ = pd_reference(y, C, mode)
    slab = fb.slab_value_plain(vT64, cf64) + cf64[:, fb._CI["c0"]].sum()
    mag = slab.abs() + logJ.abs() + (w * sumd).abs() + const.abs() + 0.5 * tr.abs()
    lp_allow = RTOL_LP * mag + 0.5 * tr_allow
    coeff, diag = kp.affine_coeffs(K, gt)
    g_allow = RTOL_G * g64.abs() + 1e-6
    g_allow[PD_ROWS] += (0.5 * gt_allow + RTOL_G * ((coeff + w * diag).abs() + 0.5 * gt.abs())).T
    return lp64, g64, lp_allow, g_allow


def check_pd_entry(dev, vT, family, scale=None):
    """The PD loop entry of the three whole-model kernels on a PD model
    (`pd_model`) against the plain whole-model functions in float32 and in
    float64, at B = 131072. Returns the max absolute error of each kernel
    against its plain version."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    tag = f"{family}, {'I' if scale is None else 'random S'}"
    model = tbt.Model(pd_model(dists, dev, torch.float32, family, scale), device=dev)
    m64 = tbt.Model(pd_model(dists, dev, torch.float64, family, scale), device=dev)
    cf, loops, _ = fk._prep(model.unconstrainer(), vT)
    cf64, loops64, _ = fk._prep(m64.unconstrainer(), vT.double())
    lp64, g64, lp_allow, g_allow = pd_entry_allowances(vT, cf64, loops64)
    ones = torch.ones(vT.shape[1], device=dev)
    err = {}
    val = fk.slab_value(vT, cf, loops)
    err["slab_value"] = check(f"PD entry ({tag}) value kernel vs plain", val,
                              fb.slab_value_plain(vT, cf, loops), 1.0, 2 * lp_allow)
    check(f"PD entry ({tag}) value kernel vs float64", val, lp64, 1.0, lp_allow)
    lp, g = fk.slab_value_and_grad(vT, cf, loops)
    lpp, gp = fb.slab_value_and_grad_plain(vT, cf, loops)
    err["slab_value_and_grad"] = max(
        check(f"PD entry ({tag}) value-and-grad kernel lp vs plain", lp, lpp, 1.0, 2 * lp_allow),
        check(f"PD entry ({tag}) value-and-grad kernel g vs plain", g, gp, 1.0, 2 * g_allow),
    )
    check(f"PD entry ({tag}) value-and-grad kernel g vs float64", g, g64, 1.0, g_allow)
    expect(f"PD entry ({tag}) value kernel equals value-and-grad kernel's lp",
           float((val - lp).abs().max()) <= float(lp_allow.min()))
    gv = fk.slab_vjp(vT, cf, ones, loops)
    err["slab_vjp"] = check(f"PD entry ({tag}) vjp kernel vs plain", gv,
                            fb.slab_vjp_plain(vT, cf, ones, loops), 1.0, 2 * g_allow)
    check(f"PD entry ({tag}) vjp kernel vs value-and-grad kernel's g", gv, g, 1.0, g_allow)
    return err


def run_pd_transposed_serving(dev, vT, family):
    """Path 5: transposed serving of a PD model at B = 131072 through
    `Model.batched_logdensity_t_fn()`, its `value_and_grad_fn` and autograd,
    with the launch counters zeroed just before and read just after.
    Checks lp and g against float64 and the composed per-leaf path (the PD
    log-density kernel on the swapped view, its backward). Returns
    (launches, lp, g, the entry points' times)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    model = tbt.Model(pd_model(dists, dev, torch.float32, family), device=dev)
    m64 = tbt.Model(pd_model(dists, dev, torch.float64, family), device=dev)
    u = model.unconstrainer()
    f = model.batched_logdensity_t_fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(vT)
    lp_vg, g = f.value_and_grad_fn(vT)
    vr = vT.detach().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(u.linked_logdensity_t(vr).sum(), vr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the {family} transposed serving path: {launches}", flush=True)
    expect(f"{SMALL} not launched on the {family} transposed serving path", launches[SMALL] == 0)
    for k in SLAB_KERNELS:
        expect(f"{k} launched on the {family} transposed serving path", launches[k] > 0)
    expect(f"{family}: lp (B,) and g (151, B)",
           lp.shape == (BATCH,) and g.shape == (151, BATCH))
    cf64, loops64, c0sum64 = fk._prep(m64.unconstrainer(), vT.double())
    lp64, g64, lp_allow, g_allow = pd_entry_allowances(vT, cf64, loops64)
    lp64 = lp64 + c0sum64
    check(f"{family}: linked_logdensity_t vs float64", lp, lp64, 1.0, lp_allow)
    check(f"{family}: value_and_grad_fn lp vs float64", lp_vg, lp64, 1.0, lp_allow)
    check(f"{family}: value_and_grad_fn g vs float64", g, g64, 1.0, g_allow)
    check(f"{family}: autograd g vs value_and_grad_fn g", g_ag, g, 1.0, 2 * g_allow)
    # the composed per-leaf path: the PD log-density kernel on the swapped
    # view of the W rows, and its backward (the trace-gradient kernel)
    vr = vT.detach().requires_grad_(True)
    comp = u._linked_logdensity_t_children(vr)
    (g_comp,) = torch.autograd.grad(comp.sum(), vr)
    check(f"{family}: linked_logdensity_t vs composed", lp, comp.detach(), 1.0, 2 * lp_allow)
    check(f"{family}: g vs composed autograd", g, g_comp, 1.0, 2 * g_allow)
    expect(f"{family}: lp finite", bool(torch.isfinite(lp).all()))
    v64 = vT[:, :CHAINS].contiguous()
    e2e = {
        f"{family}_value_ms_B131072": time_ms(lambda: f(vT), device_only=False),
        f"{family}_value_and_grad_ms_B131072": time_ms(lambda: f.value_and_grad_fn(vT),
                                                       device_only=False),
        f"{family}_value_and_grad_ms_B64": time_ms(lambda: f.value_and_grad_fn(v64),
                                                   device_only=False),
    }
    return launches, lp, g, e2e


def run_pd_batch_major_serving(dev, vT, family, lp_t, g_t):
    """Path 6: batch-major serving of a PD model on the same states as
    (B, 151): `Model.batched_logdensity_fn()` and its `value_and_grad_fn`
    (the PD log-density kernel, its backward the trace-gradient kernel) and
    `Model.constrain` (the PD inverse kernel), launch counters zeroed just
    before and read just after. Checks lp and g against the transposed
    fused ones and float64 on the CPU (4096 rows), and X against float64.
    Returns (launches, the entry points' times)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    model = tbt.Model(pd_model(dists, dev, torch.float32, family), device=dev)
    v = vT.T.contiguous()
    f = model.batched_logdensity_fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(v)
    lp_vg, g = f.value_and_grad_fn(v)
    x = model.constrain(v)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the {family} batch-major serving path: {launches}", flush=True)
    for k in ("pd_logdensity", "pd_trace_grad", "pd_inverse"):
        expect(f"{k} launched on the {family} batch-major serving path", launches[k] > 0)
    m64 = tbt.Model(pd_model(dists, dev, torch.float64, family), device=dev)
    cf64, loops64, _ = fk._prep(m64.unconstrainer(), vT.double())
    _, _, lp_allow, g_allow = pd_entry_allowances(vT, cf64, loops64)
    check(f"{family} batch-major: lp vs value_and_grad_fn lp", lp_vg, lp, 1.0, lp_allow)
    check(f"{family} batch-major: lp vs fused transposed lp", lp, lp_t, 1.0, 2 * lp_allow)
    check(f"{family} batch-major: g vs fused transposed g", g, g_t.T, 1.0, 2 * g_allow.T)
    rows = slice(0, 4096)
    cpu = tbt.Model(pd_model(dists, "cpu", torch.float64, family), device="cpu")
    lp64, g64 = cpu.batched_logdensity_fn().value_and_grad_fn(v[rows].double().cpu())
    check(f"{family} batch-major: lp vs float64 CPU, 4096 rows", lp[rows].cpu(), lp64, 1.0,
          lp_allow[rows].cpu())
    check(f"{family} batch-major: g vs float64 CPU, 4096 rows", g[rows].cpu(), g64, 1.0,
          g_allow[:, rows].T.cpu())
    X64 = kp.pd_inverse_plain(v[:, PD_ROWS].double(), PD_K)[0]
    dX = torch.sqrt(torch.diagonal(X64, dim1=-2, dim2=-1))
    check(f"{family} batch-major: Model.constrain's W vs float64", x["W"], X64, 1.0,
          2 * PD_K * EPS32 * dX[:, :, None] * dX[:, None, :])
    v64 = v[:CHAINS].contiguous()
    e2e = {
        f"{family}_batch_major_value_ms_B131072": time_slow_ms(lambda: f(v), device_only=False),
        f"{family}_batch_major_value_and_grad_ms_B131072": time_slow_ms(
            lambda: f.value_and_grad_fn(v), device_only=False),
        f"{family}_batch_major_value_and_grad_ms_B64": time_slow_ms(
            lambda: f.value_and_grad_fn(v64), device_only=False),
    }
    return launches, e2e


def pd_conjugate_ztz():
    """The pd_conjugate cell's data: Z'Z (float64) of 200 observations
    z_i ~ N(0, Sigma) in R^16, Sigma SPD from numpy seed 1."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((PD_K, PD_K))
    Sigma = A @ A.T / PD_K + 0.5 * np.eye(PD_K)
    Z = rng.multivariate_normal(np.zeros(PD_K), Sigma, size=200)
    return Z.T @ Z


def pd_conjugate_data(dev):
    """The pd_conjugate cell's likelihood (user code) on
    `pd_conjugate_ztz`'s data, rounded to float32: loglik(x) =
    100 log det W - tr(W Z'Z) / 2 with W the precision. The posterior of W
    under pdonly's Wishart(18, I) prior is Wishart(218, (I + Z'Z)^-1).
    Returns (loglik, the posterior means of W's diagonal)."""
    ztz = pd_conjugate_ztz()
    ZtZ = torch.as_tensor(ztz, dtype=torch.float32, device=dev)

    def loglik(x):
        W = x["W"]
        return 100.0 * torch.linalg.slogdet(W)[1] - 0.5 * torch.sum(W * ZtZ)

    post = 218.0 * np.diag(np.linalg.inv(np.eye(PD_K) + ztz))
    return loglik, post


def run_pd_sampler(dev):
    """Path 7, the pd_conjugate cell: the steps of `Model(pdonly,
    loglik).sample(kernel='auto')` with the starts at PD_INIT_SCALE *
    N(0, 1): the kernel 'auto' takes (`nuts_batched_t`: each leapfrog runs
    the value-and-gradient kernel with the PD entry, and the PD inverse
    kernel and its backward for the likelihood's x), `warmup_and_sample`
    from `Model.init_positions` for the warmup and `resume_sampling` for
    the draws, as `run_sampler` times them; 64 chains, max_depth 8, 300
    warmup and 200 kept transitions, target acceptance 0.95, torch seed 0.
    Gates: R-hat <= 1.05, divergences <= 1%, W's diagonal means within 5
    MCSE of the Wishart posterior's, m's within 5 MCSE of 0."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, resume_sampling, warmup_and_sample

    loglik, post = pd_conjugate_data(dev)
    model = tbt.Model(pd_model(dists, dev, torch.float32, "wishart"), loglik=loglik, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    kernel = model._auto_kernel()
    expect(f"pd_conjugate: kernel='auto' takes nuts_batched_t (took {kernel})",
           kernel == "nuts_batched_t")
    density = model.batched_logdensity_t_fn()
    _, state, _ = warmup_and_sample(
        density, gen, model.init_positions(gen, CHAINS, PD_INIT_SCALE), n_warmup=WARMUP,
        n_samples=0, kernel=kernel, max_depth=MAX_DEPTH, target_accept=TARGET_ACCEPT,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, s1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    raw, state, stats = resume_sampling(density, state, KEPT, kernel=kernel, max_depth=MAX_DEPTH)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2, s2 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    samples = model.constrain(raw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the pd_conjugate sampler path: {launches}", flush=True)
    for k in (SMALL, "pd_inverse"):
        expect(f"{k} launched on the pd_conjugate sampler path", launches[k] > 0)
    during = {k: l2[k] - l1[k] for k in l2}
    leapfrogs = during[SMALL]
    sampling_s = t2 - t1
    expect("pd_conjugate: raw draws (200, 64, 151) and finite",
           tuple(raw.shape) == (KEPT, CHAINS, 151) and bool(torch.isfinite(raw).all()))
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    Wd = torch.diagonal(samples["W"], dim1=-2, dim2=-1)
    dev_w = np.abs(Wd.double().mean(dim=(0, 1)).cpu().numpy() - post) / diagnostics.mcse_mean(Wd)
    m = samples["m"]
    dev_m = np.abs(m.double().mean(dim=(0, 1)).cpu().numpy()) / diagnostics.mcse_mean(m)
    n_div = int(stats.diverging.sum())
    line = {
        "kernel": "nuts_batched_t", "cell": "pd_conjugate",
        "chains": CHAINS, "warmup": WARMUP, "kept": KEPT, "max_depth": MAX_DEPTH,
        "target_accept": TARGET_ACCEPT, "init_scale": PD_INIT_SCALE,
        "warmup_s": t1 - t0,
        "sampling_s": sampling_s,
        "constrain_s": t3 - t2,
        "draws_per_s": CHAINS * KEPT / sampling_s,
        "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": (s2 - s1) / max(leapfrogs, 1),
        "step_size": float(state.eps),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "transitions": CHAINS * KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "min_ess_bulk": float(np.min(ess)),
        "max_W_diag_dev_in_mcse": float(np.max(dev_w)),
        "max_m_dev_in_mcse": float(np.max(dev_m)),
    }
    expect(f"pd_conjugate: max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"pd_conjugate: divergences {n_div} <= 1% of {CHAINS * KEPT}",
           n_div <= 0.01 * CHAINS * KEPT)
    expect(f"pd_conjugate: W diagonal means within 5 MCSE of Wishart(218, (I + Z'Z)^-1) "
           f"(max {np.max(dev_w):.2f})", bool(np.all(dev_w <= 5.0)))
    expect(f"pd_conjugate: m means within 5 MCSE of 0 (max {np.max(dev_m):.2f})",
           bool(np.all(dev_m <= 5.0)))
    expect("pd_conjugate: constrained draws finite",
           all(bool(torch.isfinite(t).all()) for t in samples.values()))
    return line, launches


# --- the dense multivariate families (the fifth slice) -----------------------

MV_K = 16
# mvdense's linked rows: 4 x MvNormalTril(16), MvNormalCanon(16),
# 4 x MvStudentT(16), MvLogNormal(4), MvNormalDiag(3)
MV_ROWS = {"tril": slice(0, 64), "canon": slice(64, 80), "t": slice(80, 144),
           "ln": slice(144, 148), "diag": slice(148, 151)}
MV_N_OBS = 200
# the mv_conjugate cell keeps 1000 draws a chain, not the other cells' 200:
# the 16-dimensional t(5) blocks mix slowly in their tails, and at 200 draws
# the max R-hat over their 64 coordinates is 1.07-1.11 in both packages
# (the JAX package's sampler in float32, seeds 0-2, and the port's on the
# card: tests/test_torch_mv_witness.py, run as a script); at 1000 both are
# within 1.05
MV_KEPT = 1000
# operations per element of a Gaussian or t loop entry at K = 16, counted as
# OPS (a multiply-add is 2): the form every mode computes, r = v - mu 16,
# w = C r over the triangle 136 multiply-adds and q 16; the value 6 (the
# t's log1p and division; the Gaussian's 3); the partials C'w 136
# multiply-adds, 16 scalings and the t's factor 3; the tangent's 16
# multiply-adds in the jvp mode (counted apart)
QUAD_OPS = {"form": 16 + 2 * 136 + 2 * 16, "value": 3, "grad": 2 * 136 + 16}


def mvdense_params():
    """mvdense's parameters from numpy seed 2 (numpy float64): L_A, L_B and
    A_J are tril(0.3 N(0, 1)) + 2I as in the JAX package's
    tests/test_transposed_layout.py::_mega_model_mv, mu_A, mu_B and h are
    0.5 N(0, 1); the log-normal's and the diagonal normal's locations
    0.5 N(0, 1) and scales exp(0.3 N(0, 1))."""
    rng = np.random.default_rng(2)

    def tri():
        return np.tril(0.3 * rng.standard_normal((MV_K, MV_K))) + 2.0 * np.eye(MV_K)

    LA, LB, AJ = tri(), tri(), tri()
    muA, muB, h = (0.5 * rng.standard_normal(MV_K) for _ in range(3))
    ln_loc, diag_loc = 0.5 * rng.standard_normal(4), 0.5 * rng.standard_normal(3)
    ln_scale, diag_scale = np.exp(0.3 * rng.standard_normal(4)), np.exp(0.3 * rng.standard_normal(3))
    return dict(LA=LA, LB=LB, J=AJ @ AJ.T, muA=muA, muB=muB, h=h, df=5.0, ln_loc=ln_loc,
                ln_scale=ln_scale, diag_loc=diag_loc, diag_scale=diag_scale)


def mvdense_model(dists, device, dtype):
    """mvdense (dim 151) on `mvdense_params` in `dists` (the port's, or the
    JAX package's with device and dtype None). Returns (the model, the
    parameters, the prior means of its 151 linked coordinates)."""
    p = mvdense_params()
    kw = {} if device is None else dict(device=device, dtype=dtype)
    d = dists.NamedProduct.of(
        tril=dists.IIDProduct(dists.MvNormalTril(p["muA"], p["LA"], **kw), 4),
        canon=dists.MvNormalCanon(p["h"], p["J"], **kw),
        t=dists.IIDProduct(dists.MvStudentT(p["df"], p["muB"], p["LB"], **kw), 4),
        ln=dists.MvLogNormal(p["ln_loc"], p["ln_scale"], **kw),
        diag=dists.MvNormalDiag(p["diag_loc"], p["diag_scale"], **kw),
    )
    prior_means = np.concatenate([np.tile(p["muA"], 4), np.linalg.solve(p["J"], p["h"]),
                                  np.tile(p["muB"], 4), p["ln_loc"], p["diag_loc"]])
    return d, p, prior_means


def quad_bounds(vT, loops, loops64=None):
    """The error a float32 evaluation of the Gaussian and t loop entries of
    `loops` may carry on vT, in float64 from the standard bounds of the
    sums done (eps = eps32, |.| elementwise, per batch column): w = C r with
    r = v - mu within (K + 2) eps |C| |r|; q = ||w||^2 within 2 |w|'dw +
    (K + 1) eps q; the value through its derivative in q (the t's
    (df + K) / (2 (df + q))) and a few roundings of its terms; the
    partials s C'w within |s| ((K + 1) eps |C|'|w| + |C|'dw) + ds |C'w|.
    With `loops64` (the same entries' parameters formed in float64) the
    float32 parameters' own error, |C32 - C64| |r| + |C| |mu32 - mu64| and
    |const32 - const64|, is added. Returns (lp allowance (B,), the loop
    rows' partials allowance (dim, B), the sum of the entries' |value|)."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    dim, B = vT.shape
    v = vT.double()
    f64 = dict(dtype=torch.float64, device=vT.device)
    lp_allow, mag = torch.zeros(B, **f64), torch.zeros(B, **f64)
    g_allow = torch.zeros((dim, B), **f64)
    prm = loops.prm.double()
    dprm = None if loops64 is None else (prm - loops64.prm).abs()
    for code, row0, K, off in loops.entries:
        if code in fb.PD_MODES:
            continue
        n = fb.PARAM_FLOATS[code](K)
        tri = torch.triu if code == fb.LOOP_CODES["gauss_upper"] else torch.tril
        blk = prm[off: off + n]
        C, mu = tri(blk[: K * K].reshape(K, K)), blk[K * K: K * K + K]
        aC = C.abs()
        r = v[row0: row0 + K] - mu[:, None]
        w = C @ r
        q = (w * w).sum(0)
        wa = (K + 2) * EPS32 * (aC @ r.abs())
        if dprm is not None:
            d = dprm[off: off + n]
            wa = wa + tri(d[: K * K].reshape(K, K)) @ r.abs() + aC @ d[K * K: K * K + K, None]
        qa = 2 * (w.abs() * wa).sum(0) + (K + 1) * EPS32 * q
        const = blk[n - 1]
        if code == fb.LOOP_CODES["mvt"]:
            df = blk[K * K + K]
            val = 0.5 * (df + K) * torch.log1p(q / df)
            lpa = 0.5 * (df + K) / (df + q) * qa + 4 * EPS32 * (val + const.abs())
            s = -(df + K) / (df + q)
            sa = s.abs() / (df + q) * qa + 3 * EPS32 * s.abs()
        else:
            val = 0.5 * q
            lpa = 0.5 * qa + 2 * EPS32 * (val + const.abs())
            s, sa = -torch.ones_like(q), torch.zeros_like(q)
        ga = s.abs() * ((K + 1) * EPS32 * (aC.T @ w.abs()) + aC.T @ wa) + sa * (C.T @ w).abs()
        if dprm is not None:
            lpa = lpa + d[n - 1]
            ga = ga + s.abs() * (tri(d[: K * K].reshape(K, K)).T @ w.abs())
        lp_allow += lpa
        mag += val + const.abs()
        g_allow[row0: row0 + K] = ga
    return lp_allow, g_allow, mag


def mv_allowances(vT, cf, loops, cf64, loops64):
    """Float64 (lp with c0, g) of mvdense's plain whole-model function with
    its parameters formed in float64, and the error a float32 evaluation
    with the float32 parameters may carry: the slab rows' and the entries'
    accumulation at RTOL_LP of the sum of their magnitudes (each row's
    |value| and |c0|), the gradient of the slab rows at RTOL_G, plus
    `quad_bounds` with the parameters' own error. Returns (lp64, g64,
    lp_allow, g_allow)."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    vT64 = vT.double()
    lp64, g64 = fb.slab_value_and_grad_plain(vT64, cf64, loops64)
    lp64 = lp64 + cf64[:, fb._CI["c0"]].sum()
    groups, used = fb._groups_and_used(cf64)
    rows, _ = fb._slab_segment_val_par(groups, vT64, cf64, used)
    qa_lp, qa_g, mag = quad_bounds(vT, loops, loops64)
    slab_mag = rows.abs().sum(0) + cf64[:, fb._CI["c0"]].abs().sum()
    lp_allow = RTOL_LP * (slab_mag + mag) + qa_lp
    g_allow = RTOL_G * g64.abs() + 1e-6 + qa_g
    return lp64, g64, lp_allow, g_allow


def jvp_allowance(g64, g_allow, dvT):
    """The error of a float32 sum_rows g dv: each row's partials' allowance
    times |dv|, and the accumulation at RTOL_LP of sum |g dv|."""
    dv = dvT.double().abs()
    return (g_allow * dv).sum(0) + RTOL_LP * (g64.abs() * dv).sum(0)


def run_mv_transposed_serving(dev, vT, dvT):
    """Path 8: transposed serving of mvdense at B = 131072 through
    `Model.batched_logdensity_t_fn()` (the value kernel), its
    `value_and_grad_fn` (value and gradient), autograd's backward (the VJP)
    and `torch.func.jvp` of `linked_logdensity_t` (the forward-mode
    kernel, #4), each with the Gaussian and t loop entries, the counters
    zeroed just before and read just after. Each against float64 and the
    composed per-leaf path, and each kernel against its plain version, at
    `mv_allowances`. Returns (launches, lp, g, the entry points' times,
    the kernels' max errors against their plain versions)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    model = tbt.Model(mvdense_model(dists, dev, torch.float32)[0], device=dev)
    m64 = tbt.Model(mvdense_model(dists, dev, torch.float64)[0], device=dev)
    u = model.unconstrainer()
    f = model.batched_logdensity_t_fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(vT)
    lp_vg, g = f.value_and_grad_fn(vT)
    vr = vT.detach().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(u.linked_logdensity_t(vr).sum(), vr)
    lp_j, dlp = torch.func.jvp(u.linked_logdensity_t, (vT,), (dvT,))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the mvdense transposed serving path: {launches}", flush=True)
    expect(f"{SMALL} not launched on the mvdense transposed serving path", launches[SMALL] == 0)
    for k in SLAB_KERNELS + ("slab_jvp",):
        expect(f"{k} launched on the mvdense transposed serving path", launches[k] > 0)
    B = vT.shape[1]
    expect("mvdense: lp (B,), g (151, B), dlp (B,)",
           lp.shape == (B,) and g.shape == (151, B) and dlp.shape == (B,))
    cf, loops, c0sum = fk._prep(u, vT)
    cf64, loops64, _ = fk._prep(m64.unconstrainer(), vT.double())
    print(f"mvdense loop entries (kind, first row, K, offset): {loops.entries}", flush=True)
    lp64, g64, lp_allow, g_allow = mv_allowances(vT, cf, loops, cf64, loops64)
    dlp64 = (g64 * dvT.double()).sum(0)
    j_allow = jvp_allowance(g64, g_allow, dvT)
    check("mvdense: linked_logdensity_t vs float64", lp, lp64, 1.0, lp_allow)
    check("mvdense: value_and_grad_fn lp vs float64", lp_vg, lp64, 1.0, lp_allow)
    check("mvdense: value_and_grad_fn g vs float64", g, g64, 1.0, g_allow)
    check("mvdense: autograd g vs float64", g_ag, g64, 1.0, g_allow)
    check("mvdense: torch.func.jvp lp vs float64", lp_j, lp64, 1.0, lp_allow)
    check("mvdense: torch.func.jvp dlp vs float64", dlp, dlp64, 1.0, j_allow)
    # the composed per-leaf path (triangular solves, not the host-formed
    # inverse): held at the float64 allowance twice over
    comp = u._linked_logdensity_t_children(vT)
    check("mvdense: linked_logdensity_t vs composed", lp, comp, 1.0, 2 * lp_allow)
    # each kernel against its plain version on the same float32 inputs
    ct = torch.ones(B, device=dev)
    err = {}
    err["slab_value"] = check("mvdense value kernel vs plain", fk.slab_value(vT, cf, loops),
                              fb.slab_value_plain(vT, cf, loops), 1.0, 2 * lp_allow)
    lp_k, g_k = fk.slab_value_and_grad(vT, cf, loops)
    lp_p, g_p = fb.slab_value_and_grad_plain(vT, cf, loops)
    err["slab_value_and_grad"] = max(
        check("mvdense value-and-grad kernel lp vs plain", lp_k, lp_p, 1.0, 2 * lp_allow),
        check("mvdense value-and-grad kernel g vs plain", g_k, g_p, 1.0, 2 * g_allow))
    err["slab_vjp"] = check("mvdense vjp kernel vs plain", fk.slab_vjp(vT, cf, ct, loops),
                            fb.slab_vjp_plain(vT, cf, ct, loops), 1.0, 2 * g_allow)
    err["slab_jvp"] = check("mvdense jvp kernel vs plain", fk.slab_jvp(vT, cf, dvT, loops),
                            fb.slab_jvp_plain(vT, cf, dvT, loops), 1.0, 2 * j_allow)
    del lp_k, g_k, lp_p, g_p, g64, g_allow, comp
    v64 = vT[:, :CHAINS].contiguous()
    d64 = dvT[:, :CHAINS].contiguous()
    e2e = {
        "mvdense_value_ms_B131072": time_ms(lambda: f(vT), device_only=False),
        "mvdense_value_and_grad_ms_B131072": time_ms(lambda: f.value_and_grad_fn(vT),
                                                     device_only=False),
        "mvdense_func_jvp_ms_B131072": time_ms(
            lambda: torch.func.jvp(u.linked_logdensity_t, (vT,), (dvT,)), device_only=False),
        "mvdense_value_and_grad_ms_B64": time_ms(lambda: f.value_and_grad_fn(v64),
                                                 device_only=False),
        "mvdense_func_jvp_ms_B64": time_ms(
            lambda: torch.func.jvp(u.linked_logdensity_t, (v64,), (d64,)), device_only=False),
    }
    return launches, lp, g, e2e, err


def run_mv_batch_major_serving(dev, vT, lp_t, g_t):
    """Path 9: batch-major serving of mvdense on the same states as
    (B, 151): `Model.batched_logdensity_fn()` and its `value_and_grad_fn`
    (torch's triangular solves, which the JAX package also runs outside any
    kernel: no launch), against the transposed lp and g within 1e-4, and
    `Model.constrain` mapping the MvLogNormal rows through exp. Returns the
    entry points' times."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels

    model = tbt.Model(mvdense_model(dists, dev, torch.float32)[0], device=dev)
    v = vT.T.contiguous()
    f = model.batched_logdensity_fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(v)
    lp_vg, g = f.value_and_grad_fn(v)
    x = model.constrain(v[:CHAINS])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the mvdense batch-major serving path: {launches} (no kernel: "
          "the dense families' batch-major densities are triangular solves in torch)",
          flush=True)
    expect("mvdense batch-major serving launches no kernel", not any(launches.values()))
    check("mvdense batch-major: lp vs fused transposed lp", lp, lp_t, RTOL_COMPOSED)
    check("mvdense batch-major: value_and_grad_fn lp vs fused transposed lp", lp_vg, lp_t,
          RTOL_COMPOSED)
    check("mvdense batch-major: g vs fused transposed g", g, g_t.T, RTOL_COMPOSED)
    expect("mvdense: Model.constrain maps the MvLogNormal rows through exp",
           torch.equal(x["ln"], torch.exp(v[:CHAINS, MV_ROWS["ln"]]))
           and torch.equal(x["diag"], v[:CHAINS, MV_ROWS["diag"]]))
    v64 = v[:CHAINS].contiguous()
    return {
        "mvdense_batch_major_value_ms_B131072": time_slow_ms(lambda: f(v), device_only=False),
        "mvdense_batch_major_value_and_grad_ms_B131072": time_slow_ms(
            lambda: f.value_and_grad_fn(v), device_only=False),
        "mvdense_batch_major_value_and_grad_ms_B64": time_slow_ms(
            lambda: f.value_and_grad_fn(v64), device_only=False),
    }


def mv_conjugate_data(dev, LA, muA, dtype=torch.float32):
    """The mv_conjugate cell's likelihood (user code): 200 observations
    z_i ~ N(theta*, L_A L_A'), theta* = mu_A + N(0, 1), from numpy seed 1,
    on the first MvNormalTril copy theta: loglik = theta' P sum z -
    n theta' P theta / 2 (P = (L_A L_A')^-1, in `dtype`). Prior and
    observations share the covariance, so theta's posterior mean is
    (mu_A + sum z) / 201. Returns (loglik, that mean)."""
    rng = np.random.default_rng(1)
    cov = LA @ LA.T
    theta = muA + rng.standard_normal(MV_K)
    Z = rng.multivariate_normal(theta, cov, size=MV_N_OBS)
    P = np.linalg.inv(cov)
    Pz = torch.as_tensor(P @ Z.sum(0), dtype=dtype, device=dev)
    Pt = torch.as_tensor(P, dtype=dtype, device=dev)

    def loglik(x):
        th = x["tril"][0]
        return th @ Pz - 0.5 * MV_N_OBS * (th @ (Pt @ th))

    return loglik, (muA + Z.sum(0)) / (MV_N_OBS + 1)


def run_mv_sampler(dev):
    """Path 10, the mv_conjugate cell: the steps of `Model(mvdense,
    loglik).sample(kernel='auto')` (`nuts_batched_t`: each leapfrog runs the
    value-and-gradient kernel with the Gaussian and t entries), from
    `Model.init_positions(gen, 64, 0.3)` passed to `warmup_and_sample`,
    then `resume_sampling`, with cell 7's settings (64 chains, max_depth 8,
    300 warmup transitions, target 0.95, torch seed 0) but MV_KEPT kept
    draws. Gates: R-hat <= 1.05
    over the 151 coordinates, divergences <= 1%, every linked coordinate's
    posterior mean within 5 MCSE of the known one (the likelihood's copy:
    `mv_conjugate_data`; every other coordinate its prior mean: mu_A, J^-1 h,
    mu_B (df 5 > 1), the log-normal's and the diagonal normal's locations)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, resume_sampling, warmup_and_sample

    d, p, post = mvdense_model(dists, dev, torch.float32)
    loglik, post0 = mv_conjugate_data(dev, p["LA"], p["muA"])
    post[:MV_K] = post0
    model = tbt.Model(d, loglik=loglik, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    kernel = model._auto_kernel()
    expect(f"mv_conjugate: kernel='auto' takes nuts_batched_t (took {kernel})",
           kernel == "nuts_batched_t")
    density = model.batched_logdensity_t_fn()
    _, state, _ = warmup_and_sample(
        density, gen, model.init_positions(gen, CHAINS, PD_INIT_SCALE), n_warmup=WARMUP,
        n_samples=0, kernel=kernel, max_depth=MAX_DEPTH, target_accept=TARGET_ACCEPT,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, s1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    raw, state, stats = resume_sampling(density, state, MV_KEPT, kernel=kernel,
                                        max_depth=MAX_DEPTH)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2, s2 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    samples = model.constrain(raw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the mv_conjugate sampler path: {launches}", flush=True)
    expect(f"{SMALL} launched on the mv_conjugate sampler path", launches[SMALL] > 0)
    during = {k: l2[k] - l1[k] for k in l2}
    leapfrogs = during[SMALL]
    sampling_s = t2 - t1
    expect(f"mv_conjugate: raw draws ({MV_KEPT}, 64, 151) and finite",
           tuple(raw.shape) == (MV_KEPT, CHAINS, 151) and bool(torch.isfinite(raw).all()))
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    dev_all = np.abs(raw.double().mean(dim=(0, 1)).cpu().numpy() - post) / diagnostics.mcse_mean(raw)
    n_div = int(stats.diverging.sum())
    line = {
        "kernel": "nuts_batched_t", "cell": "mv_conjugate",
        "chains": CHAINS, "warmup": WARMUP, "kept": MV_KEPT, "max_depth": MAX_DEPTH,
        "target_accept": TARGET_ACCEPT, "init_scale": PD_INIT_SCALE,
        "warmup_s": t1 - t0,
        "sampling_s": sampling_s,
        "constrain_s": t3 - t2,
        "draws_per_s": CHAINS * MV_KEPT / sampling_s,
        "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": (s2 - s1) / max(leapfrogs, 1),
        "step_size": float(state.eps),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "transitions": CHAINS * MV_KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "min_ess_bulk": float(np.min(ess)),
        "max_mean_dev_in_mcse": float(np.max(dev_all)),
        "max_theta_dev_in_mcse": float(np.max(dev_all[:MV_K])),
    }
    expect(f"mv_conjugate: max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"mv_conjugate: divergences {n_div} <= 1% of {CHAINS * MV_KEPT}",
           n_div <= 0.01 * CHAINS * MV_KEPT)
    expect(f"mv_conjugate: every linked mean within 5 MCSE of the posterior's "
           f"(max {np.max(dev_all):.2f})", bool(np.all(dev_all <= 5.0)))
    expect("mv_conjugate: constrained draws finite",
           all(bool(torch.isfinite(t).all()) for t in samples.values()))
    return line, launches


def slab_allowances(vT, cf):
    """Float64 (lp, g) of a slab-only model's plain function on vT and the
    float32 allowances of the existing checks: RTOL_LP of the rows'
    magnitudes, RTOL_G of each partial."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    vT64, cf64 = vT.double(), cf.double()
    lp64, g64 = fb.slab_value_and_grad_plain(vT64, cf64)
    groups, used = fb._groups_and_used(cf64)
    rows, _ = fb._slab_segment_val_par(groups, vT64, cf64, used)
    return lp64, g64, RTOL_LP * rows.abs().sum(0) + 1e-6, RTOL_G * g64.abs() + 1e-6


def check_jvp_earlier(dev, vT):
    """#4's kernel on the models of the earlier slices against its plain
    version: the bench model (slab rows only) and both PD models (the PD
    entry, dot and solve), at B = 131072, 64 and 1000 (a partial block),
    with a tangent 0.5 N(0, 1) from torch seed 3. Returns the max absolute
    error."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    dvT = 0.5 * torch.randn(vT.shape, generator=gen, device=dev)
    err = 0.0
    models = {"bench": bench_model(dists, dev, torch.float32)}
    models.update({fam: pd_model(dists, dev, torch.float32, fam) for fam in PD_MODES})
    for name, d in models.items():
        u = tbt.Model(d, device=dev).unconstrainer()
        m64 = None if name == "bench" else tbt.Model(
            pd_model(dists, dev, torch.float64, name), device=dev)
        for n in (vT.shape[1], CHAINS, 1000):
            x, dx = vT[:, :n].contiguous(), dvT[:, :n].contiguous()
            cf, loops, _ = fk._prep(u, x)
            if loops is None:
                _, g64, _, g_allow = slab_allowances(x, cf)
            else:
                cf64, loops64, _ = fk._prep(m64.unconstrainer(), x.double())
                _, g64, _, g_allow = pd_entry_allowances(x, cf64, loops64)
            allow = jvp_allowance(g64, g_allow, dx)
            got = fk.slab_jvp(x, cf, dx, loops)
            err = max(err, check(f"jvp kernel vs plain ({name}, B = {n})", got,
                                 fb.slab_jvp_plain(x, cf, dx, loops), 1.0, 2 * allow))
            check(f"jvp kernel vs float64 ({name}, B = {n})", got,
                  (g64 * dx.double()).sum(0), 1.0, allow)
    return err


def wide_model(dists, device, dtype):
    """`wide`: IIDProduct(Normal(0.5, 2.0), 4000), dim 4000 (a 256 KB table,
    beyond a block's shared memory)."""
    return dists.IIDProduct(dists.Normal(0.5, 2.0, device=device, dtype=dtype), 4000)


def wide_general_model(dists, device, dtype):
    """`wide-general`: IIDProduct(Exponential(1.5), 4000), dim 4000: {lin,
    exp} rows, a term set without a row function of its own, so the value
    mode packs cf's whole row (64 bytes) and its 256 KB of packed
    coefficients lie beyond a block's shared memory (the run walk's GTAB
    instantiation)."""
    return dists.IIDProduct(dists.Exponential(1.5, device=device, dtype=dtype), 4000)


# the models of the tables in global memory, at B = 16384
WIDE_MODELS = {"wide": lambda d, t, dev, dt: wide_model(d, dev, dt),
               "wide-general": lambda d, t, dev, dt: wide_general_model(d, dev, dt)}
WIDE_B = 16384


def check_wide(dev, B=WIDE_B):
    """The repair of the whole-model kernels' table: `wide`,
    IIDProduct(Normal(0.5, 2.0), 4000), dim 4000 (a 256 KB table, beyond
    the block's 227 KB of shared memory) at B = 16384, states 0.5 N(0, 1)
    from numpy seed 4: the four modes (the value through
    `Model.batched_logdensity_t_fn()` too) against their plain versions and
    float64. Returns the four modes as `time_kernels` variants. The
    value-and-gradient mode is the kernel of a thread a column (a batch
    this size may take the small design, which `check_small_design`
    holds)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    n = 4000
    model = tbt.Model(wide_model(dists, dev, torch.float32), device=dev)
    rng = np.random.default_rng(4)
    vT = torch.as_tensor(0.5 * rng.standard_normal((n, B)), dtype=torch.float32, device=dev)
    dvT = torch.as_tensor(rng.standard_normal((n, B)), dtype=torch.float32, device=dev)
    ct = torch.as_tensor(rng.standard_normal(B), dtype=torch.float32, device=dev)
    u = model.unconstrainer()
    cf, loops, c0sum = fk._prep(u, vT)
    expect("wide: a slab-only model of 4000 rows", loops is None and cf.shape == (n, fb.NCF))
    lp64, g64, lp_allow, g_allow = slab_allowances(vT, cf)
    lp_allow = lp_allow + RTOL_LP * float(cf[:, fb._CI["c0"]].abs().sum())
    c0 = float(c0sum)
    lp = model.batched_logdensity_t_fn()(vT)
    check("wide: batched_logdensity_t_fn vs float64", lp, lp64 + c0, 1.0, lp_allow)
    check("wide: value kernel vs plain", fk.slab_value(vT, cf), fb.slab_value_plain(vT, cf), 1.0,
          2 * lp_allow)
    lp_k, g_k = fk.slab_value_and_grad(vT, cf, design="wide")
    lp_p, g_p = fb.slab_value_and_grad_plain(vT, cf)
    check("wide: value-and-grad kernel lp vs plain", lp_k, lp_p, 1.0, 2 * lp_allow)
    check("wide: value-and-grad kernel g vs plain", g_k, g_p, 1.0, 2 * g_allow)
    check("wide: value-and-grad kernel g vs float64", g_k, g64, 1.0, g_allow)
    del lp_k, g_k, lp_p, g_p
    check("wide: vjp kernel vs plain", fk.slab_vjp(vT, cf, ct), fb.slab_vjp_plain(vT, cf, ct), 1.0,
          2 * g_allow * ct.double().abs()[None])
    j_allow = jvp_allowance(g64, g_allow, dvT)
    got = fk.slab_jvp(vT, cf, dvT)
    check("wide: jvp kernel vs plain", got, fb.slab_jvp_plain(vT, cf, dvT), 1.0, 2 * j_allow)
    check("wide: jvp kernel vs float64", got, (g64 * dvT.double()).sum(0), 1.0, j_allow)
    # the four modes' times (the table in global memory), with their bounds:
    # reads vT (and dvT), cf and ct, writes lp or g; the quad group's ops
    nbytes = vT.numel() * 4 + B * 4 + cf.numel() * 4
    ops = {k: B * n * (2 + OPS[k]["quad"]) for k in OPS}
    return {
        "slab_value, table in global memory (wide)": (
            lambda: fk.slab_value(vT, cf), nbytes, ops["value"],
            lambda: fb.slab_value_plain(vT, cf)),
        "slab_value_and_grad, table in global memory (wide)": (
            lambda: fk.slab_value_and_grad(vT, cf, design="wide"), nbytes + vT.numel() * 4,
            ops["value_and_grad"], lambda: fb.slab_value_and_grad_plain(vT, cf)),
        "slab_vjp, table in global memory (wide)": (
            lambda: fk.slab_vjp(vT, cf, ct), nbytes + vT.numel() * 4, ops["vjp"],
            lambda: fb.slab_vjp_plain(vT, cf, ct)),
        "slab_jvp, table in global memory (wide)": (
            lambda: fk.slab_jvp(vT, cf, dvT), nbytes + vT.numel() * 4, ops["jvp"],
            lambda: fb.slab_jvp_plain(vT, cf, dvT)),
    }


def pdwide_model(dists, device, dtype):
    """`pdwide`: pdonly (Wishart(18, I_16), 15 N(0, 1)) and 900 more N(0, 1),
    dim 1051 (a 67 KB table: with the gradient modes' PD scratch beyond the
    loop budget)."""
    kw = dict(device=device, dtype=dtype)
    return dists.NamedProduct.of(
        W=dists.Wishart(18.0, np.eye(PD_K), **kw),
        m=dists.IIDProduct(dists.Normal(0.0, 1.0, **kw), 15),
        extra=dists.IIDProduct(dists.Normal(0.0, 1.0, **kw), 900),
    )


def check_pdwide(dev, B=16384):
    """The repair with a PD entry: `pdwide` at B = 16384, states 0.5 N(0, 1)
    from numpy seed 5: value and gradient and the VJP kernels against their
    plain versions and float64 (`pd_entry_allowances`), and one
    `value_and_grad_fn` of `Model.batched_logdensity_t_fn()` at B = 64.
    Returns the value-and-gradient kernel as a `time_kernels` variant. The
    value-and-gradient kernel here is the one of a thread a column
    (`check_small_design` holds the small design on this model)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    model = tbt.Model(pdwide_model(dists, dev, torch.float32), device=dev)
    m64 = tbt.Model(pdwide_model(dists, dev, torch.float64), device=dev)
    dim = model.dim()
    expect(f"pdwide: dim {dim} == 1051", dim == 1051)
    rng = np.random.default_rng(5)
    vT = torch.as_tensor(0.5 * rng.standard_normal((dim, B)), dtype=torch.float32, device=dev)
    u = model.unconstrainer()
    cf, loops, c0sum = fk._prep(u, vT)
    cf64, loops64, c0sum64 = fk._prep(m64.unconstrainer(), vT.double())
    lp64, g64, lp_allow, g_allow = pd_entry_allowances(vT, cf64, loops64)
    lp, g = fk.slab_value_and_grad(vT, cf, loops, design="wide")
    lpp, gp = fb.slab_value_and_grad_plain(vT, cf, loops)
    check("pdwide: value-and-grad kernel lp vs plain", lp, lpp, 1.0, 2 * lp_allow)
    check("pdwide: value-and-grad kernel g vs plain", g, gp, 1.0, 2 * g_allow)
    check("pdwide: value-and-grad kernel lp vs float64", lp, lp64, 1.0, lp_allow)
    check("pdwide: value-and-grad kernel g vs float64", g, g64, 1.0, g_allow)
    ones = torch.ones(B, device=dev)
    check("pdwide: vjp kernel vs plain", fk.slab_vjp(vT, cf, ones, loops),
          fb.slab_vjp_plain(vT, cf, ones, loops), 1.0, 2 * g_allow)
    lp_e, g_e = model.batched_logdensity_t_fn().value_and_grad_fn(vT[:, :CHAINS].contiguous())
    check("pdwide: value_and_grad_fn lp at B = 64 vs float64", lp_e,
          lp64[:CHAINS] + c0sum64, 1.0, lp_allow[:CHAINS] + RTOL_LP * abs(float(c0sum64)))
    check("pdwide: value_and_grad_fn g at B = 64 vs float64", g_e, g64[:, :CHAINS], 1.0,
          g_allow[:, :CHAINS])
    slab = B * sum(2 + OPS["value_and_grad"]["quad"] for r in range(dim) if cf[r, fb._MASK_COL] > 0)
    nbytes = 2 * vT.numel() * 4 + B * 4 + cf.numel() * 4 + loops.prm.numel() * 4
    return {"slab_value_and_grad with the PD entry, table in global memory (pdwide)": (
        lambda: fk.slab_value_and_grad(vT, cf, loops, design="wide"), nbytes,
        slab + B * (PD_OPS["dot"] + PD_OPS["dot_grad"] - 216),
        lambda: fb.slab_value_and_grad_plain(vT, cf, loops))}


LKJ_BIG_K = 64


def check_lkj64(dev, B=4096):
    """The LKJ inverse #6 at large K: K = 64 at B = 4096 (states 0.5
    N(0, 1), numpy seed 6; a warp an element, its tiles in shared memory)
    against the plain version and float64, and `Model.constrain` of 64 draws
    of a model with an LKJ(64, 2.0) leaf; then the kernel that packs one
    element's factor in shared memory (beyond K = 138), at K = 200 with 64
    elements and at the wrapper's largest K with 4 (numpy seed 7), against
    float64. X exactly symmetric throughout. Bounds from the sums done: a
    column's running sum of up to K - 1 logcosh terms within (K - 1) eps of
    their sum, which exp carries into W relatively; X = W'W within K eps
    (|W's columns| = 1) plus twice W's relative error; logJ, a sum of
    K(K-1)/2 + K same-signed running sums, within (K + K(K-1)/2) eps of its
    magnitude."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.utils import logcosh, vec_to_triu

    K = LKJ_BIG_K
    P = K * (K - 1) // 2
    rng = np.random.default_rng(6)
    y = torch.as_tensor(0.5 * rng.standard_normal((B, P)), dtype=torch.float32, device=dev)
    kernels.reset_launch_counts()
    X, lj, ld, W = kl.lkj_inverse(y, K, want_w=True)
    torch.cuda.synchronize()
    expect("lkj_inverse at K = 64 launched its kernel", kernels.LAUNCHES["lkj_inverse"] == 1)
    Xp, ljp, ldp, Wp = kl.lkj_inverse_plain(y, K, want_w=True)
    X64, lj64, ld64, W64 = kl.lkj_inverse_plain(y.double(), K, want_w=True)
    col = logcosh(vec_to_triu(y.double(), 1, K)).sum(-2).max(-1).values  # (B,)
    w_rel = EPS32 * ((K - 1) * col + 4)
    x_allow = (K * EPS32 + 2 * w_rel)[:, None, None].expand(B, K, K)
    lj_allow = (K + P) * EPS32 * lj64.abs() + 1e-6
    check("lkj_inverse K = 64: X vs plain", X, Xp, 1.0, 2 * x_allow)
    check("lkj_inverse K = 64: X vs float64", X, X64, 1.0, x_allow)
    check("lkj_inverse K = 64: W vs float64", W, W64, 1.0, x_allow)
    check("lkj_inverse K = 64: log diag W vs float64", ld, ld64, 1.0,
          (w_rel[:, None] + EPS32 * ld64.abs()).expand(B, K))
    check("lkj_inverse K = 64: logJ vs plain", lj, ljp, 1.0, 2 * lj_allow)
    check("lkj_inverse K = 64: logJ vs float64", lj, lj64, 1.0, lj_allow)
    expect("lkj_inverse K = 64: X exactly symmetric", torch.equal(X, X.mT))
    model = tbt.Model(dists.NamedProduct.of(
        c=dists.LKJ(K, 2.0, device=dev), m=dists.Normal(0.0, 1.0, device=dev)), device=dev)
    v = torch.cat([y[:CHAINS], torch.zeros((CHAINS, 1), device=dev)], 1)
    kernels.reset_launch_counts()
    x = model.constrain(v)
    torch.cuda.synchronize()
    expect("Model.constrain with an LKJ(64) leaf launched lkj_inverse",
           kernels.LAUNCHES["lkj_inverse"] > 0)
    check("Model.constrain's LKJ(64) X vs float64", x["c"], X64[:CHAINS], 1.0, x_allow[:CHAINS])
    rng = np.random.default_rng(7)
    for Kb, n in ((200, CHAINS), (kl.MAX_K, 4)):
        Pb = Kb * (Kb - 1) // 2
        yb = torch.as_tensor(0.5 * rng.standard_normal((n, Pb)), dtype=torch.float32, device=dev)
        kernels.reset_launch_counts()
        Xb, ljb, ldb, Wb = kl.lkj_inverse(yb, Kb, want_w=True)
        torch.cuda.synchronize()
        tag = f"lkj_inverse K = {Kb}, B = {n}"
        expect(f"{tag} launched its kernel", kernels.LAUNCHES["lkj_inverse"] == 1)
        Xr, ljr, ldr, Wr = kl.lkj_inverse_plain(yb.double(), Kb, want_w=True)
        col = logcosh(vec_to_triu(yb.double(), 1, Kb)).sum(-2).max(-1).values
        wb_rel = EPS32 * ((Kb - 1) * col + 4)
        xb_allow = (Kb * EPS32 + 2 * wb_rel)[:, None, None].expand(n, Kb, Kb)
        check(f"{tag}: X vs float64", Xb, Xr, 1.0, xb_allow)
        check(f"{tag}: W vs float64", Wb, Wr, 1.0, xb_allow)
        check(f"{tag}: log diag W vs float64", ldb, ldr, 1.0,
              (wb_rel[:, None] + EPS32 * ldr.abs()).expand(n, Kb))
        check(f"{tag}: logJ vs float64", ljb, ljr, 1.0, (Kb + Pb) * EPS32 * ljr.abs() + 1e-6)
        expect(f"{tag}: X exactly symmetric", torch.equal(Xb, Xb.mT))
        del Xb, Wb, Xr, Wr
    # reads y, writes X, logJ and log diag W; ops as OPS_LKJ_SLOT per slot and
    # X = W'W's K(K+1)(K+2)/6 multiply-adds
    tri3 = K * (K + 1) * (K + 2) // 6
    return {"lkj_inverse K = 64 (contiguous)": (
        lambda: kl.lkj_inverse(y, K), B * 4 * (P + K * K + 1 + K),
        B * (P * OPS_LKJ_SLOT + 2 * tri3), lambda: kl.lkj_inverse_plain(y, K))}


# --- the slab-served families (the sixth slice) -------------------------------

# families: the JAX package's whole-family model (tests/test_transposed_layout.py:
# 139-182, `_mega_model`), linked dim 125 in 37 plan entries; its states
# 0.5 N(0, 1) from numpy seed 5, the tangent N(0, 1) from numpy seed 6
FAM_DIM = 125
FAM_SEED = 5
FAM_LC_ROW0 = 36  # the first of LKJCholesky(5)'s 10 rows (checked in path 12)
# the extremes block: 64 columns with every slab row at +-1e10
FAM_EXTREME_COLS = 64
# the kernels families batch-major serving must launch (cell 13): the LKJ
# log-det in both variants, the simplex kernels, the PD log-density and its
# backward, and the inverse links of the round trip
FAM_BATCH_MAJOR_KERNELS = (
    "lkj_logdet", "lkj_logdet_chol", "simplex_inverse_logdet", "simplex_inverse",
    "simplex_forward_logdet", "pd_logdensity", "pd_trace_grad", "lkj_inverse", "pd_inverse",
)


def families_model(dists, tbt, device, dtype):
    """The `families` model: every slab-served scalar family (IID blocks and
    per-element arraydist leaves among them), MvNormalDiag, MvLogNormal,
    Dirichlet, LKJ, LKJCholesky, the Wishart families, IID copies of
    structured leaves and a transformed Beta, exactly as the JAX test
    writes them."""
    kw = dict(device=device, dtype=dtype)
    d = dists
    return d.NamedProduct.of(
        mu=d.IIDProduct(d.Normal(0.5, 2.0, **kw), 8),
        sigma=d.IIDProduct(d.LogNormal(0.1, 0.5, **kw), 4),
        g=d.Gamma(2.0, 1.5, **kw),
        e=d.Exponential(0.8, **kw),
        ig=d.InverseGamma(3.0, 2.0, **kw),
        w=d.Dirichlet(np.ones(7) * 1.3, **kw),
        corr=d.LKJ(6, 2.0, **kw),
        lc=d.LKJCholesky(5, 1.5, **kw),
        wish=d.Wishart(8.0, np.eye(5), **kw),
        iwish=d.InverseWishart(8.0, np.eye(4), **kw),
        t=d.StudentT(4.5, 0.3, 1.7, **kw),
        c=d.Cauchy(-0.4, 0.9, **kw),
        lap=d.IIDProduct(d.Laplace(0.2, 1.3, **kw), 3),
        lo=d.Logistic(0.1, 0.8, **kw),
        gu=d.Gumbel(-0.3, 1.1, **kw),
        hn=d.HalfNormal(1.4, **kw),
        hc=d.HalfCauchy(0.7, **kw),
        wb=d.Weibull(1.8, 2.1, **kw),
        chi=d.Chi(3.0, **kw),
        ray=d.Rayleigh(1.2, **kw),
        fr=d.Frechet(2.3, 1.4, **kw),
        b=d.IIDProduct(d.Beta(2.5, 1.6, **kw), 2),
        un=d.Uniform(-2.0, 5.0, **kw),
        ln=d.LogitNormal(0.2, 0.9, **kw),
        par=d.Pareto(2.2, 1.5, **kw),
        lv=d.Levy(0.4, 1.3, **kw),
        mvd=d.MvNormalDiag([0.3, -0.2, 1.1], [0.8, 1.4, 0.5], **kw),
        mvln=d.MvLogNormal([0.1, -0.4], [0.6, 1.2], **kw),
        ad=d.arraydist(d.Normal([-1.0, 0.0, 2.0], [0.5, 1.0, 2.0], **kw)),
        adg=d.arraydist(d.Gamma([2.0, 3.5], [1.0, 0.7], **kw)),
        iidc=d.IIDProduct(d.LKJ(3, 1.5, **kw), 2),
        iidd=d.IIDProduct(d.Dirichlet([1.3, 2.0, 0.8, 1.1], **kw), 2),
        iidw=d.IIDProduct(d.Wishart(6.0, np.eye(3), **kw), 2),
        td=tbt.transformed(d.Beta(2.0, 3.0, **kw)),
    )


def families_rows(u):
    """name -> the slice of the families model's linked rows."""
    return {n: slice(s, s + k) for n, (s, k) in zip(u.names, u.linked_offsets)}


def families_states(dev, B=BATCH):
    """(vT, dvT): the states 0.5 N(0, 1) and the tangent N(0, 1), (125, B)
    float32 on `dev`."""
    vT = 0.5 * np.random.default_rng(FAM_SEED).standard_normal((FAM_DIM, B))
    dvT = np.random.default_rng(FAM_SEED + 1).standard_normal((FAM_DIM, B))
    return (torch.as_tensor(vT, dtype=torch.float32, device=dev),
            torch.as_tensor(dvT, dtype=torch.float32, device=dev))


def families_allowances(vT, cf64, loops64):
    """Float64 (lp, g) of a model's fused plain version on vT, with slab
    rows and PD loop entries, and the error float32 may carry: the slab
    rows' terms and c0 at RTOL_LP of their magnitudes (as
    `slab_allowances`), each partial at RTOL_G of its terms' magnitudes,
    and each PD entry's pieces as `pd_entry_allowances` holds them. Returns (lp64, g64, lp_allow,
    g_allow, the terms' magnitude)."""
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.vectorize import fused_base as fb

    vT64 = vT.double()
    lp64, g64 = fb.slab_value_and_grad_plain(vT64, cf64, loops64)
    groups, used = fb._groups_and_used(cf64)
    # each term group's value and partial on its own: a row's partial is a
    # sum of up to five terms that may cancel (LKJ's -w tanh(y) is
    # -w sign(y) (1 - 2 sigmoid(-2|y|)))
    terms = [fb._group_val_par(gr, vT64, cf64, used, True, True, False) for gr in groups]
    mag = sum(v.abs() for v, _ in terms).sum(0) + cf64[:, fb._CI["c0"]].abs().sum()
    lp_allow = RTOL_LP * mag + 1e-6
    g_allow = RTOL_G * (g64.abs() + sum(p.abs() for _, p in terms)) + 1e-6
    for code, row0, K, off in loops64.entries:
        if code not in fb.PD_MODES:
            raise ValueError(f"loop kind {code} has no allowance here")
        blk = loops64.prm[off: off + K * K + 2]
        C, w, const = blk[: K * K].reshape(K, K), blk[K * K], blk[K * K + 1]
        r = slice(row0, row0 + K * (K + 1) // 2)
        logJ, sumd, tr, gt, tr_allow, gt_allow, _ = pd_reference(vT[r].T, C, fb.PD_MODES[code])
        emag = logJ.abs() + (w * sumd).abs() + const.abs() + 0.5 * tr.abs()
        mag = mag + emag
        lp_allow = lp_allow + RTOL_LP * emag + 0.5 * tr_allow
        coeff, diag = kp.affine_coeffs(K, gt)
        g_allow[r] += (0.5 * gt_allow + RTOL_G * ((coeff + w * diag).abs() + 0.5 * gt.abs())).T
    return lp64, g64, lp_allow, g_allow, mag


def families_extremes(vT, cf):
    """The extremes block: the first FAM_EXTREME_COLS columns of vT with
    every slab row at +-1e10 (signs from numpy seed 7), except that in the
    second half of the columns the rows of the exp group sit on the side
    where exp(ea V) underflows, so that their lp stays finite; the PD rows
    keep their states."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    n = FAM_EXTREME_COLS
    vx = vT[:, :n].clone()
    sign = torch.as_tensor(np.sign(np.random.default_rng(7).standard_normal((vT.shape[0], n))),
                           dtype=vT.dtype, device=vT.device)
    exp_rows = cf[:, fb._CI["c5"]] != 0
    sign[exp_rows, n // 2:] = -torch.sign(cf[exp_rows, fb._CI["ea"]])[:, None]
    slab = cf[:, fb._MASK_COL] > 0
    vx[slab] = 1e10 * sign[slab]
    return vx


def check_extremes(tag, got, ref, allow):
    """got and ref carry the same finite / +inf / -inf pattern and no NaN,
    and agree within `allow` where finite."""
    expect(f"{tag}: no NaN, nor in the plain version",
           not bool(torch.isnan(got).any() or torch.isnan(ref).any()))
    fin = torch.isfinite(ref)
    same = torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], ref[~fin])
    expect(f"{tag}: the plain version's finite/inf pattern ({int((~fin).sum())} infinite)",
           same)
    if fin.any():
        check(f"{tag}: finite values vs plain", got[fin], ref[fin], 1.0, allow[fin])


def run_families_transposed_serving(dev):
    """Path 12: transposed serving of `families` at B = 131072 in all four
    modes of the whole-model kernel through the public calls:
    `batched_logdensity_t_fn()`, its `value_and_grad_fn`, autograd's
    backward and `torch.func.jvp` of `linked_logdensity_t`; slab rows of
    every term group (the exp and log1p groups, per-element coefficients)
    and the PD loop entries (Wishart(5), InverseWishart(4), two Wishart(3)
    copies sharing one parameter block); the counters zeroed just before
    and read just after. Each against float64 and each kernel against its
    plain version at `families_allowances`, lp against the composed
    per-leaf path within RTOL_COMPOSED of the terms' magnitude; and the
    extremes block (`families_extremes`) in every mode against the plain
    versions. Returns (launches, vT, dvT, lp, g, the kernels' max errors,
    the entry points' times, (cf, loops) of the model)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    model = tbt.Model(families_model(dists, tbt, dev, torch.float32), device=dev)
    m64 = tbt.Model(families_model(dists, tbt, dev, torch.float64), device=dev)
    u = model.unconstrainer()
    expect(f"families: dim {model.dim()} == {FAM_DIM}, LKJCholesky's rows from {FAM_LC_ROW0}",
           model.dim() == FAM_DIM and families_rows(u)["lc"].start == FAM_LC_ROW0)
    vT, dvT = families_states(dev)
    f = model.batched_logdensity_t_fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(vT)
    lp_vg, g = f.value_and_grad_fn(vT)
    vr = vT.detach().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(u.linked_logdensity_t(vr).sum(), vr)
    lp_j, dlp = torch.func.jvp(u.linked_logdensity_t, (vT,), (dvT,))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the families transposed serving path: {launches}", flush=True)
    expect(f"{SMALL} not launched on the families transposed serving path", launches[SMALL] == 0)
    for k in SLAB_KERNELS + ("slab_jvp",):
        expect(f"{k} launched on the families transposed serving path", launches[k] > 0)
    B = vT.shape[1]
    expect("families: lp (B,), g (125, B), dlp (B,)",
           lp.shape == (B,) and g.shape == (FAM_DIM, B) and dlp.shape == (B,))
    cf, loops, c0sum = fk._prep(u, vT)
    cf64, loops64, c0sum64 = fk._prep(m64.unconstrainer(), vT.double())
    print(f"families loop entries (kind, first row, K, offset): {loops.entries}", flush=True)
    expect("families: the two iidw copies share one parameter block",
           loops.entries[-1][3] == loops.entries[-2][3])
    lp64, g64, lp_allow, g_allow, mag = families_allowances(vT, cf64, loops64)
    lp64 = lp64 + c0sum64
    dlp64 = (g64 * dvT.double()).sum(0)
    j_allow = jvp_allowance(g64, g_allow, dvT)
    check("families: linked_logdensity_t vs float64", lp, lp64, 1.0, lp_allow)
    check("families: value_and_grad_fn lp vs float64", lp_vg, lp64, 1.0, lp_allow)
    check("families: value_and_grad_fn g vs float64", g, g64, 1.0, g_allow)
    check("families: autograd g vs float64", g_ag, g64, 1.0, g_allow)
    check("families: torch.func.jvp lp vs float64", lp_j, lp64, 1.0, lp_allow)
    check("families: torch.func.jvp dlp vs float64", dlp, dlp64, 1.0, j_allow)
    comp = u._linked_logdensity_t_children(vT)
    check("families: linked_logdensity_t vs composed", lp, comp, RTOL_COMPOSED, mag)
    ct = torch.ones(B, device=dev)
    err = {}
    err["slab_value"] = check("families value kernel vs plain", fk.slab_value(vT, cf, loops),
                              fb.slab_value_plain(vT, cf, loops), 1.0, 2 * lp_allow)
    lp_k, g_k = fk.slab_value_and_grad(vT, cf, loops)
    lp_p, g_p = fb.slab_value_and_grad_plain(vT, cf, loops)
    err["slab_value_and_grad"] = max(
        check("families value-and-grad kernel lp vs plain", lp_k, lp_p, 1.0, 2 * lp_allow),
        check("families value-and-grad kernel g vs plain", g_k, g_p, 1.0, 2 * g_allow))
    err["slab_vjp"] = check("families vjp kernel vs plain", fk.slab_vjp(vT, cf, ct, loops),
                            fb.slab_vjp_plain(vT, cf, ct, loops), 1.0, 2 * g_allow)
    err["slab_jvp"] = check("families jvp kernel vs plain", fk.slab_jvp(vT, cf, dvT, loops),
                            fb.slab_jvp_plain(vT, cf, dvT, loops), 1.0, 2 * j_allow)
    del lp_k, g_k, lp_p, g_p, g64, comp

    # the extremes block: Gamma's c5 exp(V) is -inf at V = +1e10, and its
    # partial c5 ea e too; InverseGamma's at -1e10; no term is 0 * inf
    vx = families_extremes(vT, cf)
    n = vx.shape[1]
    _, _, lpx_allow, gx_allow, _ = families_allowances(vx, cf64, loops64)
    dvx = dvT[:, :n].contiguous()
    ctx = ct[:n].contiguous()
    lpx_p, gx_p = fb.slab_value_and_grad_plain(vx, cf, loops)
    check_extremes("families extremes: value kernel", fk.slab_value(vx, cf, loops), lpx_p,
                   2 * lpx_allow)
    lpx_k, gx_k = fk.slab_value_and_grad(vx, cf, loops)
    check_extremes("families extremes: value-and-grad kernel lp", lpx_k, lpx_p, 2 * lpx_allow)
    check_extremes("families extremes: value-and-grad kernel g", gx_k, gx_p, 2 * gx_allow)
    check_extremes("families extremes: vjp kernel", fk.slab_vjp(vx, cf, ctx, loops),
                   fb.slab_vjp_plain(vx, cf, ctx, loops), 2 * gx_allow)
    fin = torch.isfinite(gx_p).all(0)
    expect(f"families extremes: {int((~fin).sum())} of {n} columns carry an infinite partial, "
           f"{int(torch.isfinite(lpx_p).sum())} a finite lp",
           bool((~fin).any()) and bool(fin.any()) and bool(torch.isfinite(lpx_p).any()))
    check_extremes("families extremes: jvp kernel, columns of finite partials",
                   fk.slab_jvp(vx, cf, dvx, loops)[fin],
                   fb.slab_jvp_plain(vx, cf, dvx, loops)[fin],
                   2 * jvp_allowance(gx_p.double(), gx_allow, dvx)[fin])
    expect("families extremes: lp -inf where a Gamma-type row sits at +1e10",
           bool(torch.isneginf(lpx_p).any()))
    v64 = vT[:, :CHAINS].contiguous()
    e2e = {
        "families_value_ms_B131072": time_ms(lambda: f(vT), device_only=False),
        "families_value_and_grad_ms_B131072": time_ms(lambda: f.value_and_grad_fn(vT),
                                                      device_only=False),
        "families_value_and_grad_ms_B64": time_ms(lambda: f.value_and_grad_fn(v64),
                                                  device_only=False),
        "families_func_jvp_ms_B131072": time_ms(
            lambda: torch.func.jvp(u.linked_logdensity_t, (vT,), (dvT,)), device_only=False),
    }
    return launches, vT, dvT, lp, g, err, e2e, (cf, loops)


def run_families_batch_major_serving(dev, vT, lp_t, g_t):
    """Path 13: batch-major serving of `families` on the same states as
    (B, 125): `Model.batched_logdensity_fn()` and its `value_and_grad_fn`
    (the LKJ log-det kernel for corr and the iidc copies, its Cholesky
    variant for lc, the simplex inverse kernel for w and the iidd copies,
    the PD log-density kernel and its backward for wish, iwish and the iidw
    copies; the scalar links in torch, as the JAX package leaves them to
    jnp), the round trip `to_linked_vec(from_linked_vec(v))` (the inverse
    links and the simplex forward kernel) and the classic
    `inverse(bijector(Dirichlet))` (the x-only simplex inverse) on w and
    iidd; the counters zeroed just before and read just after. Checks lp
    and g against path 12's and float64 on the CPU (4096 rows), and the
    round trip. Returns (launches, the entry points' times, the Cholesky
    variant's max error against its plain version)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    model = tbt.Model(families_model(dists, tbt, dev, torch.float32), device=dev)
    u = model.unconstrainer()
    rows = families_rows(u)
    v = vT.T.contiguous()
    f = model.batched_logdensity_fn()
    # the stick-breaking link of any K, and the w and iidd rows' K - 1
    ib = tbt.inverse(tbt.bijector(dists.Dirichlet(np.ones(3), device=dev)))
    simplex_rows = {"w": 6, "iidd": 3}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(v)
    lp_vg, g = f.value_and_grad_fn(v)
    x, ld = u.from_linked_vec(v)
    v2, ld2 = u.to_linked_vec(x)
    xw = {n: ib.forward(v[:, rows[n]].reshape(BATCH, -1, k)) for n, k in simplex_rows.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the families batch-major serving path: {launches}", flush=True)
    for k in FAM_BATCH_MAJOR_KERNELS:
        expect(f"{k} launched on the families batch-major serving path", launches[k] > 0)
    expect("families batch-major: lp (B,) and g (B, 125)",
           lp.shape == (BATCH,) and g.shape == (BATCH, FAM_DIM))
    m64 = tbt.Model(families_model(dists, tbt, dev, torch.float64), device=dev)
    cf64, loops64, _ = fk._prep(m64.unconstrainer(), vT.double())
    _, _, lp_allow, g_allow, mag = families_allowances(vT, cf64, loops64)
    check("families batch-major: lp vs value_and_grad_fn lp", lp_vg, lp, 1.0, lp_allow)
    # the composed Dirichlet is eps-nudged, the fused one not
    check("families batch-major: lp vs fused transposed lp", lp, lp_t, RTOL_COMPOSED, mag)
    check("families batch-major: g vs fused transposed g", g, g_t.T, RTOL_VJP,
          g_t.abs().T + 1e-2 * g_t.abs().max())
    r = slice(0, 4096)
    cpu = tbt.Model(families_model(dists, tbt, "cpu", torch.float64), device="cpu")
    lp64, g64 = cpu.batched_logdensity_fn().value_and_grad_fn(v[r].double().cpu())
    check("families batch-major: lp vs float64 CPU, 4096 rows", lp[r].cpu(), lp64,
          RTOL_COMPOSED, mag[r].cpu())
    check("families batch-major: g vs float64 CPU, 4096 rows", g[r].cpu(), g64, RTOL_VJP,
          g64.abs() + 1e-2 * g64.abs().max())
    # the round trip: elementwise links and the simplex rows absolutely;
    # the rows of the matrix leaves through a Cholesky factorization of X
    # (LKJ, the Wishart families), each state's row error within
    # kappa(X) eps32 + ATOL_ROUNDTRIP; the LKJCholesky rows absolutely
    matrix = ("corr", "iidc", "wish", "iwish", "iidw")
    flat = torch.ones(FAM_DIM, dtype=torch.bool, device=dev)
    for n in matrix:
        flat[rows[n]] = False
    check("families round trip v -> x -> v, elementwise, simplex and LKJCholesky rows",
          v2[:, flat], v[:, flat], ATOL_ROUNDTRIP, torch.ones_like(v[:, flat]))
    for n in matrix:
        X = x[n].double().cpu()
        ev = torch.linalg.eigvalsh(X)
        kappa = (ev[..., -1] / ev[..., 0]).reshape(BATCH, -1).amax(-1)
        row_err = (v2[:, rows[n]] - v[:, rows[n]]).abs().amax(dim=1).double().cpu()
        ratio = float((row_err / (kappa * EPS32 + ATOL_ROUNDTRIP)).max())
        expect(f"families round trip, {n} rows within kappa(X) eps32 + {ATOL_ROUNDTRIP:g} "
               f"(max kappa {float(kappa.max()):.3e}, max error / bound {ratio:.3e})",
               ratio <= 1.0)
    check("families round trip: to_linked_vec's log-det is minus from_linked_vec's", ld2, -ld,
          RTOL_ROUNDTRIP_LD, ld.abs() + 1e-3 * ld.abs().max())
    for n, xi in xw.items():
        expect(f"families: the x-only simplex inverse of {n} equals from_linked_vec's",
               bool(torch.allclose(xi.reshape(x[n].shape), x[n], rtol=0, atol=ATOL_UNIT)))
    del x, v2
    # #5's Cholesky variant against its plain version on the lc rows
    ylc = v[:, rows["lc"]]
    got, ref = kl.lkj_logdet(ylc, 5, True), kl.lkj_logdet_plain(ylc, 5, True)
    err = max(check("lkj_logdet chol=True logJ vs plain (lc, batch-major slice)", got[0],
                    ref[0], RTOL_SUM, ref[0].abs() + 1e-3 * ref[0].abs().max()),
              check("lkj_logdet chol=True log diag vs plain (lc, batch-major slice)", got[1],
                    ref[1], RTOL_SUM, ref[1].abs() + 1e-3 * ref[1].abs().max()))
    v64 = v[:CHAINS].contiguous()
    e2e = {
        "families_batch_major_value_ms_B131072": time_slow_ms(lambda: f(v), device_only=False),
        "families_batch_major_value_and_grad_ms_B131072": time_slow_ms(
            lambda: f.value_and_grad_fn(v), device_only=False),
        "families_batch_major_value_and_grad_ms_B64": time_slow_ms(
            lambda: f.value_and_grad_fn(v64), device_only=False),
    }
    return launches, e2e, err


def families_variants(vT, dvT, cf, loops):
    """`model_variants` of `families` at B = 131072, each PD entry's
    operations from `pd_ops` (the unpacking of y shared by the value and
    the gradient)."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    B = vT.shape[1]
    pd = dict.fromkeys(OPS, 0)
    for code, _, K, _ in loops.entries:
        m, po = fb.PD_MODES[code], pd_ops(K)
        pd["value"] += B * po[m]
        pd["value_and_grad"] += B * (po[m] + po[m + "_grad"] - (K * (K + 1) // 2 + 5 * K))
        pd["vjp"] += B * po[m + "_grad"]
        pd["jvp"] += B * (po[m + "_grad"] + K * (K + 1))
    return model_variants("(families)", vT, dvT, cf, loops, pd)


# --- eight schools, non-centered (the sixth slice's sampler cell) -----------

# Rubin's (1981) data, as examples/eight_schools_nuts.py
ES_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
ES_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)
# the example's starts 0.5 N(0, 1) and its target acceptance 0.8; chains,
# depth, warmup and kept draws as the other sampler cells
ES_INIT_SCALE, ES_TARGET = 0.5, 0.8
# the JAX package's own float64 CPU run of the same model and settings with
# 4000 kept draws a chain (nuts_batched_t, jax.random.PRNGKey(0)):
#   python tests/test_torch_eight_schools.py --engine jax --kept 4000
# the posterior means of mu and tau and their MCSE
ES_JAX = {"mu": (4.3613426994105104, 0.012813402441898816),
          "tau": (3.6889598000248975, 0.014590762749884878)}


def eight_schools_exact_means():
    """The posterior means of mu and tau by quadrature (float64 numpy): mu
    and theta integrate out in closed form (y_j ~ N(mu, sigma_j^2 + tau^2),
    mu ~ N(0, 25)), leaving a one-dimensional density of tau, summed on
    20000 points of log tau in [-12, 12]. They are 4.39682 and 3.59771.
    ES_JAX's tau lies 6 of its MCSE above them and its mu 2.8 below: the
    NUTS run that made ES_JAX is biased there (it diverges in the funnel
    at target 0.8, as the port's cells 14 and 20 do, which are held to
    it), so the SMC cell is held to these."""
    y, sigma = np.asarray(ES_Y), np.asarray(ES_SIGMA)
    log_tau = np.linspace(-12.0, 12.0, 20000)
    tau = np.exp(log_tau)
    V = sigma[None, :] ** 2 + tau[:, None] ** 2
    prec = np.sum(1.0 / V, axis=1) + 1.0 / 25.0
    b = np.sum(y[None, :] / V, axis=1)
    log_w = (-0.5 * np.sum(np.log(V), axis=1) - 0.5 * np.sum(y[None, :] ** 2 / V, axis=1)
             + 0.5 * b**2 / prec - 0.5 * np.log(prec) - np.log1p((tau / 5.0) ** 2) + log_tau)
    w = np.exp(log_w - log_w.max())
    w /= w.sum()
    return {"mu": float(np.sum(w * b / prec)), "tau": float(np.sum(w * tau))}


def eight_schools_model(dists, device, dtype):
    """The example's priors: mu ~ Normal(0, 5), tau ~ HalfCauchy(5),
    theta_raw ~ IIDProduct(Normal(0, 1), 8); linked dim 10."""
    kw = dict(device=device, dtype=dtype)
    return dists.NamedProduct.of(
        mu=dists.Normal(0.0, 5.0, **kw),
        tau=dists.HalfCauchy(5.0, **kw),
        theta_raw=dists.IIDProduct(dists.Normal(0.0, 1.0, **kw), 8),
    )


def eight_schools_loglik(device, dtype):
    """The example's likelihood (user code), non-centered: theta = mu +
    tau theta_raw, sum of -((y - theta) / sigma)^2 / 2."""
    y = torch.as_tensor(ES_Y, dtype=dtype, device=device)
    sigma = torch.as_tensor(ES_SIGMA, dtype=dtype, device=device)

    def loglik(x):
        theta = x["mu"] + x["tau"] * x["theta_raw"]
        return torch.sum(-0.5 * ((y - theta) / sigma) ** 2)

    return loglik


def run_eight_schools(dev):
    """Path 14, the eight_schools cell: the steps of `Model(priors,
    loglik).sample(kernel='auto')` (`nuts_batched_t`: each leapfrog runs the
    value-and-gradient kernel on HalfCauchy's lin, absv and sp rows and the
    Normal rows), `warmup_and_sample` from `Model.init_positions(gen, 64,
    0.5)` for the warmup and `resume_sampling` for the draws; 64 chains,
    max_depth 8, 300 warmup and 200 kept transitions, target 0.8, torch
    seed 0. Gates: R-hat <= 1.05 over the 10 coordinates, divergences <=
    1%, the means of mu and tau within 5 combined MCSE of the JAX package's
    (ES_JAX)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, resume_sampling, warmup_and_sample

    model = tbt.Model(eight_schools_model(dists, dev, torch.float32),
                      loglik=eight_schools_loglik(dev, torch.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    kernel = model._auto_kernel()
    expect(f"eight_schools: kernel='auto' takes nuts_batched_t (took {kernel})",
           kernel == "nuts_batched_t")
    density = model.batched_logdensity_t_fn()
    _, state, _ = warmup_and_sample(
        density, gen, model.init_positions(gen, CHAINS, ES_INIT_SCALE), n_warmup=WARMUP,
        n_samples=0, kernel=kernel, max_depth=MAX_DEPTH, target_accept=ES_TARGET,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, s1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    raw, state, stats = resume_sampling(density, state, KEPT, kernel=kernel, max_depth=MAX_DEPTH)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2, s2 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    x = model.constrain(raw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the eight_schools sampler path: {launches}", flush=True)
    expect(f"{SMALL} launched on the eight_schools sampler path", launches[SMALL] > 0)
    during = {k: l2[k] - l1[k] for k in l2}
    leapfrogs = during[SMALL]
    sampling_s = t2 - t1
    expect("eight_schools: raw draws (200, 64, 10) and finite",
           tuple(raw.shape) == (KEPT, CHAINS, 10) and bool(torch.isfinite(raw).all()))
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    n_div = int(stats.diverging.sum())
    dev_in_mcse = {}
    for k in ("mu", "tau"):
        draws = x[k].double()
        mean, mcse = float(draws.mean()), float(diagnostics.mcse_mean(draws))
        ref_mean, ref_mcse = ES_JAX[k]
        dev_in_mcse[k] = abs(mean - ref_mean) / math.hypot(mcse, ref_mcse)
        print(f"eight_schools: {k} mean {mean:.4f} (MCSE {mcse:.4f}); the JAX package's "
              f"{ref_mean:.4f} (MCSE {ref_mcse:.4f})", flush=True)
    line = {
        "kernel": "nuts_batched_t", "cell": "eight_schools",
        "chains": CHAINS, "warmup": WARMUP, "kept": KEPT, "max_depth": MAX_DEPTH,
        "target_accept": ES_TARGET, "init_scale": ES_INIT_SCALE,
        "warmup_s": t1 - t0,
        "sampling_s": sampling_s,
        "constrain_s": t3 - t2,
        "draws_per_s": CHAINS * KEPT / sampling_s,
        "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": (s2 - s1) / max(leapfrogs, 1),
        "step_size": float(state.eps),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "transitions": CHAINS * KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "min_ess_bulk": float(np.min(ess)),
        "mu_dev_in_mcse": dev_in_mcse["mu"],
        "tau_dev_in_mcse": dev_in_mcse["tau"],
    }
    expect(f"eight_schools: max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"eight_schools: divergences {n_div} <= 1% of {CHAINS * KEPT}",
           n_div <= 0.01 * CHAINS * KEPT)
    for k, d in dev_in_mcse.items():
        expect(f"eight_schools: the mean of {k} within 5 combined MCSE of the JAX package's "
               f"({d:.2f})", d <= 5.0)
    return line


def run_probe(dev):
    """Path 15, the #13 probe: every variant of `kernels/probe.py` against
    its plain version at dim 151, B = 131072 (lp within RTOL_SUM of the sum
    of |terms| in float64; floor_g's g = X + 1 within ATOL_UNIT), then the
    probe's driver (`probe.run`, the counters zeroed just before and read
    just after), which times every variant with CUDA events. Returns
    (launches, the driver's rows, max error, the floor variant's inputs,
    each variant's plain version's time)."""
    from tpu_bijectors_torch import kernels
    from tpu_bijectors_torch.kernels import probe

    vT, c = probe.inputs(dev)
    err = 0.0
    for v in probe.VARIANTS:
        got, ref = probe.probe(v, vT, c), probe.probe_plain(v, vT, c)
        ref64 = probe.probe_plain(v, vT.double(), c.double())
        if v == "floor_g":
            err = max(err, check(f"probe {v} g vs plain", got[1], ref[1], ATOL_UNIT,
                                 torch.ones_like(ref[1])))
            got, ref, ref64 = got[0], ref[0], ref64[0]
        mag = probe.magnitude(v, vT.double(), c.double())
        err = max(err, check(f"probe {v} lp vs plain", got, ref, RTOL_SUM, mag))
        check(f"probe {v} lp vs float64", got, ref64, RTOL_SUM, mag)
    plain_ms = {v: time_slow_ms(lambda v=v: probe.probe_plain(v, vT, c)) for v in probe.VARIANTS}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rows = probe.run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the probe's path: {launches}", flush=True)
    expect("transcend_probe launched by the probe's driver", launches["transcend_probe"] > 0)
    for r in rows:
        r["plain_us"] = 1e3 * plain_ms[r["variant"]]
    print(json.dumps({"transcend_probe": rows}), flush=True)
    return launches, rows, err, (vT, c)


# --- the traced entries (the seventh slice's cells 16-18) -------------------

TRACED_DIM = 12
# the states 0.6 N(0, 1) (numpy seed 7) and the tangent N(0, 1) (seed 8)
TRACED_SEED, TRACED_TANGENT_SEED, TRACED_STATE_SCALE = 7, 8, 0.6
TRACED_EXTREME_COLS = 64
# a float32 straight-line tape rounds each result; its error is held to
# RTOL_TAPE of the sum of the magnitudes of every value (for lp) or every
# tangent (for a partial) its tape forms, in float64 (`traced_allowances`)
RTOL_TAPE = 1e-5
# the sampler cell's settings: the prior alone, 0.3 N(0, 1) starts, target
# 0.8, and 1000 kept draws: at 200 the mixture's coordinate, its modes at
# -2 and 3 crossed rarely, passed R-hat 1.05 on the card, and the JAX
# package's sampler passes it on 8 of 10 seeds at 200 and on none at 1000
# (tests/test_torch_traced_witness.py, run as a script, samples the cell
# in either package)
TRACED_INIT_SCALE, TRACED_TARGET, TRACED_KEPT = 0.3, 0.8, 1000
# the exact means of the generic-traced prior (scipy, float64 quadrature:
# truncnorm, t restricted to x > 0, b B(1 + 1/a, b), a / (b - 1), mu,
# johnsonsu, triang, the mixture's weights, the four order statistics'
# means of N(0.2, 1.3))
TRACED_MEANS = {
    "tn": (0.6105611200620137,), "tst": (1.1569068123998736,), "ku": (0.4571428571428571,),
    "bp": (0.8,), "ig": (1.2,), "js": (-0.40088828645675456,), "tri": (0.5,), "mx": (0.5,),
    "jo": (-1.138187984905159, -0.1861147969570391, 0.5861147969570388, 1.5381879849051536),
}


def traced_model(dists, device, dtype):
    """The `generic-traced` model of tools/tpu_sweep.py:92-104, exactly as
    written: two truncated priors, five families with no slab form, a
    two-component Normal mixture and the joint order statistics of four
    N(0.2, 1.3) draws; linked dim 12, nine traced entries."""
    kw = dict(device=device, dtype=dtype)
    d = dists
    return d.NamedProduct.of(
        tn=d.Truncated(d.Normal(0.3, 1.2, **kw), lower=-0.5, upper=2.0),
        tst=d.Truncated(d.StudentT(4.0, 0.2, 1.1, **kw), lower=0.0),
        ku=d.Kumaraswamy(2.0, 3.0, **kw),
        bp=d.BetaPrime(2.0, 3.5, **kw),
        ig=d.InverseGaussian(1.2, 2.0, **kw),
        js=d.JohnsonSU(0.1, 1.2, 0.3, 1.1, **kw),
        tri=d.TriangularDist(-1.0, 2.0, 0.5, **kw),
        mx=d.Mixture(d.Normal([-2.0, 3.0], [1.0, 2.0], **kw), np.log([0.5, 0.5]), **kw),
        jo=d.JointOrderStatistics(d.Normal(0.2, 1.3, **kw), 4),
    )


def truncated_model(dists, device, dtype):
    """The JAX test's truncated-leaves model
    (tests/test_transposed_layout.py:273-283): the three interval branches,
    an IID block of three truncated Logistics (one traced entry over three
    rows) and a slab row; linked dim 8."""
    kw = dict(device=device, dtype=dtype)
    d = dists
    return d.NamedProduct.of(
        tn=d.Truncated(d.Normal(0.3, 1.2, **kw), lower=-0.5, upper=2.0),
        tlo=d.Truncated(d.Cauchy(0.0, 1.0, **kw), lower=0.4),
        thi=d.Truncated(d.Gumbel(0.1, 0.9, **kw), upper=1.5),
        iid=d.IIDProduct(d.Truncated(d.Logistic(0.0, 0.7, **kw), lower=-1.0, upper=1.0), 3),
        tln=d.Truncated(d.LogNormal(0.2, 0.6, **kw), upper=3.0),
        mu=d.Normal(0.0, 2.0, **kw),
    )


def vector_model(dists, device, dtype):
    """The JAX test's vector-leaves model (:381-385): two
    JointOrderStatistics (traced vector entries of 4 and 3 rows) and a
    slab row; linked dim 8."""
    kw = dict(device=device, dtype=dtype)
    d = dists
    return d.NamedProduct.of(
        jo=d.JointOrderStatistics(d.Normal(0.2, 1.3, **kw), 4),
        jg=d.JointOrderStatistics(d.Gamma(2.0, 1.0, **kw), 3),
        mu=d.Normal(0.0, 2.0, **kw),
    )


TRACED_MODELS = {"generic-traced": traced_model, "truncated-leaves": truncated_model,
                 "vector-leaves": vector_model}

# every model the paths drive, (dists, tbt, device, dtype) -> its
# distribution: the small design of #2 is held to its plain version on each
# (`check_small_design`)
ITEM_MODELS = {
    "bench": lambda d, t, dev, dt: bench_model(d, dev, dt),
    "pdonly": lambda d, t, dev, dt: pd_model(d, dev, dt, "wishart"),
    "pdonly-invwishart": lambda d, t, dev, dt: pd_model(d, dev, dt, "invwishart"),
    "mvdense": lambda d, t, dev, dt: mvdense_model(d, dev, dt)[0],
    "families": families_model,
    "eight-schools": lambda d, t, dev, dt: eight_schools_model(d, dev, dt),
    **{k: (lambda d, t, dev, dt, f=f: f(d, dev, dt)) for k, f in TRACED_MODELS.items()},
    "wide": lambda d, t, dev, dt: wide_model(d, dev, dt),
    "pdwide": lambda d, t, dev, dt: pdwide_model(d, dev, dt),
}


def traced_states(dev, dim, B=BATCH):
    """(vT, dvT): 0.6 N(0, 1) (numpy seed 7) and N(0, 1) (seed 8), (dim, B)
    float32 on `dev`."""
    vT = TRACED_STATE_SCALE * np.random.default_rng(TRACED_SEED).standard_normal((dim, B))
    dvT = np.random.default_rng(TRACED_TANGENT_SEED).standard_normal((dim, B))
    return (torch.as_tensor(vT, dtype=torch.float32, device=dev),
            torch.as_tensor(dvT, dtype=torch.float32, device=dev))


def tape_magnitudes(tape, consts, V):
    """The sums of |value| (B,) and, per input row, of |tangent| (rows, B)
    over every instruction of one traced entry's passes on its rows V (its
    plain version's unit tangents); infinite intermediates (an unselected
    branch's) are left out."""
    from tpu_bijectors_torch.vectorize import fused_traced as ft

    acc = {"v": 0.0, "t": 0.0}

    def fin(x):
        return torch.where(torch.isfinite(x), x.abs(), torch.zeros_like(x))

    def on_step(r, t):
        acc["v"] = acc["v"] + fin(r)
        if t is not None:
            acc["t"] = acc["t"] + fin(t)

    ft.traced_val_par(tape, consts, V, True, True, on_step)
    vm = torch.broadcast_to(acc["v"], V.shape if not tape.vector else V.shape[1:])
    return (vm if tape.vector else vm.sum(0)), torch.broadcast_to(acc["t"], V.shape)


def traced_allowances(vT, cf64, loops64):
    """Float64 (lp, g) of a model's fused plain version on vT (slab rows
    and traced entries, or slab rows alone where loops64 is None) and the
    error float32 may carry: the slab rows'
    terms and c0 at RTOL_LP of their magnitudes, each partial at RTOL_G of
    its terms' (as `families_allowances`); each traced entry at RTOL_TAPE
    of its tape's `tape_magnitudes` (and of |partial|). Returns (lp64,
    g64, lp_allow, g_allow, the terms' magnitude)."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    vT64 = vT.double()
    lp64, g64 = fb.slab_value_and_grad_plain(vT64, cf64, loops64)
    groups, used = fb._groups_and_used(cf64)
    terms = [fb._group_val_par(gr, vT64, cf64, used, True, True, False) for gr in groups]
    mag = cf64[:, fb._CI["c0"]].abs().sum() + torch.zeros_like(lp64)
    g_mag = torch.zeros_like(vT64)
    for v, p in terms:
        mag = mag + v.abs().sum(0)
        g_mag = g_mag + p.abs()
    lp_allow = RTOL_LP * mag + 1e-6
    g_allow = RTOL_G * (g64.abs() + g_mag) + 1e-6
    for i, (code, row0, K, off) in enumerate(() if loops64 is None else loops64.entries):
        if code != fb.TRACED:
            raise ValueError(f"loop kind {code} has no allowance here")
        tape = loops64.tapes[loops64.toffs[i]]
        vm, tm = tape_magnitudes(tape, loops64.prm[off: off + len(tape.consts)],
                                 vT64[row0: row0 + K])
        mag = mag + vm
        lp_allow = lp_allow + RTOL_TAPE * vm
        g_allow[row0: row0 + K] += RTOL_TAPE * (tm + g64[row0: row0 + K].abs())
    return lp64, g64, lp_allow, g_allow, mag


def traced_extremes(vT, u):
    """The extremes block: the first TRACED_EXTREME_COLS columns of vT with
    every row at +-1e10 (signs from numpy seed 7); in the second half of
    the columns the rows of the leaves whose linked density is -inf at
    either extreme (ku, ig, tri) and of jo past its first keep their
    states and tst sits at -1e10, so that lp stays finite there."""
    n = TRACED_EXTREME_COLS
    sign = torch.as_tensor(np.sign(np.random.default_rng(7).standard_normal((vT.shape[0], n))),
                           dtype=vT.dtype, device=vT.device)
    vx = 1e10 * sign
    rows = families_rows(u)
    for name in ("ku", "ig", "tri"):
        vx[rows[name], n // 2:] = vT[rows[name], n // 2: n]
    jo = rows["jo"]
    vx[jo.start + 1: jo.stop, n // 2:] = vT[jo.start + 1: jo.stop, n // 2: n]
    vx[rows["tst"], n // 2:] = -1e10
    return vx.contiguous()


def check_pattern(tag, got, ref, allow):
    """got and ref carry the same NaN / +inf / -inf pattern and agree
    within `allow` where finite (the gradients at +-1e10: a partial of a
    density at an overflowed point may be NaN in the plain version too)."""
    same = (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(torch.isposinf(got), torch.isposinf(ref))
            and torch.equal(torch.isneginf(got), torch.isneginf(ref)))
    expect(f"{tag}: the plain version's NaN/inf pattern ({int(torch.isnan(ref).sum())} NaN, "
           f"{int(torch.isinf(ref).sum())} infinite)", same)
    fin = torch.isfinite(ref) & torch.isfinite(got)
    if fin.any():
        check(f"{tag}: finite values vs plain", got[fin], ref[fin], 1.0, allow[fin])


def tape_ops(loops, B):
    """Operations of a model's traced entries at batch B by kernel mode:
    each instruction of a pass counts one for its value and its tangent
    rule's `dual_ops` (fused_decomp.OPS) on dual numbers; a scalar entry
    runs a pass a row, a vector entry one pass for the value and one a row
    for the partials; the JVP's partial times dv adds two a row."""
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_decomp as fd

    out = dict.fromkeys(OPS, 0)
    for i, (code, _, K, _) in enumerate(loops.entries):
        if code != fb.TRACED:
            continue
        tape = loops.tapes[loops.toffs[i]]
        ins = tape.instructions()
        val = len(ins)
        dual = sum(1 + fd.OPS[n].dual_ops for n, *_ in ins)
        passes = K if not tape.vector else 1
        grad_passes = K
        out["value"] += B * passes * val
        out["value_and_grad"] += B * grad_passes * dual
        out["vjp"] += B * grad_passes * (dual + 1)
        out["jvp"] += B * grad_passes * (dual + 2)
    return out


def run_traced_model(dev, tag, build, extremes=False, states=None, timing=True):
    """One traced model at B = 131072 (`traced_states`) through the public
    calls, in all four modes: `batched_logdensity_t_fn()`, its `value_and_grad_fn`, autograd's
    backward and `torch.func.jvp` of `linked_logdensity_t` (the four
    whole-model kernels with the traced loop kind); the counters zeroed
    just before and read just after. Each against the plain version in
    float64 and the float64 composed path (its autograd gradient), and
    each kernel against its plain version on the card, at
    `traced_allowances`; with `extremes`, the extremes block
    (`traced_extremes`) in every mode against the plain versions. `states`
    (model -> (vT, dvT)) replaces `traced_states`; `timing=False` leaves
    out the entry points' times (`kernel_variants` times the kernels) and
    returns in their place {"u": the unconstrainer, "cf64", "loops64": its
    float64 tables}. Returns (launches, (vT, dvT, cf, loops), the kernels'
    max errors, the entry points' times)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    model = tbt.Model(build(dists, dev, torch.float32), device=dev)
    m64 = tbt.Model(build(dists, dev, torch.float64), device=dev)
    u, u64 = model.unconstrainer(), m64.unconstrainer()
    vT, dvT = traced_states(dev, model.dim()) if states is None else states(model)
    dim, B = vT.shape
    if tag == "generic-traced":
        expect(f"generic-traced: dim {dim} == {TRACED_DIM}", dim == TRACED_DIM)
    f = model.batched_logdensity_t_fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lp = f(vT)
    lp_vg, g = f.value_and_grad_fn(vT)
    vr = vT.detach().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(u.linked_logdensity_t(vr).sum(), vr)
    lp_j, dlp = torch.func.jvp(u.linked_logdensity_t, (vT,), (dvT,))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the {tag} transposed serving path: {launches}", flush=True)
    expect(f"{SMALL} not launched on the {tag} transposed serving path", launches[SMALL] == 0)
    for k in SLAB_KERNELS + ("slab_jvp", "slab_traced"):
        expect(f"{k} launched on the {tag} transposed serving path", launches[k] > 0)
    expect(f"{tag}: lp (B,), g ({dim}, B), dlp (B,)",
           lp.shape == (B,) and g.shape == (dim, B) and dlp.shape == (B,))
    cf, loops, c0sum = fk._prep(u, vT)
    cf64, loops64, c0sum64 = fk._prep(u64, vT.double())
    traced = [e for e in loops.entries if e[0] == fb.TRACED]
    print(f"{tag} loop entries (kind, first row, K, offset): {loops.entries}; tapes (offset: "
          f"instructions, slots, constants): "
          f"{ {o: (t.n_ins, t.n_slots, len(t.consts)) for o, t in loops.tapes.items()} }",
          flush=True)
    slab_rows = int((cf[:, fb._MASK_COL] > 0).sum())
    expect(f"{tag}: every row a traced entry's or a slab row's ({len(traced)} traced entries, "
           f"{slab_rows} slab rows)",
           len(traced) == len(loops.entries) and sum(e[2] for e in traced) + slab_rows == dim)
    lp64, g64, lp_allow, g_allow, mag = traced_allowances(vT, cf64, loops64)
    lp64 = lp64 + c0sum64
    dlp64 = (g64 * dvT.double()).sum(0)
    j_allow = jvp_allowance(g64, g_allow, dvT)
    check(f"{tag}: linked_logdensity_t vs float64", lp, lp64, 1.0, lp_allow)
    check(f"{tag}: value_and_grad_fn lp vs float64", lp_vg, lp64, 1.0, lp_allow)
    check(f"{tag}: value_and_grad_fn g vs float64", g, g64, 1.0, g_allow)
    check(f"{tag}: autograd g vs float64", g_ag, g64, 1.0, g_allow)
    check(f"{tag}: torch.func.jvp lp vs float64", lp_j, lp64, 1.0, lp_allow)
    check(f"{tag}: torch.func.jvp dlp vs float64", dlp, dlp64, 1.0, j_allow)
    # the float64 composed path and its autograd gradient (another algebra:
    # the trace's hoisted normalisers, the slab's closed form)
    v64 = vT.double().requires_grad_(True)
    comp64 = u64._linked_logdensity_t_children(v64)
    (gc64,) = torch.autograd.grad(comp64.sum(), v64)
    check(f"{tag}: linked_logdensity_t vs the float64 composed path", lp, comp64.detach(), 1.0,
          lp_allow)
    check(f"{tag}: value_and_grad_fn g vs the float64 composed path's autograd", g, gc64, 1.0,
          g_allow)
    del v64, comp64, gc64
    ct = torch.ones(B, device=dev)
    err = {}
    err["slab_value"] = check(f"{tag} value kernel vs plain", fk.slab_value(vT, cf, loops),
                              fb.slab_value_plain(vT, cf, loops), 1.0, 2 * lp_allow)
    lp_k, g_k = fk.slab_value_and_grad(vT, cf, loops)
    lp_p, g_p = fb.slab_value_and_grad_plain(vT, cf, loops)
    err["slab_value_and_grad"] = max(
        check(f"{tag} value-and-grad kernel lp vs plain", lp_k, lp_p, 1.0, 2 * lp_allow),
        check(f"{tag} value-and-grad kernel g vs plain", g_k, g_p, 1.0, 2 * g_allow))
    err["slab_vjp"] = check(f"{tag} vjp kernel vs plain", fk.slab_vjp(vT, cf, ct, loops),
                            fb.slab_vjp_plain(vT, cf, ct, loops), 1.0, 2 * g_allow)
    err["slab_jvp"] = check(f"{tag} jvp kernel vs plain", fk.slab_jvp(vT, cf, dvT, loops),
                            fb.slab_jvp_plain(vT, cf, dvT, loops), 1.0, 2 * j_allow)
    err["slab_traced"] = max(err.values())
    del lp_k, g_k, lp_p, g_p
    if extremes:
        vx = traced_extremes(vT, u)
        n = vx.shape[1]
        _, _, lpx_allow, gx_allow, _ = traced_allowances(vx, cf64, loops64)
        dvx, ctx = dvT[:, :n].contiguous(), ct[:n].contiguous()
        lpx_p, gx_p = fb.slab_value_and_grad_plain(vx, cf, loops)
        check_extremes(f"{tag} extremes: value kernel", fk.slab_value(vx, cf, loops), lpx_p,
                       2 * lpx_allow)
        lpx_k, gx_k = fk.slab_value_and_grad(vx, cf, loops)
        check_extremes(f"{tag} extremes: value-and-grad kernel lp", lpx_k, lpx_p,
                       2 * lpx_allow)
        check_pattern(f"{tag} extremes: value-and-grad kernel g", gx_k, gx_p, 2 * gx_allow)
        check_pattern(f"{tag} extremes: vjp kernel", fk.slab_vjp(vx, cf, ctx, loops),
                      fb.slab_vjp_plain(vx, cf, ctx, loops), 2 * gx_allow)
        check_pattern(f"{tag} extremes: jvp kernel", fk.slab_jvp(vx, cf, dvx, loops),
                      fb.slab_jvp_plain(vx, cf, dvx, loops),
                      2 * jvp_allowance(torch.nan_to_num(gx_p.double()), gx_allow, dvx))
        fin = int(torch.isfinite(lpx_p).sum())
        expect(f"{tag} extremes: lp -inf in {n - fin} of {n} columns, finite in {fin}",
               0 < fin < n)
    v64 = vT[:, :CHAINS].contiguous()
    key = tag.replace("-", "_")
    if not timing:
        return launches, (vT, dvT, cf, loops), err, {"u": u, "cf64": cf64, "loops64": loops64}
    e2e = {
        f"{key}_value_ms_B{B}": time_ms(lambda: f(vT), device_only=False),
        f"{key}_value_and_grad_ms_B{B}": time_ms(lambda: f.value_and_grad_fn(vT),
                                                 device_only=False),
        f"{key}_value_and_grad_ms_B64": time_ms(lambda: f.value_and_grad_fn(v64),
                                                device_only=False),
        f"{key}_func_jvp_ms_B{B}": time_ms(
            lambda: torch.func.jvp(u.linked_logdensity_t, (vT,), (dvT,)), device_only=False),
    }
    return launches, (vT, dvT, cf, loops), err, e2e


def run_traced_serving(dev):
    """Cell 16: transposed serving of the three traced models at
    B = 131072 (`run_traced_model`; the extremes block on generic-traced).
    Returns (launches summed over the three, {model: (vT, dvT, cf, loops)},
    the kernels' max errors, the entry points' times)."""
    launches, preps, err, e2e = {}, {}, {}, {}
    for tag, build in TRACED_MODELS.items():
        lc, preps[tag], e, t = run_traced_model(dev, tag, build,
                                                extremes=tag == "generic-traced")
        for k, n in lc.items():
            launches[k] = launches.get(k, 0) + n
        for k, x in e.items():
            err[k] = max(err.get(k, 0.0), x)
        e2e.update(t)
    return launches, preps, err, e2e


def traced_variants(preps):
    """`model_variants` of each traced model at B = 131072, the traced
    entries' operations from `tape_ops`."""
    out = {}
    for tag, (vT, dvT, cf, loops) in preps.items():
        out.update(model_variants(f"with the traced entries ({tag})", vT, dvT, cf, loops,
                                  tape_ops(loops, vT.shape[1])))
    return out


def run_traced_sampler(dev):
    """Cell 17, traced sampling: the steps of `Model(generic-traced).sample(
    kernel='auto')` on the prior alone (`nuts_batched_t`: every leapfrog
    runs the value-and-gradient kernel with the nine traced entries),
    `warmup_and_sample` from `Model.init_positions(gen, 64, 0.3)` for the
    warmup and `resume_sampling` for the draws; 64 chains, max_depth 8, 300
    warmup and TRACED_KEPT kept transitions, target 0.8, torch seed 0. Gates:
    max rank-normalized R-hat <= 1.05, divergences <= 1%, every
    coordinate's mean within 5 MCSE of its exact mean (TRACED_MEANS)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, resume_sampling, warmup_and_sample

    model = tbt.Model(traced_model(dists, dev, torch.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    kernel = model._auto_kernel()
    expect(f"traced sampling: kernel='auto' takes nuts_batched_t (took {kernel})",
           kernel == "nuts_batched_t")
    density = model.batched_logdensity_t_fn()
    _, state, _ = warmup_and_sample(
        density, gen, model.init_positions(gen, CHAINS, TRACED_INIT_SCALE), n_warmup=WARMUP,
        n_samples=0, kernel=kernel, max_depth=MAX_DEPTH, target_accept=TRACED_TARGET,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, s1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    raw, state, stats = resume_sampling(density, state, TRACED_KEPT, kernel=kernel,
                                        max_depth=MAX_DEPTH)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2, s2 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    x = model.constrain(raw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the traced sampler path: {launches}", flush=True)
    for k in (SMALL, "slab_traced"):
        expect(f"{k} launched on the traced sampler path", launches[k] > 0)
    during = {k: l2[k] - l1[k] for k in l2}
    leapfrogs = during[SMALL]
    sampling_s = t2 - t1
    expect(f"traced sampling: raw draws ({TRACED_KEPT}, {CHAINS}, {TRACED_DIM}) and finite",
           tuple(raw.shape) == (TRACED_KEPT, CHAINS, TRACED_DIM)
           and bool(torch.isfinite(raw).all()))
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    n_div = int(stats.diverging.sum())
    dev_in_mcse = {}
    for k, means in TRACED_MEANS.items():
        draws = x[k].double()
        for i, exact in enumerate(means):
            di = draws if draws.ndim == 2 else draws[..., i]
            mean, mcse = float(di.mean()), float(diagnostics.mcse_mean(di))
            name = k if len(means) == 1 else f"{k}[{i}]"
            dev_in_mcse[name] = abs(mean - exact) / mcse
            print(f"traced sampling: {name} mean {mean:.4f} (MCSE {mcse:.4f}); exact "
                  f"{exact:.4f}", flush=True)
    line = {
        "kernel": "nuts_batched_t", "cell": "traced_sampling",
        "chains": CHAINS, "warmup": WARMUP, "kept": TRACED_KEPT, "max_depth": MAX_DEPTH,
        "target_accept": TRACED_TARGET, "init_scale": TRACED_INIT_SCALE,
        "warmup_s": t1 - t0,
        "sampling_s": sampling_s,
        "constrain_s": t3 - t2,
        "draws_per_s": CHAINS * KEPT / sampling_s,
        "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": (s2 - s1) / max(leapfrogs, 1),
        "step_size": float(state.eps),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "transitions": CHAINS * TRACED_KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "rhat": [float(r) for r in np.ravel(r_hat)],
        "min_ess_bulk": float(np.min(ess)),
        "dev_in_mcse": dev_in_mcse,
    }
    expect(f"traced sampling: max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"traced sampling: divergences {n_div} <= 1% of {CHAINS * TRACED_KEPT}",
           n_div <= 0.01 * CHAINS * TRACED_KEPT)
    for k, d in dev_in_mcse.items():
        expect(f"traced sampling: the mean of {k} within 5 MCSE of its exact mean ({d:.2f})",
               d <= 5.0)
    return line


def run_prim_probe(dev):
    """Cell 18, #14: the per-opcode probe of the interpreter
    (`kernels/prim_probe.py::run`, the counters zeroed just before and read
    just after): every opcode of the admission set against its plain
    version, the torch op and torch.autograd in float64 at its edge
    points, then timed. Returns (launches, the rows, the largest error
    against the plain version)."""
    from tpu_bijectors_torch import kernels
    from tpu_bijectors_torch.kernels import prim_probe as pp
    from tpu_bijectors_torch.vectorize import fused_decomp as fd

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rows = pp.run(dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the prim probe's path: {launches}", flush=True)
    expect("prim_probe launched by the probe", launches["prim_probe"] > 0)
    for r in rows:
        print(json.dumps({"prim_probe": r}), flush=True)
        expect(f"prim_probe {r['op']}: value and tangent within {pp.TOL:g} of plain and float64, "
               f"the same NaN/inf pattern", r["ok"])
    expect("prim_probe covers the admission set",
           sorted(r["op"] for r in rows) == sorted(fd._SAFE_PRIMS))
    err = max(max(r["err_value_plain"], r["err_tangent_plain"]) for r in rows)
    return launches, rows, err


def time_prep(dev):
    """`_prep`'s first call (plan, traced entries' traces, table) on a
    fresh unconstrainer of the generic-traced and the bench models, and a
    second call (the cache), host clock with a synchronize."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    out = {}
    for tag, build in (("generic_traced", lambda: traced_model(dists, dev, torch.float32)),
                       ("bench", lambda: bench_model(dists, dev, torch.float32))):
        model = tbt.Model(build(), device=dev)
        vT = torch.zeros((model.dim(), 64), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fk._prep(model.unconstrainer(), vT)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fk._prep(model.unconstrainer(), vT)
        torch.cuda.synchronize()
        out[f"{tag}_first_s"] = t1 - t0
        out[f"{tag}_cached_s"] = time.perf_counter() - t1
    print(json.dumps({"prep_s": out}), flush=True)
    return out


# --- #2 at small batch: the item kernel (the ninth slice) -------------------

# the batches the small design is held to its plain version at (and SMALL_B)
SMALL_BS = (1, 31, 64, 65, 200)
# the models each sampler cell's leapfrog runs #2 on, by cell
SAMPLER_MODELS = {2: "bench", 7: "pdonly", 10: "mvdense", 14: "eight-schools",
                  17: "generic-traced"}
SWEEP_BS = (64, 256, 1024, 4096, 16384, BATCH)


def item_states(dev, name, dim, B):
    """The states the small design is checked on: the path's own where it
    has them (families, the traced models), else 0.5 N(0, 1) from numpy
    seed SEED; (dim, B) float32."""
    if name == "families":
        return families_states(dev, B)[0]
    if name in TRACED_MODELS:
        return traced_states(dev, dim, B)[0]
    v = 0.5 * np.random.default_rng(SEED).standard_normal((dim, B))
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def item_allowances(name, x, cf, loops, cf64, loops64):
    """Float64 (lp, g) of a model's plain function on x (without c0) and
    the allowances its path's checks hold it to: for a model of slab rows
    the rows' terms at RTOL_LP and RTOL_G of their magnitudes (as
    `families_allowances` holds them: the LKJ rows' partials are sums of
    terms that cancel), `pd_entry_allowances`, `mv_allowances`,
    `families_allowances` and `traced_allowances` for the others."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    if loops is None or name in TRACED_MODELS:
        return traced_allowances(x, cf64, loops64)[:4]
    if name == "mvdense":
        lp64, g64, la, ga = mv_allowances(x, cf, loops, cf64, loops64)
        return lp64 - cf64[:, fb._CI["c0"]].sum(), g64, la, ga
    if name == "families":
        return families_allowances(x, cf64, loops64)[:4]
    return pd_entry_allowances(x, cf64, loops64)


def vg_ops(cf, loops, B):
    """The value-and-gradient mode's operation floor on a model at batch B:
    the slab rows' (OPS), each PD entry's (`pd_ops`), each Gaussian or t
    entry's (QUAD_OPS at K = 16, the same count at any K) and the traced
    entries' (`tape_ops`)."""
    from tpu_bijectors_torch.vectorize import fused_base as fb

    ops = B * sum(2 + sum(OPS["value_and_grad"][g] for g in fb._groups_and_used(cf[r:r + 1])[0])
                  for r in range(cf.shape[0]) if cf[r, fb._MASK_COL] > 0)
    if loops is None:
        return ops
    for code, _, K, _ in loops.entries:
        if code in fb.PD_MODES:
            mode = fb.PD_MODES[code]
            p = pd_ops(K)
            ops += B * (p[mode] + p[mode + "_grad"] - (K * (K + 1) // 2 + 5 * K))
        elif code != fb.TRACED:
            tri = K * (K + 1) // 2
            ops += B * ((K + 2 * tri + 2 * K) + 3 + (2 * tri + K))
    return ops + tape_ops(loops, B)["value_and_grad"]


def vg_bytes(x, cf, loops):
    """Bytes the value-and-gradient mode must move: x, the table, the loop
    parameters and tapes read once, lp and g written once."""
    n = 2 * x.numel() * 4 + x.shape[1] * 4 + cf.numel() * 4
    if loops is not None:
        n += loops.prm.numel() * 4 + (0 if loops.tape is None else loops.tape.numel() * 4)
    return n


def check_small_design(dev):
    """#2's small design (the item kernel) on every model the paths drive
    (ITEM_MODELS) at B = 1, 31, 64, 65, 200 and SMALL_B: lp and g against
    the plain version at twice the allowances of the model's own checks
    (`item_allowances`) and against float64 at them; two launches give the
    same lp and g bit for bit; on families and generic-traced the extremes
    blocks of 64 columns keep the plain version's NaN/inf pattern.
    Returns (the max absolute error against the plain version, name ->
    (cf, loops, the (dim, 64) states) of the sampler cells' models)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    err, preps = 0.0, {}
    kernels.reset_launch_counts()
    for name, build in ITEM_MODELS.items():
        model = tbt.Model(build(dists, tbt, dev, torch.float32), device=dev)
        m64 = tbt.Model(build(dists, tbt, dev, torch.float64), device=dev)
        u = model.unconstrainer()
        X = item_states(dev, name, model.dim(), fk.SMALL_B)
        cf, loops, _ = fk._prep(u, X)
        cf64, loops64, _ = fk._prep(m64.unconstrainer(), X.double())
        for B in SMALL_BS + (fk.SMALL_B,):
            x = X[:, :B].contiguous()
            lp64, g64, la, ga = item_allowances(name, x, cf, loops, cf64, loops64)
            lp, g = fk.slab_value_and_grad(x, cf, loops, design="small")
            lpp, gp = fb.slab_value_and_grad_plain(x, cf, loops)
            tag = f"small design ({name}, B = {B})"
            err = max(err, check(f"{tag} lp vs plain", lp, lpp, 1.0, 2 * la),
                      check(f"{tag} g vs plain", g, gp, 1.0, 2 * ga))
            check(f"{tag} lp vs float64", lp, lp64, 1.0, la)
            check(f"{tag} g vs float64", g, g64, 1.0, ga)
            if B in (CHAINS, fk.SMALL_B):
                lp2, g2 = fk.slab_value_and_grad(x, cf, loops, design="small")
                expect(f"{tag}: a second launch gives lp and g bit for bit",
                       torch.equal(lp, lp2) and torch.equal(g, g2))
        if name in ("families", "generic-traced"):
            vx = (families_extremes(X, cf) if name == "families" else traced_extremes(X, u))
            _, _, lpx_allow, gx_allow, _ = (families_allowances if name == "families"
                                            else traced_allowances)(vx, cf64, loops64)
            lpx, gx = fk.slab_value_and_grad(vx, cf, loops, design="small")
            lpx_p, gx_p = fb.slab_value_and_grad_plain(vx, cf, loops)
            # the families path holds g to the finite/inf pattern, the
            # traced one to the NaN/inf pattern (a partial at an overflowed
            # point may be NaN in the plain version too)
            check_extremes(f"small design ({name}) extremes: lp", lpx, lpx_p, 2 * lpx_allow)
            (check_extremes if name == "families" else check_pattern)(
                f"small design ({name}) extremes: g", gx, gx_p, 2 * gx_allow)
        if name in SAMPLER_MODELS.values():
            preps[name] = (cf, loops, X[:, :CHAINS].contiguous())
    torch.cuda.synchronize()
    expect(f"{SMALL} launched by the small-design checks", kernels.LAUNCHES[SMALL] > 0)
    expect("slab_value_and_grad not launched by the small-design checks",
           kernels.LAUNCHES["slab_value_and_grad"] == 0)
    return err, preps


RUN_BS = (1, 65, BATCH)


def check_run_walk(dev):
    """#1's walk over runs of rows (the value kernel, `fused_kernel.
    run_rows`) on every model the paths drive (ITEM_MODELS) and on
    wide-general, at B = 1, 65 and 131072 (the wide models at 1, 65 and
    WIDE_B): lp against the plain version at twice the allowances of the
    model's own checks (`item_allowances`) and against float64 at them,
    bit for bit on a second launch; the extremes blocks of families and
    generic-traced keep the plain version's finite/inf pattern. families,
    the model with most runs, has runs of both specialised sets and runs
    that take the general row function (slab_row); each of those runs
    alone (a table of its rows only) is held to the plain version too.
    wide-general's tables exceed a block's shared memory, so its walk reads
    them through the read-only path. Returns the max absolute error
    against the plain version."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    err = 0.0
    # a block's shared memory at most (227 KB on the H100)
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    227 * 1024)
    for name, build in {**ITEM_MODELS, **WIDE_MODELS}.items():
        model = tbt.Model(build(dists, tbt, dev, torch.float32), device=dev)
        m64 = tbt.Model(build(dists, tbt, dev, torch.float64), device=dev)
        u = model.unconstrainer()
        wide = name in WIDE_MODELS or name == "pdwide"
        X = item_states(dev, name, model.dim(), WIDE_B if wide else BATCH)
        cf, loops, _ = fk._prep(u, X)
        cf64, loops64, _ = fk._prep(m64.unconstrainer(), X.double())
        runs, packed, _ = fk.run_table(cf)
        print(f"run walk ({name}): {runs.shape[0]} runs, sets "
              f"{sorted(set(runs[:, 2].tolist()))}, {packed.numel() * 4} bytes of "
              f"coefficients", flush=True)
        if name == "wide-general":
            expect("run walk (wide-general): its tables exceed a block's shared memory",
                   runs.numel() * 4 + packed.numel() * 4 > optin)
        for B in RUN_BS[:-1] + (X.shape[1],):
            x = X[:, :B].contiguous()
            lp64, _, la, _ = item_allowances(name, x, cf, loops, cf64, loops64)
            lp = fk.slab_value(x, cf, loops)
            tag = f"run walk ({name}, B = {B})"
            err = max(err, check(f"{tag} lp vs plain", lp, fb.slab_value_plain(x, cf, loops),
                                 1.0, 2 * la))
            check(f"{tag} lp vs float64", lp, lp64, 1.0, la)
            expect(f"{tag}: a second launch gives lp bit for bit",
                   torch.equal(lp, fk.slab_value(x, cf, loops)))
        if name in ("families", "generic-traced"):
            vx = (families_extremes(X, cf) if name == "families" else traced_extremes(X, u))
            _, _, lpx_allow, _, _ = (families_allowances if name == "families"
                                     else traced_allowances)(vx, cf64, loops64)
            check_extremes(f"run walk ({name}) extremes: lp", fk.slab_value(vx, cf, loops),
                           fb.slab_value_plain(vx, cf, loops), 2 * lpx_allow)
        if name == "families":
            sets = [t for _, _, t, _ in fk.run_rows(cf)[0]]
            general = [r for r in fk.run_rows(cf)[0] if r[2] not in fk.RUN_SETS]
            expect("run walk (families): runs of both specialised sets and of the general "
                   f"row function ({len(general)} of {len(sets)})",
                   set(fk.RUN_SETS) <= set(sets) and len(general) > 0)
            x = X[:, :RUN_BS[1]].contiguous()
            for row0, n, t, _ in general:
                keep = torch.zeros(cf.shape[0], dtype=torch.bool, device=dev)
                keep[row0: row0 + n] = True
                sub = torch.where(keep[:, None], cf, torch.zeros_like(cf))
                _, _, la, _ = slab_allowances(x, sub)
                check(f"run walk (families): the general run of rows {row0}-{row0 + n - 1}, "
                      f"set {t}, alone vs plain", fk.slab_value(x, sub),
                      fb.slab_value_plain(x, sub), 1.0, 2 * la)
    return err


def small_design_variants(preps):
    """`time_kernels` variants: #2 at the samplers' 64 chains on each
    sampler cell's model in both designs, with their bytes, bound and
    plain version (`vg_bytes`, `vg_ops`), and a kernel that does nothing,
    timed in the same window: the launch floor."""
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    out = {}
    for cell, name in SAMPLER_MODELS.items():
        cf, loops, x = preps[name]
        for design in ("small", "wide"):
            out[f"slab_value_and_grad {design} design ({name}, cell {cell}, B = 64)"] = (
                lambda cf=cf, loops=loops, x=x, design=design:
                    fk.slab_value_and_grad(x, cf, loops, design=design),
                vg_bytes(x, cf, loops), vg_ops(cf, loops, x.shape[1]),
                lambda cf=cf, loops=loops, x=x: fb.slab_value_and_grad_plain(x, cf, loops))
    dev = next(iter(preps.values()))[2].device
    out["launch floor: a kernel that does nothing"] = lambda: fk.launch_floor(dev)
    return out


def small_b_sweep(dev, vT):
    """#2's time in both designs at SWEEP_BS on the bench, mvdense and
    pdonly models (the states: vT's first B columns). Prints one
    `slab_small_b_sweep` line with each time and, per model, the largest
    batch at which the small design is the faster: SMALL_B is set from
    it."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    out = {}
    for name in ("bench", "mvdense", "pdonly"):
        model = tbt.Model(ITEM_MODELS[name](dists, tbt, dev, torch.float32), device=dev)
        u = model.unconstrainer()
        rows = {}
        for B in SWEEP_BS:
            x = vT[:, :B].contiguous()
            cf, loops, _ = fk._prep(u, x)
            rows[B] = {d: time_ms(lambda d=d: fk.slab_value_and_grad(x, cf, loops, design=d))
                       for d in ("small", "wide")}
        faster = [B for B, t in rows.items() if t["small"] <= t["wide"]]
        out[name] = {"ms": rows, "small_faster_up_to": max(faster, default=None)}
    print(json.dumps({"slab_small_b_sweep": out, "SMALL_B": fk.SMALL_B}), flush=True)
    return out


SIMPLEX_SWEEP_BS = (64, 256, 1024, 2048, 4096, 8192, 16384, 32768, BATCH)


def simplex_small_b_sweep(vT):
    """#7's time in both designs at SIMPLEX_SWEEP_BS (x and ld, as the
    samplers' leapfrogs call it) in the swapped view and the batch-major
    slice of vT's Dirichlet rows. Prints one `simplex_small_b_sweep` line
    with each time and, per layout, the largest batch at which the small
    design is the faster: kernels/simplex.py's SMALL_B is set from it."""
    from tpu_bijectors_torch.kernels import simplex as ks

    out = {}
    for lay in ("swapped", "batch-major slice"):
        rows = {}
        for B in SIMPLEX_SWEEP_BS:
            y = layouts(vT, W_ROWS, B, lay)[lay]
            rows[B] = {d: time_ms(lambda y=y, d=d: ks.simplex_inverse_logdet(y, design=d))
                       for d in ks.DESIGNS}
        faster = [B for B, t in rows.items() if t["small"] <= t["wide"]]
        out[lay] = {"ms": rows, "small_faster_up_to": max(faster, default=None)}
    print(json.dumps({"simplex_small_b_sweep": out, "SMALL_B": ks.SMALL_B}), flush=True)
    return out


def kernel_table(vT, xT, cf, ones, dvT, fam_vT, probe_in, traced_in):
    """Every ported kernel at B = 131072: name -> (wrapper, plain version,
    bytes, operations, {layout: input}), the layout the path reads first.
    The bytes count each input the function reads once and each output
    once; the operations are floors (see OPS, PD_OPS). #4 (`slab_jvp`) is
    timed on the bench model with the tangent dvT. The PD log-density
    and trace-gradient rows are the dot mode with the PD models' C = I
    (the solve mode is in `pd_variants`). The LKJ log-det's Cholesky
    variant (`lkj_logdet_chol`) reads the families model's LKJCholesky(5)
    rows of fam_vT (its path's), the probe (#13) is its floor variant on
    `probe_in` = (vT, c) (every variant: the `transcend_probe` line). The
    traced loop kind is the value-and-gradient kernel on generic-traced
    (`traced_in` = (vT, dvT, cf, loops); every mode and model:
    `traced_variants`), #14 its costliest opcode, pow, with the tangent on
    the base (every opcode: the `prim_probe` lines)."""
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.kernels import prim_probe as pp
    from tpu_bijectors_torch.kernels import probe
    from tpu_bijectors_torch.kernels import simplex as ks
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_decomp as fd
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    dim, B = vT.shape
    pv, pc = probe_in
    tvT, _, tcf, tloops = traced_in
    px, py, pz = pp.inputs("pow", vT.device)
    lc_rows = slice(FAM_LC_ROW0, FAM_LC_ROW0 + 10)
    v64 = vT[:, :CHAINS].contiguous()
    groups_per_row = [fb._groups_and_used(cf[r : r + 1])[0] for r in range(dim)]

    def slab_ops(mode):
        return B * sum(2 + sum(OPS[mode][g] for g in gs) for gs in groups_per_row)

    # reads vT and the coefficients, writes lp (B,) or reads the cotangent
    # (B,); the gradient kernels also write g (dim, B)
    slab_bytes = vT.numel() * 4 + B * 4 + cf.numel() * 4
    transposed = {"transposed": vT}
    eye = torch.eye(PD_K, device=vT.device)
    return {
        "slab_value": (lambda y: fk.slab_value(y, cf), lambda y: fb.slab_value_plain(y, cf),
                       slab_bytes, slab_ops("value"), transposed),
        "slab_value_and_grad": (
            lambda y: fk.slab_value_and_grad(y, cf),
            lambda y: fb.slab_value_and_grad_plain(y, cf),
            slab_bytes + vT.numel() * 4, slab_ops("value_and_grad"), transposed,
        ),
        "slab_vjp": (lambda y: fk.slab_vjp(y, cf, ones),
                     lambda y: fb.slab_vjp_plain(y, cf, ones),
                     slab_bytes + vT.numel() * 4, slab_ops("vjp"), transposed),
        # reads vT, dvT and the coefficients, writes dlp (B,)
        "slab_jvp": (lambda y: fk.slab_jvp(y, cf, dvT),
                     lambda y: fb.slab_jvp_plain(y, cf, dvT),
                     slab_bytes + vT.numel() * 4, slab_ops("jvp"), transposed),
        # reads y (15), writes x (16) and ld
        "simplex_inverse_logdet": (
            ks.simplex_inverse_logdet, ks.simplex_inverse_logdet_plain,
            B * 4 * (15 + 16 + 1), B * 15 * OPS_SIMPLEX_COORD,
            layouts(vT, W_ROWS, B, "swapped"),
        ),
        # reads y (120), writes X (256), logJ and log diag W (16)
        "lkj_inverse": (
            lambda y: kl.lkj_inverse(y, 16), lambda y: kl.lkj_inverse_plain(y, 16),
            B * 4 * (120 + 256 + 1 + 16), B * (120 * OPS_LKJ_SLOT + 2 * 816),
            layouts(vT, C_ROWS, B, "swapped"),
        ),
        # reads y (120), writes logJ and log diag W (16)
        "lkj_logdet": (
            lambda y: kl.lkj_logdet(y, 16), lambda y: kl.lkj_logdet_plain(y, 16),
            B * 4 * (120 + 1 + 16), B * 120 * OPS_LKJ_LOGDET_SLOT,
            layouts(vT, C_ROWS, B, "batch-major slice"),
        ),
        # reads y (15), writes x (16)
        "simplex_inverse": (
            ks.simplex_inverse, ks.simplex_inverse_plain,
            B * 4 * (15 + 16), B * 15 * OPS_SIMPLEX_X_COORD,
            layouts(vT, W_ROWS, B, "batch-major slice"),
        ),
        # reads x_0..x_14 (x_15 enters neither output), writes y (15) and
        # ld; to_linked_vec hands it the inverse's contiguous x
        "simplex_forward_logdet": (
            ks.simplex_forward_logdet, ks.simplex_forward_logdet_plain,
            B * 4 * (15 + 15 + 1), B * 15 * OPS_SIMPLEX_FWD_COORD,
            layouts(xT, X_ROWS, B, "contiguous"),
        ),
        # reads y (136), writes X (256), logJ and L (256); the likelihood of
        # the transposed sampler hands it the swapped view
        "pd_inverse": (
            lambda y: kp.pd_inverse(y, PD_K), lambda y: kp.pd_inverse_plain(y, PD_K),
            B * 4 * (136 + 256 + 1 + 256), B * PD_OPS["inverse"],
            layouts(vT, PD_ROWS, B, "swapped"),
        ),
        # reads y (136) and C, writes logJ, sum y_rr and the trace
        "pd_logdensity": (
            lambda y: kp.pd_logdensity(y, PD_K, eye, "dot"),
            lambda y: kp.pd_logdensity_plain(y, PD_K, eye, "dot"),
            B * 4 * (136 + 3) + eye.numel() * 4, B * PD_OPS["dot"],
            layouts(vT, PD_ROWS, B, "batch-major slice"),
        ),
        # reads y (136) and C, writes the gradient (136)
        "pd_trace_grad": (
            lambda y: kp.pd_trace_grad(y, PD_K, eye, "dot"),
            lambda y: kp.pd_trace_grad_plain(y, PD_K, eye, "dot"),
            B * 4 * (136 + 136) + eye.numel() * 4, B * PD_OPS["dot_grad"],
            layouts(vT, PD_ROWS, B, "batch-major slice"),
        ),
        # LKJCholesky(5): reads y (10), writes logJ and log diag W (5)
        "lkj_logdet_chol": (
            lambda y: kl.lkj_logdet(y, 5, True), lambda y: kl.lkj_logdet_plain(y, 5, True),
            B * 4 * (10 + 1 + 5), B * 10 * OPS_LKJ_LOGDET_SLOT,
            layouts(fam_vT, lc_rows, B, "batch-major slice"),
        ),
        # reads vT (151, B) and c, writes lp; a scale, a multiply-add
        "transcend_probe": (
            lambda y: probe.probe("floor", y, pc), lambda y: probe.probe_plain("floor", y, pc),
            probe.probe_bytes("floor", *pv.shape), 3 * pv.numel(), {"transposed": pv},
        ),
        # reads vT (12, B), the table, the parameters and the tapes; writes
        # lp (B,) and g (12, B)
        "slab_traced": (
            lambda y: fk.slab_value_and_grad(y, tcf, tloops),
            lambda y: fb.slab_value_and_grad_plain(y, tcf, tloops),
            2 * tvT.numel() * 4 + B * 4 + tcf.numel() * 4 + tloops.prm.numel() * 4
            + tloops.tape.numel() * 4,
            tape_ops(tloops, B)["value_and_grad"], {"transposed": tvT},
        ),
        # #7's small design at cell 2's 64 chains, the swapped view the
        # leapfrog hands it: reads y (15), writes x (16) and ld
        SIMPLEX_SMALL: (
            lambda y: ks.simplex_inverse_logdet(y, design="small"),
            ks.simplex_inverse_logdet_plain, CHAINS * 4 * (15 + 16 + 1),
            CHAINS * 15 * OPS_SIMPLEX_COORD, {"swapped, B = 64": vT[W_ROWS, :CHAINS].T},
        ),
        # #2's small design at cell 2's 64 chains: reads vT (151, 64) and
        # the table, writes lp and g
        SMALL: (lambda y: fk.slab_value_and_grad(y, cf, design="small"),
                lambda y: fb.slab_value_and_grad_plain(y, cf),
                vg_bytes(v64, cf, None), vg_ops(cf, None, CHAINS), {"transposed, B = 64": v64}),
        # reads x, y, z, writes the value and the tangent; pow's value and
        # its tangent rule
        "prim_probe": (
            lambda x: pp.prim_probe("pow", x, py, pz, 0),
            lambda x: pp.prim_probe_plain("pow", x, py, pz, 0),
            5 * 4 * B, B * (1 + fd.OPS["pow"].dual_ops), {"grid": px},
        ),
    }


def pd_variants(vT, dvT, pd_preps):
    """The PD variants the paths also run, name -> (call, bytes, operations,
    the plain version's call): the solve mode of the log-density and
    trace-gradient kernels in each layout, and the four whole-model
    kernels with the PD entry on each PD model (`pd_preps`: family ->
    (cf, loops) of its `_prep`; the forward-mode kernel with the tangent
    dvT)."""
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    dim, B = vT.shape
    eye = torch.eye(PD_K, device=vT.device)
    out = {}
    for lay, y in layouts(vT, PD_ROWS, B, "batch-major slice").items():
        out[f"pd_logdensity solve ({lay})"] = (
            lambda y=y: kp.pd_logdensity(y, PD_K, eye, "solve"),
            B * 4 * (136 + 3) + eye.numel() * 4, B * PD_OPS["solve"],
            lambda y=y: kp.pd_logdensity_plain(y, PD_K, eye, "solve"))
        out[f"pd_trace_grad solve ({lay})"] = (
            lambda y=y: kp.pd_trace_grad(y, PD_K, eye, "solve"),
            B * 4 * (136 + 136) + eye.numel() * 4, B * PD_OPS["solve_grad"],
            lambda y=y: kp.pd_trace_grad_plain(y, PD_K, eye, "solve"))
    ones = torch.ones(B, device=vT.device)
    for fam, (cf, loops) in pd_preps.items():
        mode = PD_MODES[fam]
        # the m rows' slab ops, counted as in kernel_table
        slab = {k: B * sum(2 + sum(OPS[k][g] for g in fb._groups_and_used(cf[r:r + 1])[0])
                           for r in range(dim) if cf[r, fb._MASK_COL] > 0)
                for k in OPS}
        nbytes = vT.numel() * 4 + B * 4 + cf.numel() * 4 + loops.prm.numel() * 4
        out[f"slab_value with the PD entry ({fam})"] = (
            lambda cf=cf, loops=loops: fk.slab_value(vT, cf, loops), nbytes,
            slab["value"] + B * PD_OPS[mode],
            lambda cf=cf, loops=loops: fb.slab_value_plain(vT, cf, loops))
        out[f"slab_value_and_grad with the PD entry ({fam})"] = (
            lambda cf=cf, loops=loops: fk.slab_value_and_grad(vT, cf, loops),
            nbytes + vT.numel() * 4,
            slab["value_and_grad"] + B * (PD_OPS[mode] + PD_OPS[mode + "_grad"] - 216),
            lambda cf=cf, loops=loops: fb.slab_value_and_grad_plain(vT, cf, loops))
        out[f"slab_vjp with the PD entry ({fam})"] = (
            lambda cf=cf, loops=loops: fk.slab_vjp(vT, cf, ones, loops),
            nbytes + vT.numel() * 4, slab["vjp"] + B * PD_OPS[mode + "_grad"],
            lambda cf=cf, loops=loops: fb.slab_vjp_plain(vT, cf, ones, loops))
        out[f"slab_jvp with the PD entry ({fam})"] = (
            lambda cf=cf, loops=loops: fk.slab_jvp(vT, cf, dvT, loops),
            nbytes + vT.numel() * 4, slab["jvp"] + B * (PD_OPS[mode + "_grad"] + 2 * 136),
            lambda cf=cf, loops=loops: fb.slab_jvp_plain(vT, cf, dvT, loops))
    return out


def model_variants(tag, vT, dvT, cf, loops, loop_ops):
    """The four whole-model kernels on one model at vT's batch, name ->
    (call, bytes, operations, the plain version's call): the slab rows'
    operations as in `kernel_table`, plus the loop entries' `loop_ops`
    (mode -> operations); the forward-mode kernel with the tangent dvT."""
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    dim, B = vT.shape
    ones = torch.ones(B, device=vT.device)
    slab = {k: B * sum(2 + sum(OPS[k][g] for g in fb._groups_and_used(cf[r:r + 1])[0])
                       for r in range(dim) if cf[r, fb._MASK_COL] > 0)
            for k in OPS}
    nbytes = vT.numel() * 4 + B * 4 + cf.numel() * 4 + (0 if loops is None else
                                                          loops.prm.numel() * 4)
    calls = {
        "value": (lambda: fk.slab_value(vT, cf, loops), nbytes,
                  lambda: fb.slab_value_plain(vT, cf, loops)),
        "value_and_grad": (lambda: fk.slab_value_and_grad(vT, cf, loops),
                           nbytes + vT.numel() * 4,
                           lambda: fb.slab_value_and_grad_plain(vT, cf, loops)),
        "vjp": (lambda: fk.slab_vjp(vT, cf, ones, loops), nbytes + vT.numel() * 4,
                lambda: fb.slab_vjp_plain(vT, cf, ones, loops)),
        "jvp": (lambda: fk.slab_jvp(vT, cf, dvT, loops), nbytes + vT.numel() * 4,
                lambda: fb.slab_jvp_plain(vT, cf, dvT, loops)),
    }
    return {f"slab_{k} {tag}": (call, nb, slab[k] + loop_ops[k], plain)
            for k, (call, nb, plain) in calls.items()}


def mv_variants(vT, dvT, cf, loops):
    """`model_variants` of mvdense at B = 131072, each Gaussian or t
    entry's operations from QUAD_OPS."""
    B, n_ent = vT.shape[1], len(loops.entries)
    form, val, grad = (B * n_ent * QUAD_OPS[k] for k in ("form", "value", "grad"))
    quad = {"value": form + val, "value_and_grad": form + val + grad, "vjp": form + grad,
            "jvp": form + grad + B * n_ent * 2 * MV_K}
    return model_variants("with the Gaussian and t entries (mvdense)", vT, dvT, cf, loops, quad)


def time_kernels(table, launches, err, variants):
    """One `kernels` row per entry of `kernel_table`: the kernel timed on
    each of its layouts (the row's `ms` on the first, the layout its path
    reads) and its plain version on the first, with CUDA events; the bound
    from the entry's bytes and operations. Prints each row, its
    `bound_inputs`, and a `kernel_variants` line with every layout's time
    and byte-bound share and the times of `variants` (name -> call, or
    (call, bytes, operations, plain version's call) to give its bound and
    its plain version's time too)."""
    rows, times = [], {}
    for k, (kern, plain, nbytes, ops, inputs) in table.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        ms = {lay: time_ms(lambda y=y: kern(y)) for lay, y in inputs.items()}
        first = next(iter(inputs))
        row = {
            "name": k,
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": launches[k],
            "max_abs_err": err[k],
            "ms": ms[first],
            "plain_ms": time_slow_ms(lambda: plain(inputs[first])),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        # the counts bound_ms is computed from (not measured)
        print(json.dumps({"bound_inputs": {"name": k, "bytes": nbytes, "ops": ops}}), flush=True)
        times.update({f"{k} ({lay})": {"ms": t, "byte_bound_share": t_bytes / t}
                      for lay, t in ms.items()})
    for k, v in variants.items():
        if callable(v):
            times[k] = {"ms": time_ms(v)}
            continue
        fn, nbytes, ops, plain = v
        t = time_ms(fn)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
        times[k] = {"ms": t, "plain_ms": time_slow_ms(plain), "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "bytes": nbytes, "ops": ops, "bound_share": max(t_bytes, t_ops) / t}
    print(json.dumps({"kernel_variants": times}), flush=True)
    return rows


# --- the thirteenth slice: the dense metric, ChEES, SMC, ADVI, checkpoints -

# path 21: run_smc's settings. n_mutations and the leapfrogs an HMC move are
# the slice's; the step and the ESS target (12 stages) were chosen on the
# JAX package's float64 runs of the same model on the CPU
SMC_N, SMC_MUTATIONS, SMC_LEAPFROG, SMC_EPS, SMC_TARGET_ESS = 32768, 10, 8, 1.0, 0.97
# the JAX package's float64 run_smc on the CPU at those settings, seeds 0-3
# (python tests/test_torch_smc_advi.py --engine jax --seeds 0 1 2 3): the
# mean log evidence and the standard deviation of the four
SMC_LOGEV_JAX = (-3.9899568849669835, 0.006636568041743165)
# path 22: fit_advi's settings: the slice's n_mc; 1000 Adam steps at the
# JAX package's default rate
ADVI_MC, ADVI_STEPS, ADVI_LR = 1024, 1000, 1e-2


def dense_precision_ok():
    """The dense metric's products stay at float32's full precision: TF32
    off for matmuls, the float32 matmul precision 'highest'."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def run_chees_dense(dev):
    """Path 19, chees_dense: the steps of `Model(pdonly,
    loglik).sample(kernel='chees', metric='dense')` on cell 7's
    pd_conjugate data, with its starts at PD_INIT_SCALE * N(0, 1):
    `sample_with_kernel` routes 'chees' to `run_chees` on
    `batched_logdensity_fn()`, batch-major, as the JAX package does. Every
    lockstep leapfrog runs the PD log-density kernel (#11) and its
    trace-gradient kernel (#12) for the prior, the PD inverse kernel (#10)
    and its backward for the likelihood's W. 64 chains, 300 warmup and 200
    kept transitions, torch seed 0; the trajectory length is read to the
    host once a transition. Gates as cell 7's: max R-hat <= 1.05,
    divergences <= 1%, W's diagonal within 5 MCSE of the Wishart
    posterior's 218 diag((I + Z'Z)^-1)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import chees, hmc_batched, sample_with_kernel

    expect("chees_dense: TF32 off and float32 matmul precision 'highest'",
           dense_precision_ok())
    loglik, post = pd_conjugate_data(dev)
    model = tbt.Model(pd_model(dists, dev, torch.float32, "wishart"), loglik=loglik, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the warmup ends where the first sampling transition starts
    mark, step = {}, chees._sample_step

    def first_sampling_step(*args, **kw):
        if not mark:
            torch.cuda.synchronize()
            mark.update(t=time.perf_counter(), launches=dict(kernels.LAUNCHES),
                        syncs=hmc_batched.SYNCS["trajectory"])
        return step(*args, **kw)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    chees._sample_step = first_sampling_step
    try:
        raw, state, stats = sample_with_kernel(
            model.batched_logdensity_fn(), gen, model.init_positions(gen, CHAINS, PD_INIT_SCALE),
            n_warmup=WARMUP, n_samples=KEPT, kernel="chees", metric="dense",
        )
    finally:
        chees._sample_step = step
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    syncs = hmc_batched.SYNCS["trajectory"] - mark["syncs"]
    samples = model.constrain(raw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"launches on the chees_dense path: {launches}", flush=True)
    during = {k: launches[k] - mark["launches"][k] for k in launches}
    leapfrogs = int(stats.n_steps.sum())
    for k in ("pd_logdensity", "pd_trace_grad", "pd_inverse"):
        expect(f"chees_dense: {k} launched every sampling leapfrog ({during[k]} for "
               f"{leapfrogs})", during[k] >= leapfrogs > 0)
    expect("chees_dense: a dense (151, 151) inverse mass",
           tuple(state.inv_mass.shape) == (151, 151))
    expect(f"chees_dense: raw draws ({KEPT}, {CHAINS}, 151) and finite",
           tuple(raw.shape) == (KEPT, CHAINS, 151) and bool(torch.isfinite(raw).all()))
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    Wd = torch.diagonal(samples["W"], dim1=-2, dim2=-1)
    dev_w = np.abs(Wd.double().mean(dim=(0, 1)).cpu().numpy() - post) / diagnostics.mcse_mean(Wd)
    n_div = int(stats.diverging.sum())
    sampling_s = t2 - mark["t"]
    line = {
        "kernel": "chees", "cell": "chees_dense", "metric": "dense",
        "chains": CHAINS, "warmup": WARMUP, "kept": KEPT, "init_scale": PD_INIT_SCALE,
        "warmup_s": mark["t"] - t0,
        "sampling_s": sampling_s,
        "constrain_s": t3 - t2,
        "draws_per_s": CHAINS * KEPT / sampling_s,
        "leapfrogs_per_transition": leapfrogs / KEPT,
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_transition": syncs / KEPT,
        "step_size": float(state.eps),
        "trajectory_length": float(torch.exp(state.log_t)),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "transitions": CHAINS * KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "min_ess_bulk": float(np.min(ess)),
        "max_W_diag_dev_in_mcse": float(np.max(dev_w)),
    }
    expect(f"chees_dense: one host read a transition ({syncs} for {KEPT})", syncs == KEPT)
    expect(f"chees_dense: max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"chees_dense: divergences {n_div} <= 1% of {CHAINS * KEPT}",
           n_div <= 0.01 * CHAINS * KEPT)
    expect(f"chees_dense: W diagonal means within 5 MCSE of Wishart(218, (I + Z'Z)^-1) "
           f"(max {np.max(dev_w):.2f})", bool(np.all(dev_w <= 5.0)))
    return line, {k: launches[k] for k in ("pd_logdensity", "pd_trace_grad", "pd_inverse")}


def same_bits(a, b):
    """Two sampler states' leaves equal bit for bit (tensors in dtype and
    device too, generators in their state)."""
    if isinstance(a, tuple):
        return type(a) is type(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Generator):
        return a.device == b.device and torch.equal(a.get_state(), b.get_state())
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.device == b.device and a.shape == b.shape
                and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes())
    return type(a) is type(b) and a == b


def run_eight_schools_dense(dev):
    """Path 20, eight_schools_dense: cell 14's model and settings (64
    chains, max_depth 8, 300 warmup and 200 kept transitions, target 0.8,
    starts 0.5 N(0, 1), torch seed 0) with metric='dense' on
    `nuts_batched_t`: each leapfrog runs #2's item kernel, and the dense
    metric's products run in the transposed layout. Between the warmup and
    `resume_sampling` the state goes through `save_sampler_state` and
    `load_sampler_state` (a temporary directory); every field must come
    back bit for bit. Gates: cell 14's."""
    import tempfile

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, resume_sampling, warmup_and_sample
    from tpu_bijectors_torch.shard import load_sampler_state, save_sampler_state

    expect("eight_schools_dense: TF32 off and float32 matmul precision 'highest'",
           dense_precision_ok())
    model = tbt.Model(eight_schools_model(dists, dev, torch.float32),
                      loglik=eight_schools_loglik(dev, torch.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    density = model.batched_logdensity_t_fn()
    kw = dict(kernel="nuts_batched_t", max_depth=MAX_DEPTH)
    _, state, _ = warmup_and_sample(
        density, gen, model.init_positions(gen, CHAINS, ES_INIT_SCALE), n_warmup=WARMUP,
        n_samples=0, target_accept=ES_TARGET, metric="dense", **kw,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/eight_schools_dense.npz"
        save_sampler_state(path, state)
        loaded = load_sampler_state(path, state)
    torch.cuda.synchronize()
    t_ck = time.perf_counter()
    expect("eight_schools_dense: every field of the loaded state bit for bit the saved one's",
           same_bits(loaded, state))
    expect("eight_schools_dense: a dense (10, 10) inverse mass",
           tuple(loaded.inv_mass.shape) == (10, 10))
    l1, s1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    raw, state, stats = resume_sampling(density, loaded, KEPT, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    l2, s2 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["any_active"]
    x = model.constrain(raw)
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the eight_schools_dense path: {launches}", flush=True)
    during = {k: l2[k] - l1[k] for k in l2}
    leapfrogs = during[SMALL]
    expect(f"{SMALL} launched on the eight_schools_dense path", leapfrogs > 0)
    expect("eight_schools_dense: raw draws (200, 64, 10) and finite",
           tuple(raw.shape) == (KEPT, CHAINS, 10) and bool(torch.isfinite(raw).all()))
    sampling_s = t2 - t_ck
    r_hat = diagnostics.rhat(raw)
    ess = diagnostics.ess_bulk(raw)
    n_div = int(stats.diverging.sum())
    dev_in_mcse = {}
    for k in ("mu", "tau"):
        draws = x[k].double()
        mean, mcse = float(draws.mean()), float(diagnostics.mcse_mean(draws))
        ref_mean, ref_mcse = ES_JAX[k]
        dev_in_mcse[k] = abs(mean - ref_mean) / math.hypot(mcse, ref_mcse)
    line = {
        "kernel": "nuts_batched_t", "cell": "eight_schools_dense", "metric": "dense",
        "chains": CHAINS, "warmup": WARMUP, "kept": KEPT, "max_depth": MAX_DEPTH,
        "target_accept": ES_TARGET, "init_scale": ES_INIT_SCALE,
        "warmup_s": t1 - t0,
        "checkpoint_s": t_ck - t1,
        "sampling_s": sampling_s,
        "draws_per_s": CHAINS * KEPT / sampling_s,
        "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * sampling_s / max(leapfrogs, 1),
        "host_syncs_per_leapfrog": (s2 - s1) / max(leapfrogs, 1),
        "step_size": float(state.eps),
        "mean_accept": float(stats.accept_prob.mean()),
        "divergences": n_div,
        "transitions": CHAINS * KEPT,
        "launches_during_sampling": during,
        "max_rhat": float(np.max(r_hat)),
        "min_ess_bulk": float(np.min(ess)),
        "mu_dev_in_mcse": dev_in_mcse["mu"],
        "tau_dev_in_mcse": dev_in_mcse["tau"],
    }
    expect(f"eight_schools_dense: max R-hat {line['max_rhat']:.4f} <= 1.05",
           line["max_rhat"] <= 1.05)
    expect(f"eight_schools_dense: divergences {n_div} <= 1% of {CHAINS * KEPT}",
           n_div <= 0.01 * CHAINS * KEPT)
    for k, d in dev_in_mcse.items():
        expect(f"eight_schools_dense: the mean of {k} within 5 combined MCSE of the JAX "
               f"package's ({d:.2f})", d <= 5.0)
    return line, {SMALL: launches[SMALL]}


def eight_schools_loglik_t(u, device, dtype):
    """Cell 14's likelihood on the transposed (dim, N) block, batch-capable
    (SMC's likelihood): x from the swapped view, the same sum over the
    schools a column."""
    y = torch.as_tensor(ES_Y, dtype=dtype, device=device)
    sigma = torch.as_tensor(ES_SIGMA, dtype=dtype, device=device)

    def loglik_t(vT):
        x = u.from_linked_vec(vT.transpose(0, 1))[0]
        theta = x["mu"][:, None] + x["tau"][:, None] * x["theta_raw"]
        return torch.sum(-0.5 * ((y - theta) / sigma) ** 2, dim=-1)

    loglik_t.batch_capable = True
    return loglik_t


def run_smc_eight_schools(dev):
    """Path 21, smc_eight_schools: `run_smc(prior, loglik, ...,
    transposed=True, mutation='hmc')` on SMC_N particles with the SMC_*
    settings, torch seed 0. The prior is `Model(priors).batched_logdensity_
    t_fn()`: its value is the whole-model value kernel (#1), and its
    gradient in the HMC mutation's leapfrogs the vector-Jacobian kernel
    (#3); the likelihood is cell 14's on the (10, N) block
    (`eight_schools_loglik_t`). The particles start from the prior's draws
    (mu ~ N(0, 5), tau ~ HalfCauchy(5), theta_raw ~ N(0, 1)) mapped to linked
    space by `to_linked_vec`. Gates: final beta 1; the means of mu and tau
    within 5 standard errors (the particles' sd / sqrt(N)) of the exact
    posterior means (`eight_schools_exact_means`; their distance from
    the JAX package's NUTS means ES_JAX, in combined standard errors, is
    printed too); the log evidence within 4 spreads of the JAX package's
    float64 run_smc at the same settings (SMC_LOGEV_JAX)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, run_smc

    prior_model = tbt.Model(eight_schools_model(dists, dev, torch.float32), device=dev)
    u = prior_model.unconstrainer()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = dict(generator=gen, dtype=torch.float32, device=dev)
    n = SMC_N
    x0 = {"mu": 5.0 * torch.randn(n, **f32),
          "tau": 5.0 * torch.abs(torch.tan(math.pi * (torch.rand(n, **f32) - 0.5))),
          "theta_raw": torch.randn((n, 8), **f32)}
    p0 = u.to_linked_vec(x0)[0].T.contiguous()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    res = run_smc(
        prior_model.batched_logdensity_t_fn(), eight_schools_loglik_t(u, dev, torch.float32),
        gen, p0, n_mutations=SMC_MUTATIONS, target_ess=SMC_TARGET_ESS, mutation="hmc",
        hmc_eps=SMC_EPS, hmc_leapfrog=SMC_LEAPFROG, transposed=True,
    )
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    syncs = hmc_batched.SYNCS["stage"]
    print(f"launches on the smc_eight_schools path: {launches}", flush=True)
    for k in ("slab_value", "slab_vjp"):
        expect(f"smc_eight_schools: {k} launched ({launches[k]})", launches[k] > 0)
    expect(f"smc_eight_schools: particles (10, {n}) and finite",
           tuple(res.particles.shape) == (10, n) and bool(torch.isfinite(res.particles).all()))
    x = u.from_linked_vec(res.particles.T)[0]
    exact = eight_schools_exact_means()
    dev_in_se, dev_jax, stats = {}, {}, {}
    for k in ("mu", "tau"):
        d = x[k].double()
        mean, se = float(d.mean()), float(d.std()) / math.sqrt(n)
        dev_in_se[k] = abs(mean - exact[k]) / se
        ref_mean, ref_mcse = ES_JAX[k]
        dev_jax[k] = abs(mean - ref_mean) / math.hypot(se, ref_mcse)
        stats[k] = (mean, se)
    logev = float(res.log_evidence)
    ref_ev, spread = SMC_LOGEV_JAX
    leapfrogs = res.n_stages * SMC_MUTATIONS * SMC_LEAPFROG
    line = {
        "engine": "run_smc", "cell": "smc_eight_schools", "mutation": "hmc",
        "transposed": True, "particles": n, "n_mutations": SMC_MUTATIONS,
        "hmc_leapfrog": SMC_LEAPFROG, "hmc_eps": SMC_EPS, "target_ess": SMC_TARGET_ESS,
        "seconds": t1 - t0,
        "stages": res.n_stages,
        "ms_per_stage": 1e3 * (t1 - t0) / max(res.n_stages, 1),
        "batched_leapfrogs": leapfrogs,
        "ms_per_leapfrog": 1e3 * (t1 - t0) / max(leapfrogs, 1),
        "host_syncs_per_stage": syncs / max(res.n_stages, 1),
        "final_beta": float(res.final_beta),
        "log_evidence": logev,
        "log_evidence_jax": ref_ev,
        "log_evidence_dev_in_spreads": abs(logev - ref_ev) / spread,
        "launches": {k: launches[k] for k in ("slab_value", "slab_vjp")},
        "mu_mean": stats["mu"][0], "mu_se": stats["mu"][1],
        "tau_mean": stats["tau"][0], "tau_se": stats["tau"][1],
        "mu_exact": exact["mu"], "tau_exact": exact["tau"],
        "mu_dev_in_se": dev_in_se["mu"],
        "tau_dev_in_se": dev_in_se["tau"],
        "mu_dev_from_nuts_jax_in_se": dev_jax["mu"],
        "tau_dev_from_nuts_jax_in_se": dev_jax["tau"],
    }
    print(f"smc_eight_schools: log evidence {logev:.5f}; the JAX package's float64 "
          f"{ref_ev:.5f} (spread {spread:.5f})", flush=True)
    expect(f"smc_eight_schools: final beta {line['final_beta']} == 1", line["final_beta"] == 1.0)
    for k, d in dev_in_se.items():
        expect(f"smc_eight_schools: the mean of {k} within 5 standard errors of the exact "
               f"posterior mean ({d:.2f}; from the JAX package's NUTS mean {dev_jax[k]:.2f} "
               f"combined)", d <= 5.0)
    expect(f"smc_eight_schools: log evidence within 4 spreads of the JAX package's "
           f"({line['log_evidence_dev_in_spreads']:.2f})",
           line["log_evidence_dev_in_spreads"] <= 4.0)
    return line, {k: launches[k] for k in ("slab_value", "slab_vjp")}


def mv_posterior_sd(p):
    """The posterior sd of each of mv_conjugate's 151 linked coordinates:
    the likelihood's copy sqrt(diag(L_A L_A') / 201), the other Gaussian
    copies sqrt(diag(L_A L_A')), the canonical block sqrt(diag(J^-1)), the
    t(5) copies sqrt(5/3 diag(L_B L_B')), the log-normal's and the diagonal
    normal's scales."""
    sa = np.sqrt(np.diag(p["LA"] @ p["LA"].T))
    sb = np.sqrt(p["df"] / (p["df"] - 2.0) * np.diag(p["LB"] @ p["LB"].T))
    return np.concatenate([sa / math.sqrt(MV_N_OBS + 1), np.tile(sa, 3),
                           np.sqrt(np.diag(np.linalg.inv(p["J"]))), np.tile(sb, 4),
                           p["ln_scale"], p["diag_scale"]])


def run_advi_mv(dev):
    """Path 22, advi_mv_conjugate: `fit_advi(Model(mvdense,
    loglik).batched_logdensity_t_fn(), ..., q=FullRankGaussian,
    estimator='stl', transposed=True)` with n_mc ADVI_MC on cell 10's
    mv_conjugate model: every step's density is the whole-model value kernel
    (#1) with the Gaussian and t loop entries plus the likelihood, and its
    backward the vector-Jacobian kernel (#3) with the cotangent of the
    mean. ADVI_STEPS Adam steps at ADVI_LR, torch seed 0. Every block of
    this posterior is Gaussian in linked space or symmetric, so the fit's
    mean is the posterior's. Gates: every fitted mean within 0.25
    posterior sd of the known one; the likelihood block's fitted variances
    within 15% of diag(Sigma / 201); the mean loss of the last 100 steps
    below that of the first 100."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.infer import FullRankGaussian, fit_advi

    d, p, post = mvdense_model(dists, dev, torch.float32)
    loglik, post0 = mv_conjugate_data(dev, p["LA"], p["muA"])
    post[:MV_K] = post0
    sd = mv_posterior_sd(p)
    model = tbt.Model(d, loglik=loglik, device=dev)
    dim = model.dim()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fit_advi(model.batched_logdensity_t_fn(), gen, dim,
                   q=FullRankGaussian.init(dim, torch.float32, dev), n_steps=ADVI_STEPS,
                   n_mc=ADVI_MC, learning_rate=ADVI_LR, estimator="stl", transposed=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the advi_mv_conjugate path: {launches}", flush=True)
    for k in ("slab_value", "slab_vjp"):
        expect(f"advi_mv_conjugate: {k} launched every step ({launches[k]} for {ADVI_STEPS})",
               launches[k] >= ADVI_STEPS)
    loc = res.q.loc.double().cpu().numpy()
    L = res.q._L().double()
    var = torch.sum(L * L, dim=1).cpu().numpy()
    mean_dev = np.abs(loc - post) / sd
    var_ref = np.diag(p["LA"] @ p["LA"].T) / (MV_N_OBS + 1)
    var_dev = np.abs(var[:MV_K] / var_ref - 1.0)
    losses = res.losses.double().cpu().numpy()
    line = {
        "engine": "fit_advi", "cell": "advi_mv_conjugate", "q": "FullRankGaussian",
        "estimator": "stl", "transposed": True, "n_mc": ADVI_MC, "n_steps": ADVI_STEPS,
        "learning_rate": ADVI_LR,
        "seconds": t1 - t0,
        "steps_per_s": ADVI_STEPS / (t1 - t0),
        "ms_per_step": 1e3 * (t1 - t0) / ADVI_STEPS,
        "launches": {k: launches[k] for k in ("slab_value", "slab_vjp")},
        "max_mean_dev_in_sd": float(np.max(mean_dev)),
        "max_theta_var_rel_dev": float(np.max(var_dev)),
        "loss_first_100": float(np.mean(losses[:100])),
        "loss_last_100": float(np.mean(losses[-100:])),
    }
    expect("advi_mv_conjugate: losses finite", bool(np.all(np.isfinite(losses))))
    expect(f"advi_mv_conjugate: every fitted mean within 0.25 posterior sd of the known one "
           f"(max {line['max_mean_dev_in_sd']:.3f})", line["max_mean_dev_in_sd"] <= 0.25)
    expect(f"advi_mv_conjugate: theta's fitted variances within 15% of diag(Sigma / 201) "
           f"(max {line['max_theta_var_rel_dev']:.3f})", line["max_theta_var_rel_dev"] <= 0.15)
    expect(f"advi_mv_conjugate: mean loss of the last 100 steps {line['loss_last_100']:.3f} "
           f"below the first 100's {line['loss_first_100']:.3f}",
           line["loss_last_100"] < line["loss_first_100"])
    return line, {k: launches[k] for k in ("slab_value", "slab_vjp")}


# --- the fourteenth slice: L-BFGS, MAP + Laplace, Pathfinder, evidence ------

# the JAX package's float64 references on the bench model with
# hier_loglik, made on the CPU by `python tests/test_torch_pathfinder_
# evidence.py --engine jax --seeds 0 1 2 3 4 5 6 7`: map_laplace (200 steps
# from zeros: lp at the MAP, the MAP, the Laplace evidence), the mean and
# spread (standard deviation over the eight seeds) of
# importance_sampling_evidence with that Laplace proposal at n = 4096;
# fit_pathfinder from zeros and multipath_pathfinder from 8 starts at
# 0.3 N(0, 1), at their defaults: the best ELBO's mean and spread, and the
# `w` block's means over the seeds with each coordinate's posterior sd and
# the seeds' spread of the means in units of it, pooled over the 16, and
# multi-path's importance ESS a seed
LAPLACE_JAX = {
    "lp": -541.7529341276614,
    "log_evidence": -580.0157091706055,
    "is_log_evidence": (-577.2319442508477, 0.09263625361683892),
    "position": (
        0.2762798137850521, 0.6553678685046792, 0.2641812011475677,
        -1.035018748796461, 0.7217315919185009, 0.3567428422939823,
        -0.4289790850465376, 0.46417021649552376, 0.0011955197189806091,
        0.006802981833936891, 0.0010928815757635197, 0.017328782296834194,
        0.008274826169715291, 0.0019964786880779313, 0.0028920397390438065,
        0.003389366505624764, 0.0388398378855569, -0.6880322007480535,
        0.15015229242563868, 0.018018507580046507, -0.14763602000041823,
        0.2231435786030607, -0.13815035840673498, -0.06513931143687691,
        -0.36662533007420106, -0.12062800414096678, -0.23638881046596563,
        -0.19189103287056367, 0.18232157772666782, -0.20763939159044337,
        -3.832913682113081e-15, -0.01404705907634054, -0.01673724858350589,
        0.0014232460974109545, -0.002653212769254749, -0.005632241104210629,
        -0.0032571872223275274, -0.002348232802403511, -0.003125571233334454,
        0.0009187010995043803, 0.011953100788913226, 0.00475105948870497,
        0.006738406552563189, 0.003143674294496194, -0.008648591931072301,
        -0.01130851891774085, 0.0049571220242808365, 0.009560814083136427,
        -0.00779408101357595, -0.026444878026630574, 0.0023645575131051116,
        0.018625499465129935, 0.007247837108795667, -0.001778477500505649,
        -0.011970428488529744, -0.00042602692339103906, -0.00020387652706853454,
        -0.013393585850593772, 0.001720128947798661, -0.009155686201825292,
        -0.008922205521487208, -0.012310999009900963, -0.005891496167861919,
        -0.004416644854800526, -0.007664529093673567, 0.005887484539137368,
        -0.020244497622673305, -0.0010444805811205124, -0.0002861409867186443,
        0.0003509665162340188, 0.004859448309800823, -0.00023653991514549575,
        -0.0018326386544600423, -0.005117084222645007, -0.010817740875105727,
        0.01639429975106252, 0.027092711037826168, 0.010508975730339992,
        -0.010239317574395937, -0.0036967069022122733, 0.0008019407057367841,
        -0.005514080580831215, -0.0031975579966222367, -0.008116363132780881,
        0.01057293135873829, -0.003970669731588208, -0.0027763403001825377,
        0.012704188333493722, 0.014128952587849821, -0.017831314750039177,
        -0.007537416379334966, -0.004837991536407817, -0.003138472865187916,
        -0.013771072847960312, 0.012076025368045763, -0.003469961002563297,
        -0.003002455087998945, -0.0029786758634970448, -0.007564462452869094,
        0.0037420902869542204, -0.010223263406309102, 0.0029236948763846204,
        -0.0015191088278271804, 0.010758375277632336, 0.0013671263100247884,
        0.00061448679759379, 0.0074252906330047035, -0.027280036435193444,
        -0.02716697530858049, -0.00011414042237855459, 0.0020404687358771562,
        -0.023059127328193645, 0.008906868272319585, -0.0027045408761122215,
        -0.01627724059845504, 0.0028092015503046307, -0.0038278626243234345,
        -0.0042503818903692715, 0.006658827596596544, 0.01211343165566555,
        0.0006743270611245776, -0.045213591645067976, -0.005635357431621507,
        -0.005080180585907139, 0.0038462035835077186, 0.0023782186959902677,
        0.005690082637745607, 0.005684401452505218, -0.0038584705888433926,
        -0.004320329225882515, 0.0014781001281892055, -0.007303208458391064,
        0.002153276695208433, -0.00102758568545037, -0.014941368896873666,
        -0.02874070572103079, -0.004331225708877146, 0.005452346208541269,
        -0.0012482844128370958, -0.004118687733517181, -0.0013613363132675754,
        -0.0014132477451023343, -0.008861228056729085, 0.0017123034844724362,
        0.022677444904768012, -0.037560984760388896, 0.045418407572190296,
        -0.011676706920131405, -0.005193064298921072, -0.012466724514285295,
        -0.044814912783384675,
    ),
}
PATHFINDER_JAX = {
    "single_elbo": (-581.2112012816106, 0.2804685299234746),
    "multi_elbo": (-580.1824857553731, 0.24172724150365357),
    "single_w": {
        "mean": (
            0.06702804672892206, 0.03448911977220098, 0.07578421668203586,
            0.0670973217410491, 0.05746643201980971, 0.08063968377166425,
            0.05682605406204773, 0.06115963176326703, 0.046575464303172914,
            0.060146773945494114, 0.054963323002509945, 0.058479053296175705,
            0.08117560512631028, 0.057689239650047595, 0.0703853541693749,
            0.07009467996591787,
        ),
        "sd": (
            0.016484722907495836, 0.011589112894321041, 0.018864232583619342,
            0.016282313769369214, 0.016185729852275045, 0.01777783636039689,
            0.014386383150912027, 0.015714574565136648, 0.012651534392960422,
            0.015195033832477707, 0.015199946293311003, 0.01620116125330674,
            0.01885655771672653, 0.0162930468926547, 0.01786145035559724,
            0.016564970023364472,
        ),
        "spread_in_sd": 0.10371786738004947,
    },
    "multi_w": {
        "mean": (
            0.06384098063465918, 0.03291391069053067, 0.073335530978321,
            0.06641714269445924, 0.05692593155380935, 0.07925210483899414,
            0.05452825407943829, 0.06104189188470219, 0.04745325114688166,
            0.06002107198224482, 0.05515197248805641, 0.05925833126818536,
            0.0834458234898949, 0.0602083329832971, 0.07237555763126195,
            0.0738299116552635,
        ),
        "sd": (
            0.016484722907495836, 0.011589112894321041, 0.018864232583619342,
            0.016282313769369214, 0.016185729852275045, 0.01777783636039689,
            0.014386383150912027, 0.015714574565136648, 0.012651534392960422,
            0.015195033832477707, 0.015199946293311003, 0.01620116125330674,
            0.01885655771672653, 0.0162930468926547, 0.01786145035559724,
            0.016564970023364472,
        ),
        "spread_in_sd": 0.17998323521329374,
        "ess": (
            75.5631504856155, 41.160309665800305, 91.7250831419852,
            47.113048155273525, 6.732225318417794, 58.154804512103986,
            73.02150999973657, 52.04085040369641,
        ),
    },
}
# Pathfinder in float32 (the same script with --dtype float32, x64 off):
# float32's L-BFGS reaches its noise floor after about 20 steps and the
# curvature pairs after it spoil the later candidates, so the best
# candidate is an earlier one and its ELBO about 2 below float64's, in
# both packages (the port in float64 on the CPU lands on the float64
# runs). The card's float32 ELBO is held to these. Its `w` means are held
# to the float64 runs': over nine seeds on the H100 multi-path's sit
# within 1.2-3.5 standard errors of them, but up to 4.9 of the CPU's
# float32 runs, whose stall points (and so candidates) round otherwise
PATHFINDER_JAX_F32 = {
    "single_elbo": (-583.0403289794922, 0.3631095784581007),
    "multi_elbo": (-582.1523513793945, 0.41792230951287646),
    "single_w": {
        "mean": (
            0.06851355452090502, 0.03349690558388829, 0.07467193529009819,
            0.06794025842100382, 0.05610552150756121, 0.07930335681885481,
            0.05690996674820781, 0.06081037176772952, 0.047309876419603825,
            0.05953854601830244, 0.054959146305918694, 0.06031942553818226,
            0.08118962310254574, 0.05720015475526452, 0.07100790739059448,
            0.07072343956679106,
        ),
        "sd": (
            0.01779570069629699, 0.010997508419677615, 0.017649871530011296,
            0.018090519472025335, 0.016238814569078386, 0.017846019356511533,
            0.015710475738160312, 0.01579852739814669, 0.013468382880091667,
            0.01548329635988921, 0.014485266176052392, 0.014970923424698412,
            0.01974970498122275, 0.015075526665896177, 0.017923515988513827,
            0.016041336697526276,
        ),
        "spread_in_sd": 0.09461529744810722,
    },
    "multi_w": {
        "mean": (
            0.06753637176007032, 0.03334905533120036, 0.07332155480980873,
            0.06571750249713659, 0.057850418612360954, 0.07792789023369551,
            0.0560185331851244, 0.061172544956207275, 0.047070985194295645,
            0.05970709025859833, 0.055353786796331406, 0.060065486934036016,
            0.08177562523633242, 0.058881440199911594, 0.07389799132943153,
            0.07035358669236302,
        ),
        "sd": (
            0.01779570069629699, 0.010997508419677615, 0.017649871530011296,
            0.018090519472025335, 0.016238814569078386, 0.017846019356511533,
            0.015710475738160312, 0.01579852739814669, 0.013468382880091667,
            0.01548329635988921, 0.014485266176052392, 0.014970923424698412,
            0.01974970498122275, 0.015075526665896177, 0.017923515988513827,
            0.016041336697526276,
        ),
        "spread_in_sd": 0.19652159313602777,
        "ess": (
            60.536552296712344, 54.77024205992333, 64.082787766537,
            59.43234975865161, 66.85568911798059, 14.985808497069842,
            26.377221277549957, 35.11163231098356,
        ),
    },
}
# the steps of every map_laplace run, and the evidence estimators' n
MAP_STEPS = 200
EVIDENCE_N = 4096
# path 23's bounds, float32 on the card against float64. lp at the MAP:
# RTOL_LP of its magnitude, as path 1's lp (the float32 sums of 151 rows;
# the MAP's suboptimality is second order and far inside it). The MAP:
# float32 resolves lp only to eps32 |lp|, so along a direction scaled by
# the Laplace sd the mode is located to sqrt(2 eps32 |lp|) (0.011 sd at
# |lp| = 542); each coordinate is held to 4 times that. The Laplace sd and
# evidence against the port's float64 Hessian at the card's own MAP: the
# float32 Hessian's entries carry eps32 times the magnitudes they sum, and
# its factor amplifies that by the condition number kappa(H): each sd is
# held to 4 dim eps32 kappa relative, the evidence (half log|H|, a sum of
# dim logs of the factor's diagonal) to 4 dim eps32 kappa plus lp's bound.
# The pd_conjugate Hessian entries: 4 eps32 times the sum over the K^2
# products the trace and log-det terms form, K^2 max|H| (the same float32
# sums; a dropped trace curvature moves entries by O(max|H|)).
MAP_SD_SPREADS = 4.0
EPS32_ = float(np.finfo(np.float32).eps)
# the evidence estimators against the JAX package's IS mean: 4 spreads;
# Pathfinder's best ELBO and the `w` means: 4 spreads
EVIDENCE_SPREADS = PF_SPREADS = 4.0


def laplace_reference(model64, v):
    """The port's float64 Laplace approximation at v on the CPU (its plain
    versions), its Hessian's condition number and the Hessian."""
    from tpu_bijectors_torch.infer import laplace_approximation

    lap = laplace_approximation(model64.logdensity_fn(), v.detach().double().cpu())
    prec = lap.chol_precision @ lap.chol_precision.T
    ev = torch.linalg.eigvalsh(prec)
    return lap, float(ev.max() / ev.min()), -prec


def run_map_laplace(dev, loglik, posterior):
    """Path 23, map_laplace: (a) `map_laplace(Model(bench, hier_loglik))`
    from zeros, MAP_STEPS L-BFGS steps, float32 on the card: every
    line-search trial evaluates the batch-major density and its gradient
    at B = 1 (#6 with W and #7 in its small design), the Hessian is one
    double backward at B = dim = 151 through the same kernels. (b) lp and
    the MAP against the JAX package's float64 map_laplace (LAPLACE_JAX),
    the Laplace sd and evidence against the port's float64 Hessian at the
    card's MAP on the CPU. (c) `map_laplace` on path 7's pd_conjugate
    model (#10, #11 and #12, #12 under the double backward) and its
    Hessian at the card's MAP against the float64 Hessian at the same
    point. (d) `importance_sampling_evidence` and
    `bridge_sampling_evidence` with the Laplace proposal at n =
    EVIDENCE_N (the bridge's posterior draws: path 2's last 64 kept
    transitions of its 64 chains), each one batched density call at
    4096, against the JAX package's IS mean. Returns (the `map_laplace`
    line, the launches)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.infer import (
        bridge_sampling_evidence,
        hmc_batched,
        importance_sampling_evidence,
        map_laplace,
    )
    from tpu_bijectors_torch.infer.map_laplace import hessian

    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    cpu_loglik, _ = hier_loglik_and_counts("cpu")
    model64 = tbt.Model(bench_model(dists, "cpu", torch.float64), loglik=cpu_loglik,
                        device="cpu")
    line = {"engine": "map_laplace", "cell": "map_laplace", "n_steps": MAP_STEPS}
    # (a) MAP and Laplace on the bench model
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    res, lap = map_laplace(model, n_steps=MAP_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    reads = hmc_batched.SYNCS["linesearch"]
    print(f"launches on the map_laplace path: {launches}", flush=True)
    # evaluations: one a trial, the first step's value, the final gradient
    # (each launches #6 once at B = 1), then the Hessian's and the mode's lp
    evals = launches["lkj_inverse"] - 2
    expect(f"map_laplace: #6 once an evaluation ({launches['lkj_inverse']} launches for "
           f"{reads} line-search reads + 2 + the Hessian's and the mode's)",
           launches["lkj_inverse"] == reads + 4)
    expect(f"map_laplace: #7's small design once an evaluation "
           f"({launches[SIMPLEX_SMALL]})", launches[SIMPLEX_SMALL] == launches["lkj_inverse"])
    lp, gnorm = float(res.logdensity), float(res.grad_norm)
    ref64, kappa, _ = laplace_reference(model64, res.position)
    sd, sd64 = lap.marginal_sd().double().cpu(), ref64.marginal_sd()
    pos_dev = ((res.position.double().cpu() - torch.tensor(LAPLACE_JAX["position"], dtype=
                                                           torch.float64)).abs() / sd64)
    pos_bound = MAP_SD_SPREADS * math.sqrt(2.0 * EPS32_ * abs(LAPLACE_JAX["lp"]))
    h_rtol = MAP_SD_SPREADS * 151 * EPS32_ * kappa
    sd_dev = float(((sd - sd64).abs() / sd64).max())
    ev, ev64 = float(lap.log_evidence()), float(ref64.log_evidence())
    lp_bound = RTOL_LP * abs(LAPLACE_JAX["lp"])
    line.update({
        "seconds": t1 - t0, "steps": MAP_STEPS, "evaluations": evals,
        "linesearch_reads": reads, "ms_per_evaluation": 1e3 * (t1 - t0) / max(evals, 1),
        "grad_norm": gnorm, "lp": lp, "lp_jax": LAPLACE_JAX["lp"],
        "max_map_dev_in_sd": float(pos_dev.max()), "map_bound_in_sd": pos_bound,
        "hessian_kappa": kappa, "max_sd_rel_dev": sd_dev, "sd_rtol": h_rtol,
        "log_evidence": ev, "log_evidence_f64": ev64,
        "log_evidence_jax": LAPLACE_JAX["log_evidence"],
        "launches": {k: launches[k] for k in (SIMPLEX_SMALL, "lkj_inverse")},
    })
    print(f"map_laplace: {MAP_STEPS} steps, {evals} evaluations, {reads} line-search reads "
          f"in {t1 - t0:.2f} s; |grad| {gnorm:.3e}", flush=True)
    expect(f"map_laplace: lp at the MAP {lp:.5f} within {lp_bound:.4f} of the JAX package's "
           f"{LAPLACE_JAX['lp']:.5f}", abs(lp - LAPLACE_JAX["lp"]) <= lp_bound)
    expect(f"map_laplace: the MAP within {pos_bound:.4f} Laplace sd of the JAX package's "
           f"(max {float(pos_dev.max()):.4f})", float(pos_dev.max()) <= pos_bound)
    expect(f"map_laplace: marginal sd within {h_rtol:.2e} of the float64 Hessian's at the "
           f"card's MAP (kappa {kappa:.1f}; max {sd_dev:.2e})", sd_dev <= h_rtol)
    ev_bound = h_rtol + lp_bound
    expect(f"map_laplace: log evidence {ev:.4f} within {ev_bound:.4f} of the float64 "
           f"Hessian's {ev64:.4f}", abs(ev - ev64) <= ev_bound)
    # (c) the Wishart leg: pd_conjugate's Hessian through #10-#12
    pd_loglik, _ = pd_conjugate_data(dev)
    pd_model64_ll, _ = pd_conjugate_data("cpu")
    pdm = tbt.Model(pd_model(dists, dev, torch.float32, "wishart"), loglik=pd_loglik, device=dev)
    pdm64 = tbt.Model(pd_model(dists, "cpu", torch.float64, "wishart"), loglik=pd_model64_ll,
                      device="cpu")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t2 = time.perf_counter()
    pres, plap = map_laplace(pdm, n_steps=MAP_STEPS)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    pd_launches = dict(kernels.LAUNCHES)
    print(f"launches on the map_laplace pd_conjugate leg: {pd_launches}", flush=True)
    for k in ("pd_inverse", "pd_logdensity", "pd_trace_grad"):
        expect(f"map_laplace pd_conjugate: {k} launched ({pd_launches[k]})", pd_launches[k] > 0)
    H = hessian(pdm.logdensity_fn(), pres.position).double().cpu()
    _, pd_kappa, H64 = laplace_reference(pdm64, pres.position)
    h_dev = float((H - H64).abs().max())
    h_bound = 4.0 * EPS32_ * PD_K * PD_K * float(H64.abs().max())
    line.update({
        "pd_seconds": t3 - t2, "pd_grad_norm": float(pres.grad_norm),
        "pd_lp": float(pres.logdensity), "pd_hessian_max_abs_dev": h_dev,
        "pd_hessian_bound": h_bound, "pd_hessian_max_abs": float(H64.abs().max()),
        "pd_hessian_kappa": pd_kappa,
        "pd_launches": {k: pd_launches[k] for k in
                        ("pd_inverse", "pd_logdensity", "pd_trace_grad")},
    })
    expect(f"map_laplace pd_conjugate: the Hessian at the card's MAP within {h_bound:.3e} of "
           f"the float64 Hessian (max |H| {float(H64.abs().max()):.1f}; max dev {h_dev:.3e})",
           h_dev <= h_bound)
    expect("map_laplace pd_conjugate: the Laplace factor finite",
           bool(torch.isfinite(plap.chol_precision).all()))
    # (d) the evidence estimators with the Laplace proposal
    gen = torch.Generator(device=dev).manual_seed(SEED)
    post = posterior[-(EVIDENCE_N // CHAINS):].reshape(-1, posterior.shape[-1])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t4 = time.perf_counter()
    isr = importance_sampling_evidence(model.logdensity_fn(), lap, gen, n=EVIDENCE_N)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    br = bridge_sampling_evidence(model.logdensity_fn(), post, lap, gen)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    ev_launches = dict(kernels.LAUNCHES)
    ref_ev, spread = LAPLACE_JAX["is_log_evidence"]
    line.update({
        "evidence_n": EVIDENCE_N, "is_seconds": t5 - t4, "bridge_seconds": t6 - t5,
        "is_log_evidence": float(isr.log_evidence), "is_ess": float(isr.ess),
        "is_pareto_k": float(isr.pareto_k), "bridge_log_evidence": float(br.log_evidence),
        "bridge_rel_mc_error": float(br.rel_mc_error),
        "is_log_evidence_jax": ref_ev, "is_spread_jax": spread,
        "is_dev_in_spreads": abs(float(isr.log_evidence) - ref_ev) / spread,
        "bridge_dev_in_spreads": abs(float(br.log_evidence) - ref_ev) / spread,
        "evidence_launches": {k: ev_launches[k] for k in (SIMPLEX_SMALL, "lkj_inverse")},
    })
    expect(f"evidence: 3 density calls at B = {EVIDENCE_N}, each one launch of #6 and #7 "
           f"({ev_launches['lkj_inverse']}, {ev_launches[SIMPLEX_SMALL]})",
           ev_launches["lkj_inverse"] == ev_launches[SIMPLEX_SMALL] == 3)
    expect(f"evidence: IS log Z {float(isr.log_evidence):.4f} within {EVIDENCE_SPREADS:g} "
           f"spreads of the JAX package's {ref_ev:.4f} ({line['is_dev_in_spreads']:.2f})",
           line["is_dev_in_spreads"] <= EVIDENCE_SPREADS)
    expect(f"evidence: bridge log Z {float(br.log_evidence):.4f} within {EVIDENCE_SPREADS:g} "
           f"spreads of the JAX package's IS {ref_ev:.4f} ({line['bridge_dev_in_spreads']:.2f})",
           line["bridge_dev_in_spreads"] <= EVIDENCE_SPREADS)
    for k in ("pd_inverse", "pd_logdensity", "pd_trace_grad"):
        launches[k] = pd_launches[k]
    for k in (SIMPLEX_SMALL, "lkj_inverse"):
        launches[k] += ev_launches[k]
    return line, launches


def pf_w_means(model, draws):
    return model.constrain(draws)["w"].double().cpu().reshape(-1, 16).mean(0).numpy()


def pf_w_dev(model, draws, ref):
    """Single-path: max_j |mean(w_j) - ref mean_j| / sd_j over the `w`
    block's 16 coordinates, in units of the JAX runs' pooled spread."""
    dev = np.abs(pf_w_means(model, draws) - np.asarray(ref["mean"])) / np.asarray(ref["sd"])
    return float(dev.max() / ref["spread_in_sd"])


def pool_ess(res):
    """Multi-path's pooled draws' effective size under the truncated
    importance weights it resamples with."""
    from tpu_bijectors_torch.infer import pathfinder as tpf

    p = torch.softmax(tpf._truncated_log_weights((res.logp - res.logq).reshape(-1).double()), 0)
    return float(1.0 / torch.sum(p * p))


def pf_multi_w_dev(model, draws, res, ref):
    """Multi-path: max_j |mean(w_j) - ref mean_j| in standard errors. A
    resampled mean's variance is sd_j^2 (1/ESS + 1/n) with the run's own
    importance ESS (from under 10 to about 90 between the JAX package's
    runs, so one spread over runs misstates every run's); the reference
    mean's is that over its runs' ESS, divided by their number."""
    n = draws.shape[0]
    sd2, ess = np.asarray(ref["sd"]) ** 2, np.asarray(ref["ess"])
    ref_var = np.mean(sd2[None, :] * (1.0 / ess[:, None] + 1.0 / n), axis=0) / ess.size
    se = np.sqrt(sd2 * (1.0 / pool_ess(res) + 1.0 / n) + ref_var)
    return float(np.max(np.abs(pf_w_means(model, draws) - np.asarray(ref["mean"])) / se))


def run_pathfinder(dev, loglik):
    """Path 24, pathfinder: (a) `fit_pathfinder(Model(bench,
    hier_loglik).logdensity_fn(), ...)` from zeros at its defaults (60
    L-BFGS steps at B = 1, the 60 x 30 candidates' ELBO draws in one
    density call at B = 1800, 100 draws); (b) `multipath_pathfinder` with
    8 paths from `init_positions(gen, 8, 0.3)` (every path's ELBO draws in
    one call at B = 14400, #7's wide design); gated within PF_SPREADS
    spreads on the best ELBO against the JAX package's float32 runs over
    eight seeds (PATHFINDER_JAX_F32) and on the `w` block's means against
    its float64 runs (PATHFINDER_JAX), multi-path's in standard errors
    from its importance ESS (`pf_multi_w_dev`); each distance from the
    other precision's runs is printed beside. Returns (the `pathfinder`
    line, the launches)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.infer import fit_pathfinder, hmc_batched, multipath_pathfinder

    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    fn = model.logdensity_fn()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    hmc_batched.reset_sync_count()
    t0 = time.perf_counter()
    res = fit_pathfinder(fn, gen, torch.zeros(model.dim(), device=dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, r1 = dict(kernels.LAUNCHES), hmc_batched.SYNCS["linesearch"]
    draws, res8 = multipath_pathfinder(fn, gen, model.init_positions(gen, 8, 0.3))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the pathfinder path: {launches}", flush=True)
    ref, ref32 = PATHFINDER_JAX, PATHFINDER_JAX_F32
    elbo1 = float(res.elbo[res.best])
    elbo8 = float(torch.max(torch.gather(res8.elbo, 1, res8.best[:, None])))
    line = {
        "engine": "pathfinder", "cell": "pathfinder",
        "single_seconds": t1 - t0, "multi_seconds": t2 - t1,
        "single_linesearch_reads": r1,
        "multi_linesearch_reads": hmc_batched.SYNCS["linesearch"] - r1,
        "single_best": int(res.best), "single_elbo": elbo1, "multi_elbo": elbo8,
        "single_elbo_dev_in_spreads": abs(elbo1 - ref32["single_elbo"][0]) / ref32["single_elbo"][1],
        "multi_elbo_dev_in_spreads": abs(elbo8 - ref32["multi_elbo"][0]) / ref32["multi_elbo"][1],
        "single_elbo_minus_f64": elbo1 - ref["single_elbo"][0],
        "multi_elbo_minus_f64": elbo8 - ref["multi_elbo"][0],
        "multi_ess": pool_ess(res8),
        "single_w_dev_in_spreads": pf_w_dev(model, res.draws, ref["single_w"]),
        "multi_w_dev_in_se": pf_multi_w_dev(model, draws, res8, ref["multi_w"]),
        "single_w_dev_in_f32_spreads": pf_w_dev(model, res.draws, ref32["single_w"]),
        "multi_w_dev_in_f32_se": pf_multi_w_dev(model, draws, res8, ref32["multi_w"]),
        "single_launches": {k: l1[k] for k in (SIMPLEX_SMALL, "simplex_inverse_logdet",
                                                "lkj_inverse")},
        "launches": {k: launches[k] for k in (SIMPLEX_SMALL, "simplex_inverse_logdet",
                                              "lkj_inverse")},
    }
    expect(f"pathfinder: draws (100, 151), (1000, 151) finite",
           tuple(res.draws.shape) == (100, 151) and tuple(draws.shape) == (1000, 151)
           and bool(torch.isfinite(res.draws).all()) and bool(torch.isfinite(draws).all()))
    expect(f"pathfinder: multipath's ELBO draws in one call at B = 14400 (#7's wide design: "
           f"{launches['simplex_inverse_logdet']} launch)",
           launches["simplex_inverse_logdet"] == 1)
    for k, of in (("single_elbo", "float32"), ("multi_elbo", "float32"), ("single_w", "float64")):
        d = line[f"{k}_dev_in_spreads"]
        expect(f"pathfinder: {k} within {PF_SPREADS:g} spreads of the JAX package's {of} "
               f"runs ({d:.2f})", d <= PF_SPREADS)
    d = line["multi_w_dev_in_se"]
    expect(f"pathfinder: multi-path's w means within {PF_SPREADS:g} standard errors of the JAX "
           f"package's float64 runs (ESS {line['multi_ess']:.1f}; {d:.2f})", d <= PF_SPREADS)
    return line, launches


def engine_variants(dev, vT):
    """The kernels paths 23 and 24 launch, at their batches and in the
    layout they read (the slice of the batch-major (B, 151) state), name ->
    (call, bytes, operations, plain call): #6 with W (the gradient's
    evaluations at B = 1 and the Hessian's at 151) and without (the ELBO
    and evidence calls at 1800 and 4096), #7 with wlog in the design its
    wrapper picks at B = 1, 151, 1800, 4096 and 14400 (multipath's), #10,
    #11 and #12 (dot) at the Wishart leg's B = 1 and 151; and #1 and #3 at
    the batches paths 21 and 22 launch them: eight schools at SMC_N, the
    mvdense prior of mv_conjugate at ADVI_MC (its loop entries' operations
    as `mv_variants`)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.kernels import simplex as ks
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    out = {}
    am1 = torch.zeros(16, device=dev)
    eye = torch.eye(PD_K, device=dev)
    for n in (1, 151, 1800, 4096, 14400):
        yw = layouts(vT, W_ROWS, n, "batch-major slice")["batch-major slice"]
        out[f"simplex_inverse_logdet with wlog, {ks.simplex_design(n)} design "
            f"(batch-major slice, B = {n})"] = (
            lambda y=yw: ks.simplex_inverse_logdet(y, am1), n * 4 * (15 + 16 + 2) + 64,
            n * 15 * OPS_SIMPLEX_COORD, lambda y=yw: ks.simplex_inverse_logdet_plain(y, am1))
        yc = layouts(vT, C_ROWS, n, "batch-major slice")["batch-major slice"]
        w = n in (1, 151)
        out[f"lkj_inverse{' with W' if w else ''} (batch-major slice, B = {n})"] = (
            lambda y=yc, w=w: kl.lkj_inverse(y, 16, want_w=w),
            n * 4 * (120 + 256 + 1 + 16 + (256 if w else 0)), n * (120 * OPS_LKJ_SLOT + 2 * 816),
            lambda y=yc, w=w: kl.lkj_inverse_plain(y, 16, want_w=w))
        if n > 151:
            continue
        yp = layouts(vT, PD_ROWS, n, "batch-major slice")["batch-major slice"]
        out[f"pd_inverse (batch-major slice, B = {n})"] = (
            lambda y=yp: kp.pd_inverse(y, PD_K), n * 4 * (136 + 256 + 1 + 256),
            n * PD_OPS["inverse"], lambda y=yp: kp.pd_inverse_plain(y, PD_K))
        out[f"pd_logdensity dot (batch-major slice, B = {n})"] = (
            lambda y=yp: kp.pd_logdensity(y, PD_K, eye, "dot"),
            n * 4 * (136 + 3) + eye.numel() * 4, n * PD_OPS["dot"],
            lambda y=yp: kp.pd_logdensity_plain(y, PD_K, eye, "dot"))
        out[f"pd_trace_grad dot (batch-major slice, B = {n})"] = (
            lambda y=yp: kp.pd_trace_grad(y, PD_K, eye, "dot"),
            n * 4 * (136 + 136) + eye.numel() * 4, n * PD_OPS["dot_grad"],
            lambda y=yp: kp.pd_trace_grad_plain(y, PD_K, eye, "dot"))
    rng = np.random.default_rng(SEED)
    es_u = tbt.Model(eight_schools_model(dists, dev, torch.float32), device=dev).unconstrainer()
    es_vT = torch.as_tensor(0.5 * rng.standard_normal((10, SMC_N)), dtype=torch.float32,
                            device=dev)
    none = dict.fromkeys(OPS, 0)
    es = model_variants(f"(eight schools, B = {SMC_N})", es_vT, torch.zeros_like(es_vT),
                        *fk._prep(es_u, es_vT)[:2], none)
    mv_u = tbt.Model(mvdense_model(dists, dev, torch.float32)[0], device=dev).unconstrainer()
    mv_vT = vT[:, :ADVI_MC].contiguous()
    cf, loops = fk._prep(mv_u, mv_vT)[:2]
    n_ent = len(loops.entries)
    form, val, grad = (ADVI_MC * n_ent * QUAD_OPS[k] for k in ("form", "value", "grad"))
    mv = model_variants(f"with the Gaussian and t entries (mvdense, B = {ADVI_MC})", mv_vT,
                        torch.zeros_like(mv_vT), cf, loops,
                        {"value": form + val, "value_and_grad": form + val + grad,
                         "vjp": form + grad, "jvp": form + grad})
    out.update({k: v for k, v in {**es, **mv}.items()
                if k.startswith(("slab_value ", "slab_vjp "))})
    return out


# --- path 25: forward mode, parameter tangents, the flat-vector API, the ---
# families' samplers and the property sweep

# the link kernels path 25 launches (its (c) part must launch none of #1-#4)
PATH25_LINK_KERNELS = ("simplex_inverse_logdet", SIMPLEX_SMALL, "simplex_inverse",
                       "simplex_forward_logdet", "lkj_inverse", "lkj_logdet", "pd_inverse",
                       "pd_logdensity", "pd_trace_grad")
# a parameter gradient is a sum over the batch of per-column terms, each
# held to RTOL_G: over B = 64 columns with cancellation between them, ten
# times that against the sum's own magnitude
RTOL_PARAM_G = 1e-4
PATH25_LIMIT_S = 30.0
PATH25_CPU_COLS = 1024  # the columns held to the float64 plain version on the CPU
WISHART3_S = ((2.0, 0.3, 0.1), (0.3, 1.5, 0.2), (0.1, 0.2, 1.0))


def wishart3_model(dists, device, dtype):
    """The Wishart families at K = 3 (the sweep's Wishart(6, S)) beside
    three N(0, 1): linked dim 6 + 6 + 3."""
    kw = dict(device=device, dtype=dtype)
    S = np.asarray(WISHART3_S)
    return dists.NamedProduct.of(W=dists.Wishart(6.0, S, **kw),
                                 V=dists.InverseWishart(6.0, S, **kw),
                                 m=dists.IIDProduct(dists.Normal(0.0, 1.0, **kw), 3))


def within_mcse(name, draws, exact):
    """Each column's mean of `draws` (n, k) within 5 Monte Carlo standard
    errors of `exact`; returns the worst ratio to that bound."""
    d = draws.double()
    se = d.std(0) / math.sqrt(d.shape[0])
    ratio = float(((d.mean(0) - exact).abs() / (5 * se)).max())
    print(f"{name}: worst |mean - exact| / 5 MCSE {ratio:.3f}", flush=True)
    expect(f"{name} within 5 MCSE", ratio <= 1.0)
    return ratio


def tangent_checks(tag, u, u64, v, dv):
    """The forward-mode tangents of from_linked_vec's log-det and of
    linked_logdensity on (B, dim) states v along dv, against reverse
    mode's gradient dotted with dv (RTOL_G against sum |g dv|) and, on the
    first PATH25_CPU_COLS states, against the float64 plain versions on
    the CPU. Returns the worst ratios."""
    import torch.autograd.forward_ad as fwAD

    worst = {}
    for what, f, f64 in (("log-det", lambda a: u.from_linked_vec(a)[1],
                          lambda a: u64.from_linked_vec(a)[1]),
                         ("linked_logdensity", u.linked_logdensity, u64.linked_logdensity)):
        with fwAD.dual_level():
            t = fwAD.unpack_dual(f(fwAD.make_dual(v, dv))).tangent
        vv = v.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(f(vv).sum(), vv)
        scale = (g * dv).abs().sum(-1)
        check(f"{tag}: forward-mode tangent of {what} vs reverse mode", t, (g * dv).sum(-1),
              RTOL_G, scale + 1e-3 * scale.max())
        worst[what] = float(((t - (g * dv).sum(-1)).abs() / (scale + 1e-3 * scale.max())).max())
        rows = slice(0, PATH25_CPU_COLS)
        v64, dv64 = v[rows].double().cpu(), dv[rows].double().cpu()
        with fwAD.dual_level():
            t64 = fwAD.unpack_dual(f64(fwAD.make_dual(v64, dv64))).tangent
        vv = v64.clone().requires_grad_(True)
        (g64,) = torch.autograd.grad(f64(vv).sum(), vv)
        s64 = (g64 * dv64).abs().sum(-1)
        check(f"{tag}: forward-mode tangent of {what} vs float64 plain (CPU)", t[rows].cpu(), t64,
              RTOL_G, s64 + 1e-3 * s64.max())
    return worst


def run_flat_api_and_tangents(dev):
    """Path 25 (float32): (a) the bench model's `sample` at B = 131072, the
    flat-vector API on the draws (to_vec / from_vec bit for bit, the round
    trip v -> x -> v, UnconstrainerBijector bit for bit) and the draws'
    moments; (b) forward mode through from_linked_vec's log-det and
    linked_logdensity (the link Functions' jvps) on the bench model and on
    the Wishart(3) model; (c) the transposed density's gradient in the
    Dirichlet's alpha and the LKJ's eta at B = 64 (the composed path: link
    kernels, none of #1-#4); (d) the port's `test_all` on the bench
    model's four leaves and on Wishart(3), in float32 on the card; (e) #7
    at K = 256 and 1024 against both plain versions. Returns (line,
    launches, err)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch import vectorize as tv
    from tpu_bijectors_torch.kernels import simplex as ks
    from tpu_bijectors_torch.testing import test_all

    t0 = time.perf_counter()
    f32 = torch.float32
    d = bench_model(dists, dev, f32)
    u = tbt.unconstrain(d, device=dev)
    u64 = tbt.unconstrain(bench_model(dists, "cpu", torch.float64), device="cpu")
    kernels.reset_launch_counts()
    line, err = {}, {}

    # (a) draws and the flat-vector API
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    x = d.sample(gen, (BATCH,))
    expect("path 25: the draws' shapes",
           {k: tuple(t.shape) for k, t in x.items()} == {
               "mu": (BATCH, 8), "sigma": (BATCH, 8), "w": (BATCH, 16), "corr": (BATCH, 16, 16)}
           and all(t.device.type == "cuda" for t in x.values()))
    v = u.to_vec(x)
    expect("path 25: vec length 8 + 8 + 16 + 256", v.shape == (BATCH, u.vec_length) and
           u.vec_length == 288)
    expect("path 25: from_vec(to_vec(x)) is x bit for bit",
           all(torch.equal(a, x[k]) for k, a in u.from_vec(v).items()))
    line["mcse_ratio"] = max(
        within_mcse("path 25: Normal(0, 2) means", x["mu"], 0.0),
        within_mcse("path 25: LogNormal(0, 0.5) means", x["sigma"], math.exp(0.125)),
        within_mcse("path 25: Dirichlet(1_16) means", x["w"], 1.0 / 16),
        within_mcse("path 25: LKJ(16, 2) off-diagonal variance 1/19",
                    x["corr"][:, *torch.triu_indices(16, 16, 1, device=dev)] ** 2, 1.0 / 19))
    lv, ld = u.to_linked_vec(x)
    b = tv.UnconstrainerBijector(u)
    yb, ldb = b.forward_and_log_det(x)
    expect("path 25: UnconstrainerBijector forward is to_linked_vec bit for bit",
           torch.equal(yb, lv) and torch.equal(ldb, ld))
    rng = np.random.default_rng(SEED + 25)
    vs = torch.as_tensor(0.5 * rng.standard_normal((BATCH, 151)), dtype=f32, device=dev)
    xs, lds = u.from_linked_vec(vs)
    xb, ldsb = b.inverse_and_log_det(vs)
    expect("path 25: UnconstrainerBijector inverse is from_linked_vec bit for bit",
           all(torch.equal(xb[k], xs[k]) for k in xs) and torch.equal(ldsb, lds))
    vs2, lds2 = u.to_linked_vec(xs)
    check("path 25: round trip v -> x -> v, scalar and simplex rows", vs2[:, :31], vs[:, :31],
          ATOL_ROUNDTRIP, torch.ones_like(vs[:, :31]))
    # the LKJ rows as path 3 holds them (kappa(X) eps32 + ATOL_ROUNDTRIP), on
    # the first 4096 states
    ev = torch.linalg.eigvalsh(xs["corr"][:4096].double().cpu())
    row_err = (vs2[:4096, C_ROWS] - vs[:4096, C_ROWS]).abs().amax(dim=1).double().cpu()
    ratio = float((row_err / (ev[:, -1] / ev[:, 0] * np.finfo(np.float32).eps
                              + ATOL_ROUNDTRIP)).max())
    print(f"path 25: round trip, LKJ rows: max error / (kappa eps32 + {ATOL_ROUNDTRIP:g}) "
          f"{ratio:.3e}", flush=True)
    expect("path 25: round trip v -> x -> v, LKJ rows within kappa(X) eps32", ratio <= 1.0)
    check("path 25: round trip log-dets", lds2, -lds, RTOL_ROUNDTRIP_LD,
          lds.abs() + 1e-3 * lds.abs().max())
    line["roundtrip_lkj_ratio"] = ratio
    del x, v, lv, ld, yb, ldb, xs, xb, vs2, ev

    # (b) forward mode on the bench model and on the Wishart(3) model
    dv = torch.as_tensor(np.random.default_rng(SEED + 26).standard_normal((BATCH, 151)),
                         dtype=f32, device=dev)
    line["tangent_ratio_bench"] = tangent_checks("path 25 bench", u, u64, vs, dv)
    uw = tbt.unconstrain(wishart3_model(dists, dev, f32), device=dev)
    uw64 = tbt.unconstrain(wishart3_model(dists, "cpu", torch.float64), device="cpu")
    vw = 0.5 * vs[:, :15].contiguous()
    line["tangent_ratio_wishart3"] = tangent_checks("path 25 Wishart(3)", uw, uw64, vw, dv[:, :15])
    del dv, vw

    # (c) parameter gradients of the transposed density at B = 64
    before = dict(kernels.LAUNCHES)
    grads = []
    for device, dtype in ((dev, f32), ("cpu", torch.float64)):
        alpha = torch.linspace(0.8, 2.3, 16, dtype=dtype, device=device).requires_grad_(True)
        eta = torch.tensor(2.0, dtype=dtype, device=device, requires_grad=True)
        kw = dict(device=device, dtype=dtype)
        dp = dists.NamedProduct.of(mu=dists.IIDProduct(dists.Normal(0.0, 2.0, **kw), 8),
                                   sigma=dists.IIDProduct(dists.LogNormal(0.0, 0.5, **kw), 8),
                                   w=dists.Dirichlet(alpha, **kw), corr=dists.LKJ(16, eta, **kw))
        up = tbt.unconstrain(dp, device=device)
        lp = up.linked_logdensity_t(vs[:CHAINS].T.to(device=device, dtype=dtype))
        grads.append(torch.autograd.grad(lp.sum(), (alpha, eta)))
    added = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    print(f"path 25 (c): launches {added}", flush=True)
    expect("path 25 (c): the parameter gradient launches the link kernels",
           added[SIMPLEX_SMALL] > 0 and added["lkj_logdet"] > 0)
    expect("path 25 (c): and none of #1-#4",
           all(added[k] == 0 for k in SLAB_KERNELS + (SMALL, "slab_jvp")))
    for name, g, g64 in zip(("alpha", "eta"), grads[0], grads[1]):
        err[f"param_{name}"] = check(f"path 25 (c): d lp / d {name} vs float64", g.cpu(), g64,
                                     RTOL_PARAM_G)

    # (d) the property sweep in float32 on the card. LKJ(16)'s round trips
    # pass through a float32 Cholesky whose error grows with kappa(X) (path
    # 3's bound): its random states are the paths' 0.5 N(0, 1) and its
    # round-trip tolerance 100 atol = 1e-3
    kw = dict(device=dev, dtype=f32)
    sweeps = {"Normal(0, 2)": (dists.Normal(0.0, 2.0, **kw), {}),
              "LogNormal(0, 0.5)": (dists.LogNormal(0.0, 0.5, **kw), {}),
              "Dirichlet(1_16)": (dists.Dirichlet(np.ones(16), **kw), {}),
              "LKJ(16, 2)": (dists.LKJ(16, 2.0, **kw), dict(inverse_scale=0.5, atol=1e-5)),
              "Wishart(6, S3)": (dists.Wishart(6.0, np.asarray(WISHART3_S), **kw), {}),
              "InverseWishart(6, S3)": (dists.InverseWishart(6.0, np.asarray(WISHART3_S), **kw), {})}
    for name, (dist, args) in sweeps.items():
        try:
            test_all(dist, **args)
            expect(f"path 25 (d): test_all({name}) in float32 on the card", True)
        except AssertionError as e:
            expect(f"path 25 (d): test_all({name}) in float32 on the card: {str(e)[:400]}", False)
    from tpu_bijectors_torch.testing.sweep import _KAPPA_CACHE
    line["sweep_kappa"] = _KAPPA_CACHE.get(("cuda", str(f32)))

    # (e) #7 at large K against both plain versions
    for K in (256, 1024):
        y = 0.5 * torch.randn((4096, K - 1), generator=gen, device=dev)
        am1 = torch.as_tensor(np.random.default_rng(K).uniform(0.0, 3.0, K), dtype=f32, device=dev)
        xk, ldk, wk = ks.simplex_inverse_logdet(y, am1)
        for method in ks.METHODS:
            xp, ldp, wp = ks.simplex_inverse_logdet_plain(y, am1, method=method)
            tag = f"path 25 (e): #7 at K = {K} (B = 4096) vs the {method} plain version"
            e = max(check(f"{tag}: x", xk, xp, ATOL_UNIT, torch.ones_like(xp)),
                    check(f"{tag}: ld", ldk, ldp, RTOL_SUM, ldp.abs() + 1e-3 * ldp.abs().max()),
                    check(f"{tag}: wlog", wk, wp, RTOL_SUM, wp.abs() + 1e-3 * wp.abs().max()))
            err[f"simplex_K{K}_{method}"] = e
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in PATH25_LINK_KERNELS}
    dt = time.perf_counter() - t0
    line.update({"seconds": dt, "launches": launches})
    print(f"path 25: {dt:.1f} s, launches {launches}", flush=True)
    expect(f"path 25 within {PATH25_LIMIT_S:g} s", dt < PATH25_LIMIT_S)
    return line, launches, err


# path 26: the remaining bijectors, CDF/Quantile with implicit derivatives
PATH26_LIMIT_S = 15.0
PATH26_JAC_B = 64  # the states whose log-dets are held to the Jacobian's
PATH26_CPU_COLS = 4096  # the states held to the float64 quantile on the CPU
PATH26_BETA_COLS = 1024  # the same for Beta(2, 5), whose betainc iterates on the host
PATH26_CORR_JAC = 2  # CorrBijector's states held to the Jacobian (120 backward passes each)
# a float32 Jacobian's log|det| against the analytic log-det: relative to
# |log-det| + 1 (a volume-preserving map's log-det is 0)
RTOL_JAC = 1e-4
# the Stacked's x and log-det against UnconstrainerBijector's on the same
# state, as path 25 holds that bijector's round trip
RTOL_STACKED_LD = RTOL_ROUNDTRIP_LD
# the quantile's gates: the float32 x is held to the float64 quantile within
# the float32 cdf's measured error over the pdf, plus 8 ulp of x (the
# solve's bracket); d x / dq to 1 / pdf within |d log pdf / dx| times that
# bound plus 8 eps32 (the inverse pdf's own rounding)
ULPS_QUANTILE = 8
P26_KERNELS = ("simplex_inverse_logdet", SIMPLEX_SMALL, "simplex_inverse",
               "simplex_forward_logdet", "lkj_inverse", "lkj_logdet", "pd_inverse")
QUANTILE_GAMMA = (2.0, 3.0)  # concentration, rate: mean 2/3, sd sqrt(2)/3
QUANTILE_NUTS = dict(n_chains=CHAINS, n_warmup=200, n_samples=300)


def launch_delta(fn):
    """(fn's result, the kernels it launched)."""
    from tpu_bijectors_torch import kernels

    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]}


def jac_check(name, f, x, ld):
    """Each row's log-det against log|det| of torch.func.jacrev of f on
    that row (vmapped), relative to |log-det| + 1."""
    J = torch.func.vmap(torch.func.jacrev(f))(x)
    return check(name, ld, torch.linalg.slogdet(J.double())[1], RTOL_JAC,
                 ld.double().abs() + 1.0)


def elementwise_jac_check(name, f, x, ld):
    """An elementwise map's log-dets against log|dy/dx| of the diagonal of
    torch.func.jacrev on each row."""
    J = torch.func.vmap(torch.func.jacrev(f))(x)
    diag = torch.diagonal(J, dim1=-2, dim2=-1).double()
    return check(name, ld, torch.log(diag.abs()), RTOL_JAC, ld.double().abs() + 1.0)


def stacked_vs_unconstrainer(tag, u, st, vs, row_blocks):
    """Path 26 (a) and (b): the Stacked's forward on the linked state vs
    UnconstrainerBijector(u)'s inverse (x in the to_vec layout and the
    log-det), the same kernels as its members called alone and none of
    #1-#4, no copy of the state beyond its concatenated output, the
    forward (x alone) and the inverse direction back to the state, each
    against the members alone. Returns (launches, errors, peak bytes)."""
    from tpu_bijectors_torch import vectorize as tv

    ub = tv.UnconstrainerBijector(u)
    err = {}
    members = [(b, vs[:, s:s + n]) for b, (s, n) in zip(st.bijectors, st.ranges_in)]

    def alone(method):
        return [getattr(b, method)(v) for b, v in members]

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs, l_alone = launch_delta(lambda: alone("forward_and_log_det"))
    peak_alone = torch.cuda.max_memory_allocated() - base
    del outs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (x, ld), l_st = launch_delta(lambda: st.forward_and_log_det(vs))
    peak_st = torch.cuda.max_memory_allocated() - base
    out_bytes = x.numel() * x.element_size() + 4 * ld.numel() * ld.element_size()
    print(f"{tag}: launches alone {l_alone}, through the Stacked {l_st}; peak bytes "
          f"alone {peak_alone}, Stacked {peak_st} (its output and log-det sums "
          f"{out_bytes})", flush=True)
    expect(f"{tag}: the Stacked launches the kernels its members launch alone",
           l_st == l_alone and len(l_st) > 0)
    expect(f"{tag}: and none of #1-#4",
           not any(k in l_st for k in SLAB_KERNELS + (SMALL, "slab_jvp", "slab_traced")))
    expect(f"{tag}: no copy of the state beyond the members' and the output",
           peak_st <= peak_alone + out_bytes + (2 << 20))
    xs, lds = ub.inverse_and_log_det(vs)
    ref = u.to_vec(xs)
    err["x"] = check(f"{tag}: x vs UnconstrainerBijector", x, ref, ATOL_ROUNDTRIP,
                     torch.ones_like(ref))
    err["ld"] = check(f"{tag}: log-det vs UnconstrainerBijector", ld, lds, RTOL_STACKED_LD,
                      lds.abs() + 1e-3 * lds.abs().max())
    xf, l_fwd = launch_delta(lambda: st.forward(vs))
    _, l_fwd_alone = launch_delta(lambda: alone("forward"))
    expect(f"{tag}: forward (x alone) launches {l_fwd} as its members alone",
           l_fwd == l_fwd_alone)
    expect(f"{tag}: forward (x alone) is forward_and_log_det's x", torch.equal(xf, x))
    xm = [x[:, s:s + n] for s, n in st.ranges_out]
    (v2, ld2), l_inv = launch_delta(lambda: st.inverse_and_log_det(x))
    _, l_inv_alone = launch_delta(lambda: [b.inverse_and_log_det(v) for b, v
                                            in zip(st.bijectors, xm)])
    expect(f"{tag}: the inverse launches {l_inv} as its members alone", l_inv == l_inv_alone)
    for name, (rows, corr_of) in row_blocks.items():
        if corr_of is None:
            err[f"roundtrip_{name}"] = check(f"{tag}: round trip v -> x -> v, {name} rows",
                                             v2[:, rows], vs[:, rows], ATOL_ROUNDTRIP,
                                             torch.ones_like(vs[:, rows]))
            continue
        # a correlation block as path 3 holds it (kappa(X) eps32 +
        # ATOL_ROUNDTRIP), on the first 4096 states
        ev = torch.linalg.eigvalsh(corr_of(x[:4096]).double().cpu())
        row_err = (v2[:4096, rows] - vs[:4096, rows]).abs().amax(dim=1).double().cpu()
        ratio = float((row_err / (ev[:, -1] / ev[:, 0] * np.finfo(np.float32).eps
                                  + ATOL_ROUNDTRIP)).max())
        print(f"{tag}: round trip, {name} rows: max error / (kappa eps32 + "
              f"{ATOL_ROUNDTRIP:g}) {ratio:.3e}", flush=True)
        expect(f"{tag}: round trip v -> x -> v, {name} rows within kappa(X) eps32", ratio <= 1.0)
        err[f"roundtrip_{name}_ratio"] = ratio
    err["roundtrip_ld"] = check(f"{tag}: round trip log-dets", ld2, -ld, RTOL_ROUNDTRIP_LD,
                                ld.abs() + 1e-3 * ld.abs().max())
    launches = {k: l_st.get(k, 0) + l_fwd.get(k, 0) + l_inv.get(k, 0) for k in P26_KERNELS}
    return launches, err, (peak_alone, peak_st), (x, v2)


def quantile_gates(tag, d32, d64, q, x, g, cols):
    """The float32 quantile x (and d x / dq, g) on the card against the
    float64 quantile on the CPU of the first `cols` of q: the x bound is
    the float32 cdf's error there (measured) over the pdf plus
    ULPS_QUANTILE ulp of x; g's is |d log pdf / dx| times that, plus
    ULPS_QUANTILE eps32, relative to 1 / pdf. Returns the errors and the
    worst ratios to the bounds."""
    eps32 = float(np.finfo(np.float32).eps)
    q64 = q[:cols].double().cpu()
    x64 = d64.quantile(q64)
    xx = x64.clone().requires_grad_(True)
    lp = d64.logpdf(xx)
    (score,) = torch.autograd.grad(lp.sum(), xx)
    pdf = torch.exp(lp.detach())
    cdf_err = float((d32.cdf(x64.float().to(q.device)).double().cpu() - d64.cdf(x64.float().double())).abs().max())
    bound_x = 2.0 * cdf_err / pdf + ULPS_QUANTILE * eps32 * x64.abs()
    dx = (x[:cols].double().cpu() - x64).abs()
    ratio_x = float((dx / bound_x).max())
    g64 = 1.0 / pdf
    bound_g = score.abs() * bound_x + ULPS_QUANTILE * eps32
    ratio_g = float((((g[:cols].double().cpu() - g64) / g64).abs() / bound_g).max())
    print(f"{tag}: float32 cdf error {cdf_err:.3e}; x vs float64 max error "
          f"{float(dx.max()):.3e}, worst ratio to its bound {ratio_x:.3e}; d x / dq vs 1 / pdf "
          f"worst ratio {ratio_g:.3e}", flush=True)
    expect(f"{tag}: x within the float32 cdf error over the pdf + {ULPS_QUANTILE} ulp", ratio_x <= 1.0)
    expect(f"{tag}: d x / dq within |score| x bound + {ULPS_QUANTILE} eps32 of 1 / pdf", ratio_g <= 1.0)
    return {"cdf_err": cdf_err, "x_max_abs_err": float(dx.max()), "x_ratio": ratio_x,
            "g_ratio": ratio_g}


def run_bijectors_and_quantiles(dev, time_gate=True):
    """Path 26 (float32): (a) Stacked over the bench model's links at
    B = 131072 against UnconstrainerBijector (#7 and #6; the inverse
    direction's #9), (b) the same on the Wishart(3) model's PD links (#10),
    (c) the structural and scalar bijectors on the card (round trips at
    B = 131072, log-dets against torch.func.jacrev at B = 64; CorrBijector
    at K = 16 through #6), (d) QuantileBijector(Gamma(2, 3)) and
    CDFBijector(Beta(2, 5)) at B = 131072 (the generic quantile under
    set_sync_debug_mode('error') for Gamma), (e) NUTS on the
    quantile-linked prior with kernel='auto'. `time_gate=False` leaves
    out the PATH26_LIMIT_S gate, which holds the warm time (a first run
    in a process also pays the card's first uses). Returns (line,
    launches, err)."""
    import copy

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists
    from tpu_bijectors_torch.utils import triu_to_vec

    t0 = time.perf_counter()
    f32 = torch.float32
    kw = dict(device=dev, dtype=f32)
    line, err, launches = {"part_s": {}}, {}, {k: 0 for k in P26_KERNELS}
    rng = np.random.default_rng(SEED + 260)

    # (a) Stacked over the bench model's links
    u = tbt.unconstrain(bench_model(dists, dev, f32), device=dev)
    st = tbt.Stacked.from_lengths(
        (tbt.Identity(), tbt.Exp(), tbt.inverse(tbt.SimplexBijector()),
         tbt.Chain((tbt.Reshape((16, 16), (256,)), tbt.inverse(tbt.VecCorrBijector())))),
        (8, 8, 15, 120))
    expect("path 26 (a): the Stacked maps 151 linked slots to the 288 of to_vec",
           (st.length_in, st.length_out) == (151, u.vec_length) == (151, 288))
    vs = torch.as_tensor(0.5 * rng.standard_normal((BATCH, 151)), **kw)
    la, err["stacked_bench"], line["stacked_peak_bytes"], (xa, va) = stacked_vs_unconstrainer(
        "path 26 (a) bench", u, st, vs,
        {"scalar and simplex": (slice(0, 31), None),
         "LKJ": (C_ROWS, lambda x: x[:, 32:].reshape(-1, 16, 16))})
    for k, n in la.items():
        launches[k] += n
    expect("path 26 (a): #7 and #6 launched, #9 in the inverse direction",
           la["simplex_inverse_logdet"] > 0 and la["lkj_inverse"] > 0
           and la["simplex_forward_logdet"] > 0)
    del xa, va

    torch.cuda.synchronize()
    line["part_s"]["a"] = time.perf_counter() - t0 - sum(line["part_s"].values())
    # (b) the PD form on the Wishart(3) model
    uw = tbt.unconstrain(wishart3_model(dists, dev, f32), device=dev)
    pd_link = tbt.Chain((tbt.Reshape((3, 3), (9,)), tbt.inverse(tbt.PDVecBijector())))
    stw = tbt.Stacked.from_lengths((pd_link, pd_link, tbt.Identity()), (6, 6, 3))
    vw = 0.5 * vs[:, :15].contiguous()
    lb, err["stacked_wishart3"], _, _ = stacked_vs_unconstrainer(
        "path 26 (b) Wishart(3)", uw, stw, vw, {"all": (slice(0, 15), None)})
    for k, n in lb.items():
        launches[k] += n
    expect("path 26 (b): #10 launched", lb["pd_inverse"] > 0)

    torch.cuda.synchronize()
    line["part_s"]["b"] = time.perf_counter() - t0 - sum(line["part_s"].values())
    # (c) the structural and scalar bijectors
    jb = slice(0, PATH26_JAC_B)
    x8 = torch.as_tensor(rng.standard_normal((BATCH, 8)), **kw)
    w4 = torch.as_tensor(0.3 * rng.standard_normal((4, 4)), **kw)
    c4 = torch.as_tensor(rng.standard_normal((4, 4)), **kw)
    A = torch.as_tensor(rng.standard_normal((8, 8)) + 3.0 * np.eye(8), **kw)
    shift8 = torch.as_tensor(rng.standard_normal(8), **kw)
    scale8 = torch.as_tensor(rng.uniform(0.5, 2.0, 8) * np.sign(rng.standard_normal(8)), **kw)

    def theta(p, x2):
        w, c = p
        return tbt.Block(tbt.Chain((tbt.Shift(x2 @ c), tbt.Scale(torch.exp(x2 @ w)))), 1)

    vector_maps = {
        "Coupling": tbt.Coupling(theta, tbt.PartitionMask(8, (0, 2, 4, 6), (1, 3, 5, 7)), (w4, c4)),
        "Permute": tbt.Permute(tuple(int(i) for i in rng.permutation(8))),
        "LinearMap": tbt.LinearMap(A),
        "TriangularLinearMap": tbt.TriangularLinearMap(A, lower=True),
        "ProductBijector": tbt.ProductBijector((tbt.Exp(), tbt.Identity(), tbt.Softplus(),
                                                tbt.Shift(1.5), tbt.Scale(-2.0), tbt.LeakyReLU(0.3),
                                                tbt.Log(), tbt.Logit(-4.0, 4.0))),
    }
    scalar_maps = {"Exp": tbt.Exp(), "Log": tbt.Log(), "Logit(-4, 4)": tbt.Logit(-4.0, 4.0),
                   "Shift": tbt.Shift(shift8), "Scale": tbt.Scale(scale8),
                   "LeakyReLU(0.3)": tbt.LeakyReLU(0.3), "Softplus": tbt.Softplus()}
    # an input inside each map's domain: (0, inf) for Log, (-4, 4) for Logit
    x8pos = torch.exp(x8)
    x8int = 4.0 * torch.tanh(x8)
    xprod = torch.cat([x8[:, :6], x8pos[:, 6:7], x8int[:, 7:]], dim=1)
    domain = {"Log": x8pos, "Logit(-4, 4)": x8int, "ProductBijector": xprod}
    worst = {}
    for name, b in {**vector_maps, **scalar_maps}.items():
        xin = domain.get(name, x8)
        (y, ld), lc = launch_delta(lambda: b.forward_and_log_det(xin))
        expect(f"path 26 (c) {name}: no kernel (plain torch, as the JAX package's jnp)", not lc)
        xr, ldi = b.inverse_and_log_det(y)
        worst[name] = check(f"path 26 (c) {name}: round trip at B = {BATCH}", xr, xin,
                            ATOL_ROUNDTRIP, xin.abs() + 1.0)
        check(f"path 26 (c) {name}: inverse log-det is minus the forward's", ldi, -ld,
              RTOL_JAC, ld.abs() + 1.0)
        jac = elementwise_jac_check if name in scalar_maps else jac_check
        worst[f"{name}_logdet"] = jac(f"path 26 (c) {name}: log-det vs jacrev at B = {PATH26_JAC_B}",
                                      b.forward, xin[jb], ld[jb])
    # CorrBijector at K = 16: the inverse through #6
    K = 16
    Y = torch.triu(torch.as_tensor(0.5 * rng.standard_normal((BATCH, K, K)), **kw), 1)
    cb = tbt.CorrBijector()
    (X, logJ), lc = launch_delta(lambda: cb.inverse_and_log_det(Y))
    launches["lkj_inverse"] += lc.get("lkj_inverse", 0)
    expect(f"path 26 (c) CorrBijector: the inverse launches #6 ({lc})", lc.get("lkj_inverse", 0) == 1)
    ref = tbt.VecCorrBijector().inverse_and_log_det(triu_to_vec(Y, 1))
    expect("path 26 (c) CorrBijector: the inverse is VecCorrBijector's on the packed triangle",
           torch.equal(X, ref[0]) and torch.equal(logJ, ref[1]))
    Y2, ld2 = cb.forward_and_log_det(X)
    ev = torch.linalg.eigvalsh(X[:4096].double().cpu())
    row_err = (Y2[:4096] - Y[:4096]).abs().amax(dim=(1, 2)).double().cpu()
    ratio = float((row_err / (ev[:, -1] / ev[:, 0] * np.finfo(np.float32).eps
                              + ATOL_ROUNDTRIP)).max())
    print(f"path 26 (c) CorrBijector: round trip max error / (kappa eps32 + "
          f"{ATOL_ROUNDTRIP:g}) {ratio:.3e}", flush=True)
    expect("path 26 (c) CorrBijector: round trip within kappa(X) eps32", ratio <= 1.0)
    # the forward's log-det at X is the closed form at the round trip's Y2:
    # it moves from -logJ(Y) by sum (K - i) |tanh Y| |Y2 - Y| to first order
    coeff = (K - torch.arange(K, device=dev, dtype=f32))[:, None]
    moved = (coeff * torch.tanh(Y).abs() * (Y2 - Y).abs()).sum((-2, -1))
    check("path 26 (c) CorrBijector: forward log-det is minus the inverse's, within the "
          "round trip's first-order move", ld2, -logJ, 1.0,
          2.0 * moved.double() + RTOL_ROUNDTRIP_LD * (logJ.abs() + 1e-3 * logJ.abs().max()).double())
    tri = torch.triu_indices(K, K, 1, device=dev)

    def corr_free(v):
        Yv = torch.zeros((K, K), dtype=v.dtype, device=v.device).index_put((tri[0], tri[1]), v)
        return cb.inverse(Yv[None])[0][tri[0], tri[1]]

    Jc = torch.stack([torch.autograd.functional.jacobian(corr_free, Y[i][tri[0], tri[1]])
                      for i in range(PATH26_CORR_JAC)])
    worst["CorrBijector_logdet"] = check(
        f"path 26 (c) CorrBijector: log-det vs the Jacobian on {PATH26_CORR_JAC} states",
        logJ[:PATH26_CORR_JAC], torch.linalg.slogdet(Jc.double())[1], RTOL_JAC,
        logJ[:PATH26_CORR_JAC].double().abs() + 1.0)
    # equality on the card: a deep copy compares and hashes equal
    for name, b in vector_maps.items():
        if name != "Coupling":
            c = copy.deepcopy(b)
            expect(f"path 26 (c) {name}: a deep copy on the card is equal and hashes equal",
                   c == b and hash(c) == hash(b))
    err["structural"] = worst
    del X, Y, Y2, ev

    torch.cuda.synchronize()
    line["part_s"]["c"] = time.perf_counter() - t0 - sum(line["part_s"].values())
    # (d) QuantileBijector(Gamma(2, 3)) and CDFBijector(Beta(2, 5))
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    q = 0.001 + 0.998 * torch.rand(BATCH, generator=gen, device=dev, dtype=f32)
    gam, gam64 = (dists.Gamma(*QUANTILE_GAMMA, **kw),
                  dists.Gamma(*QUANTILE_GAMMA, device="cpu", dtype=torch.float64))
    qb = tbt.QuantileBijector(gam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts = time.perf_counter()
        xq = gam.quantile(q)
        torch.cuda.synchronize()
        line["gamma_quantile_ms"] = 1e3 * (time.perf_counter() - ts)
        expect("path 26 (d): the generic quantile makes no host read", True)
    except RuntimeError as e:
        expect(f"path 26 (d): the generic quantile makes no host read: {str(e)[:200]}", False)
        xq = gam.quantile(q)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    qg = q.clone().requires_grad_(True)
    (yq, ldq), lq = launch_delta(lambda: qb.forward_and_log_det(qg))
    expect("path 26 (d): QuantileBijector(Gamma) launches no kernel (plain torch)", not lq)
    expect("path 26 (d): forward_and_log_det's x is quantile's", torch.equal(yq.detach(), xq))
    (gq,) = torch.autograd.grad(yq.sum(), qg)
    check("path 26 (d) Gamma: log-det is -logpdf", ldq.detach(), -gam.logpdf(xq), 1e-6)
    qr = qb.inverse(xq)
    err["gamma_roundtrip"] = check("path 26 (d) Gamma: round trip q -> x -> q", qr, q,
                                   ATOL_ROUNDTRIP, torch.ones_like(q))
    line["gamma"] = quantile_gates("path 26 (d) Gamma(2, 3)", gam, gam64, q, xq, gq.detach(),
                                   PATH26_CPU_COLS)
    beta, beta64 = dists.Beta(2.0, 5.0, **kw), dists.Beta(2.0, 5.0, device="cpu", dtype=torch.float64)
    cb5 = tbt.CDFBijector(beta)
    xb = beta.sample(gen, (BATCH,))
    ub_, ldb = cb5.forward_and_log_det(xb)
    check("path 26 (d) Beta: log-det is logpdf", ldb, beta.logpdf(xb), 1e-6)
    ug = ub_.detach().clone().requires_grad_(True)
    ts = time.perf_counter()
    xr = cb5.inverse(ug)
    torch.cuda.synchronize()
    line["beta_quantile_ms"] = 1e3 * (time.perf_counter() - ts)
    (gb,) = torch.autograd.grad(xr.sum(), ug)
    # u = cdf(x) carries half an ulp of u, 1 - u near x = 1 a few: x comes
    # back within 4 eps32 / pdf(x) plus the solve's ULPS_QUANTILE ulp of x
    eps32 = float(np.finfo(np.float32).eps)
    err["beta_roundtrip"] = check(
        "path 26 (d) Beta: round trip x -> u -> x within 4 eps32 / pdf + 8 ulp", xr.detach(), xb,
        1.0, 4.0 * eps32 / torch.exp(ldb.double()) + ULPS_QUANTILE * eps32 * xb.double().abs())
    line["beta"] = quantile_gates("path 26 (d) Beta(2, 5)", beta, beta64, ub_.detach(),
                                  xr.detach(), gb, PATH26_BETA_COLS)
    del xq, yq, gq, qg, xb, ub_, ug, xr, gb

    torch.cuda.synchronize()
    line["part_s"]["d"] = time.perf_counter() - t0 - sum(line["part_s"].values())
    # (e) NUTS on the quantile-linked prior
    def prior(device, dtype):
        k = dict(device=device, dtype=dtype)
        return dists.NamedProduct.of(theta=tbt.transformed(
            dists.Uniform(0.0, 1.0, **k), tbt.QuantileBijector(dists.Gamma(*QUANTILE_GAMMA, **k))))

    cpu_pick = tbt.Model(prior("cpu", torch.float64), device="cpu")._auto_kernel()
    model = tbt.Model(prior(dev, f32), device=dev)
    card_pick = model._auto_kernel()
    expect(f"path 26 (e): kernel='auto' takes {card_pick} on the card, {cpu_pick} on the CPU",
           card_pick == cpu_pick == "nuts_batched_t")
    ts = time.perf_counter()
    (raw, _, stats), le = launch_delta(lambda: model.sample(
        torch.Generator(device=dev).manual_seed(SEED), kernel="auto", constrained=False,
        **QUANTILE_NUTS))
    sample_s = time.perf_counter() - ts
    th = model.constrain(raw)["theta"].double()
    r_hat = float(np.max(diagnostics.rhat(raw)))
    mean, mcse = float(th.mean()), float(diagnostics.mcse_mean(th))
    exact_mean, exact_sd = QUANTILE_GAMMA[0] / QUANTILE_GAMMA[1], math.sqrt(QUANTILE_GAMMA[0]) / QUANTILE_GAMMA[1]
    dev_mcse = abs(mean - exact_mean) / mcse
    print(f"path 26 (e): theta mean {mean:.4f} (MCSE {mcse:.4f}, exact {exact_mean:.4f}), "
          f"sd {float(th.std()):.4f} (exact {exact_sd:.4f}), R-hat {r_hat:.4f}, launches {le}, "
          f"{sample_s:.1f} s", flush=True)
    expect("path 26 (e): draws finite and positive", bool(torch.isfinite(th).all() & (th > 0).all()))
    expect(f"path 26 (e): theta's mean within 5 MCSE of Gamma(2, rate 3)'s ({dev_mcse:.2f})",
           dev_mcse <= 5.0)
    expect(f"path 26 (e): R-hat {r_hat:.4f} <= 1.05", r_hat <= 1.05)
    expect("path 26 (e): the sampler launched #2's small design, the kernel 'auto' picks",
           le.get(SMALL, 0) > 0)
    launches[SMALL] = le.get(SMALL, 0)
    line["nuts"] = {"kernel": card_pick, "cpu_kernel": cpu_pick, "launches": le,
                    "mean": mean, "mcse": mcse, "sd": float(th.std()), "rhat": r_hat,
                    "divergences": int(stats.diverging.sum()), "seconds": sample_s}

    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    line["part_s"]["e"] = dt - sum(line["part_s"].values())
    line.update({"seconds": dt, "launches": launches})
    print(f"path 26: {dt:.1f} s (parts {line['part_s']}), launches {launches}", flush=True)
    if time_gate:
        expect(f"path 26 within {PATH26_LIMIT_S:g} s", dt < PATH26_LIMIT_S)
    return line, launches, err



# path 27: the remaining distribution families. Its limit holds the warm
# time: (c)'s NUTS at 64 chains, 300 + 200 transitions alone took 14.3 s
# warm on the H100 (its host-bound leapfrog 1.9 ms, tools/torch_path27.py),
# and (c) at 100 kept draws failed R-hat in three of three CPU seeds
# (1.060-1.072), 32 chains saving 8% of its leapfrogs: the rest of the
# path takes about 10 s beside it
PATH27_LIMIT_S = 30.0
P27_IID = 4  # each served scalar family an IID block of 4 rows
P27_CHUNK = 16384  # the composed model's columns a call (StudentizedRange's (B, 96, 96) rule)
# (c)'s settings: path 2's target 0.95. Gompertz takes b = 0.1: its
# density's exp(-eta e^(b x)) is doubly exponential in the log link's v,
# and at b = 1 NUTS strands chains there (R-hat 1.34-1.47 and 800-1443
# divergences of 12800 on the CPU at either target; at b = 0.1 the
# five-leaf prior gave R-hat 1.030 and 1.037, one divergence, seeds 0-1)
P27_NUTS = dict(n_chains=CHAINS, n_warmup=300, n_samples=200, target_accept=TARGET_ACCEPT)
P27_GOMPERTZ = (1.0, 0.1)
P27_EXTREME_COLS = 64
# the served leaves whose linked density the JAX package keeps free of NaN
# at v = +-1e10 (float32 on the CPU; tests/test_torch_plan_decisions.py
# holds the list to it): finite there, or -inf for the bounded kernels
# (the others, Chisq's inf - inf among them, are NaN there in both packages)
P27_FINITE_AT_EXTREMES = ("vm", "lu", "nc", "pgg", "sep", "cen")
P27_NEG_INF_AT_EXTREMES = ("semi", "cos", "epa", "bw", "tw", "sym")
# the composed model's float32 density and gradient against float64, each
# leaf's largest |error| / (|float64| + 1) (the series and quadratures
# measured at 4.4e-7 at most in float32 on the CPU at B = 4096, the
# simplex link's MvLogitNormal 4.8e-5, MatrixBeta's Cholesky 1.1e-5;
# tools/torch_path27.py prints the card's per leaf)
P27_RTOL_SCALAR = 1e-5
P27_RTOL_STRUCTURED = 1e-3
# the discrete pmfs and cdfs in float32 against scipy in float64: a few
# roundings of each lgamma-scale term the pmf sums, so 64 eps32 of
# 1 + |log pmf| + lgamma(|x| + 2); the cdf 64 eps32 absolute
P27_ULPS_DISCRETE = 64.0
P27_KERNELS = SLAB_KERNELS + ("slab_jvp", "slab_traced", SMALL, "simplex_inverse_logdet",
                              SIMPLEX_SMALL, "simplex_forward_logdet", "pd_inverse", "prim_probe")


def p27_served_model(dists, device, dtype):
    """Path 27 (a): the new scalar families both fused plans serve, an IID
    block of P27_IID rows each (the JAX tests' parameters), with an Affine
    of Gamma(2, 1) and a Censored Normal; linked dim 84."""
    kw = dict(device=device, dtype=dtype)
    d = dists
    leaves = {
        "chisq": d.Chisq(3.0, **kw), "fd": d.FDist(10.0, 4.0, **kw),
        "vm": d.VonMises(0.5, 2.0, **kw), "semi": d.Semicircle(1.0, **kw),
        "cos": d.Cosine(0.0, 1.0, **kw), "epa": d.Epanechnikov(0.0, 1.0, **kw),
        "gev": d.GeneralizedExtremeValue(0.0, 1.0, 0.3, **kw), "gom": d.Gompertz(1.0, 1.0, **kw),
        "erl": d.Erlang(7.0, 0.5, **kw), "lu": d.LogUniform(1.0, 10.0, **kw),
        "nc": d.NormalCanon(0.5, 2.0, **kw), "bw": d.Biweight(1.0, 2.0, **kw),
        "tw": d.Triweight(1.0, 1.0, **kw), "sym": d.SymTriangularDist(0.0, 1.0, **kw),
        "pgg": d.PGeneralizedGaussian(1.5, 0.2, 1.3, **kw), "lin": d.Lindley(1.5, **kw),
        "kol": d.Kolmogorov(**kw), "sep": d.SkewedExponentialPower(0.0, 1.0, 0.7, 0.7, **kw),
        "kss": d.KSOneSided(10, **kw), "aff": d.affine(d.Gamma(2.0, 1.0, **kw), 1.0, 2.0),
        "cen": d.Censored(d.Normal(0.0, 1.0, **kw), -1.0, 1.0),
    }
    return d.NamedProduct.of(**{k: d.IIDProduct(v, P27_IID) for k, v in leaves.items()})


def p27_composed_model(dists, device, dtype):
    """Path 27 (b): the leaves both plans decline, each once: their linked
    densities compose (plain torch, as the JAX package's jnp), the
    MvLogitNormal's simplex link on #7 (#9 forward), MatrixBeta's PD link
    on #10; linked dim 34."""
    kw = dict(device=device, dtype=dtype)
    d = dists
    return d.NamedProduct.of(
        gp=d.GeneralizedPareto(0.0, 1.0, 0.3, **kw), ri=d.Rician(0.5, 1.0, **kw),
        ncx=d.NoncentralChisq(2.0, 3.0, **kw), ncb=d.NoncentralBeta(2.0, 3.0, 1.0, **kw),
        ncf=d.NoncentralF(2.0, 3.0, 1.0, **kw), nct=d.NoncentralT(2.0, 3.0, **kw),
        nig=d.NormalInverseGaussian(0.0, 0.5, 0.2, 0.1, **kw),
        sr=d.StudentizedRange(2.0, 2.0, **kw),
        mln=d.MvLogitNormal(np.zeros(4), np.eye(4), **kw),
        mb=d.MatrixBeta(3, 6.0, 7.0, **kw),
        mt=d.MatrixTDist(5.0, np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]),
                         np.array([[1.0, 0.5], [0.5, 1.0]]),
                         np.array([[1.0, 0.3, 0.2], [0.3, 1.0, 0.4], [0.2, 0.4, 1.0]]), **kw),
        mn=d.MatrixNormal(np.zeros((2, 3)), np.eye(2), np.eye(3), **kw),
    )


def p27_nuts_prior(dists, device, dtype):
    """Path 27 (c): a prior of five served families with known means."""
    kw = dict(device=device, dtype=dtype)
    d = dists
    return d.NamedProduct.of(vm=d.VonMises(0.3, 2.0, **kw), gom=d.Gompertz(*P27_GOMPERTZ, **kw),
                             lin=d.Lindley(1.5, **kw), chisq=d.Chisq(3.0, **kw),
                             semi=d.Semicircle(1.5, **kw))


def p27_exact_means():
    """(c)'s exact means: Lindley(1.5)'s (theta + 2) / (theta (theta + 1)),
    Chisq(3)'s 3, Semicircle's 0, and by the trapezoid rule on 2e6 points
    of the closed-form density the VonMises(0.3, 2) mean on (-pi, pi) and
    Gompertz(eta, b)'s (e^eta E1(eta) / b) on [0, 400]."""
    x = np.linspace(-math.pi, math.pi, 2_000_001)
    f = np.exp(2.0 * np.cos(x - 0.3))
    trap = getattr(np, "trapezoid", None) or np.trapz  # numpy 2 renamed it
    vm = trap(x * f, x) / trap(f, x)
    eta, b = P27_GOMPERTZ
    y = np.linspace(0.0, 400.0, 2_000_001)
    g = np.exp(b * y - eta * np.expm1(b * y))
    gom = trap(y * g, y) / trap(g, y)
    return {"vm": vm, "gom": gom, "lin": 3.5 / (1.5 * 2.5), "chisq": 3.0, "semi": 0.0}


def p27_discrete(dev):
    """Path 27 (d): the discrete families with a scipy counterpart at
    B = 131072 on the card (float32): the log pmf and the cdf at the port's
    own draws against scipy.stats in float64 (P27_ULPS_DISCRETE), the draws'
    mean within 5 standard errors of scipy's. Returns the worst error
    ratio per family."""
    import scipy.stats as st

    from tpu_bijectors_torch import dists as d

    kw = dict(device=dev, dtype=torch.float32)
    sig = 1.0 / (1.0 + math.exp(-0.4))
    fams = {
        "Poisson": (d.Poisson(3.0, **kw), st.poisson(3.0)),
        "Bernoulli": (d.Bernoulli(0.3, **kw), st.bernoulli(0.3)),
        "Binomial": (d.Binomial(5, 0.4, **kw), st.binom(5, 0.4)),
        "Geometric": (d.Geometric(0.3, **kw), st.geom(0.3, loc=-1)),
        "NegativeBinomial": (d.NegativeBinomial(5.0, 0.5, **kw), st.nbinom(5, 0.5)),
        "BernoulliLogit": (d.BernoulliLogit(0.4, **kw), st.bernoulli(sig)),
        "BetaBinomial": (d.BetaBinomial(5, 2.0, 2.0, **kw), st.betabinom(5, 2.0, 2.0)),
        "DiscreteUniform": (d.DiscreteUniform(1, 10, **kw), st.randint(1, 11)),
        "Hypergeometric": (d.Hypergeometric(20, 7, 12, **kw), st.hypergeom(27, 20, 12)),
        "Skellam": (d.Skellam(2.0, 3.0, **kw), st.skellam(2.0, 3.0)),
    }
    no_cdf = ("Hypergeometric", "Skellam")
    eps32 = float(np.finfo(np.float32).eps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 270)
    out = {}
    for name, (fam, ref) in fams.items():
        x = fam.sample(gen, (BATCH,))
        xs = x.double().cpu().numpy()
        lp = fam.logpdf(x).double().cpu().numpy()
        # scipy's float64 values on the draws' distinct values, indexed back
        uniq, inv = np.unique(xs, return_inverse=True)
        lp64 = ref.logpmf(uniq)[inv]
        mag = 1.0 + np.abs(lp64) + np.array([math.lgamma(abs(v) + 2.0) for v in uniq])[inv]
        r_lp = float(np.max(np.abs(lp - lp64) / (P27_ULPS_DISCRETE * eps32 * mag)))
        r_cdf = 0.0
        if name not in no_cdf:
            c = fam.cdf(x).double().cpu().numpy()
            r_cdf = float(np.max(np.abs(c - ref.cdf(uniq)[inv]) / (P27_ULPS_DISCRETE * eps32)))
        mean, sd = float(ref.mean()), float(ref.std())
        dev_se = abs(float(xs.mean()) - mean) / (sd / math.sqrt(BATCH))
        out[name] = {"lp": r_lp, "cdf": r_cdf, "mean_dev_se": dev_se}
        expect(f"path 27 (d) {name}: log pmf within {P27_ULPS_DISCRETE:g} eps32 of scipy's "
               f"float64 ({r_lp:.3f} of it), cdf ({r_cdf:.3f}), the draws' mean {dev_se:.2f} "
               f"standard errors from scipy's", r_lp <= 1.0 and r_cdf <= 1.0 and dev_se <= 5.0)
    # Multinomial(10, p), the vector event
    p = np.array([0.2, 0.5, 0.3])
    fam = d.Multinomial(10, p, **kw)
    x = fam.sample(gen, (BATCH,))
    xs = x.double().cpu().numpy()
    uniq, inv = np.unique(xs, axis=0, return_inverse=True)
    lp64 = st.multinomial(10, p).logpmf(uniq)[np.ravel(inv)]
    lp = fam.logpdf(x).double().cpu().numpy()
    r = float(np.max(np.abs(lp - lp64) / (P27_ULPS_DISCRETE * eps32 * (1.0 + np.abs(lp64)
                                                                         + math.lgamma(12.0)))))
    dev_se = np.abs(xs.mean(0) - 10 * p) / np.sqrt(10 * p * (1 - p) / BATCH)
    out["Multinomial"] = {"lp": r, "mean_dev_se": float(dev_se.max())}
    expect(f"path 27 (d) Multinomial: log pmf within {P27_ULPS_DISCRETE:g} eps32 of scipy's "
           f"({r:.3f} of it), every count's mean within 5 standard errors "
           f"({float(dev_se.max()):.2f}), each draw summing to 10",
           r <= 1.0 and float(dev_se.max()) <= 5.0 and bool((x.sum(-1) == 10).all()))
    return out


def p27_extremes(dev, made, cf, loops, rows):
    """Path 27 (a)'s extremes (`made`: `run_traced_model`'s unconstrainer,
    float64 tables and states): every row at +-1e10 (signs from numpy seed
    27) in all four modes against the plain version (its NaN/inf pattern,
    within `traced_allowances` where finite), and a block with only the
    rows of the leaves the JAX package keeps free of NaN at +-1e10 there:
    no NaN in lp, none in g on the rows of those whose density stays
    finite."""
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    n = P27_EXTREME_COLS
    vT = made["vT"]
    sign = torch.as_tensor(np.sign(np.random.default_rng(27).standard_normal((vT.shape[0], n))),
                           dtype=vT.dtype, device=dev)
    vx = (1e10 * sign).contiguous()
    _, _, lpx_allow, gx_allow, _ = traced_allowances(vx, made["cf64"], made["loops64"])
    ct, dv = torch.ones(n, device=dev), torch.ones_like(vx)
    lpx_p, gx_p = fb.slab_value_and_grad_plain(vx, cf, loops)
    check_pattern("path 27 (a) extremes: value kernel", fk.slab_value(vx, cf, loops), lpx_p,
                  2 * lpx_allow)
    lpx_k, gx_k = fk.slab_value_and_grad(vx, cf, loops)
    check_pattern("path 27 (a) extremes: value-and-grad kernel lp", lpx_k, lpx_p, 2 * lpx_allow)
    check_pattern("path 27 (a) extremes: value-and-grad kernel g", gx_k, gx_p, 2 * gx_allow)
    check_pattern("path 27 (a) extremes: vjp kernel", fk.slab_vjp(vx, cf, ct, loops),
                  fb.slab_vjp_plain(vx, cf, ct, loops), 2 * gx_allow)
    check_pattern("path 27 (a) extremes: jvp kernel", fk.slab_jvp(vx, cf, dv, loops),
                  fb.slab_jvp_plain(vx, cf, dv, loops),
                  2 * jvp_allowance(torch.nan_to_num(gx_p.double()), gx_allow, dv))
    vy = vT[:, :n].clone()
    finite_rows = []
    for k in P27_FINITE_AT_EXTREMES + P27_NEG_INF_AT_EXTREMES:
        vy[rows[k]] = vx[rows[k]]
        if k in P27_FINITE_AT_EXTREMES:
            finite_rows += list(range(rows[k].start, rows[k].stop))
    lpy, gy = fk.slab_value_and_grad(vy.contiguous(), cf, loops)
    lpy_v = fk.slab_value(vy.contiguous(), cf, loops)
    expect("path 27 (a) extremes: no NaN in lp with the NaN-free leaves at +-1e10 "
           f"({', '.join(P27_FINITE_AT_EXTREMES + P27_NEG_INF_AT_EXTREMES)})",
           not bool(torch.isnan(lpy).any() or torch.isnan(lpy_v).any()))
    expect("path 27 (a) extremes: no NaN in g on the rows of the leaves finite at +-1e10",
           not bool(torch.isnan(gy[finite_rows]).any()))
    return int(torch.isnan(lpx_p).sum())


def run_remaining_families(dev, time_gate=True):
    """Path 27 (float32): the seventeenth slice's families. (a) the fused
    model of the new served scalar families (`p27_served_model`, dim 84)
    at B = 131072 in all four modes through `run_traced_model` (#1-#4
    with the traced kind, against their plain versions on the card and
    float64 at `traced_allowances`, the composed float64 path) at the
    model's own draws, launching #1-#4 alone, and its extremes
    (`p27_extremes`); (b) the composed model of the leaves the plans
    decline (`p27_composed_model`) at B = 131072 from its own draws,
    through `batched_logdensity_fn` (the entry point of a model with no
    fused plan) in chunks of P27_CHUNK states: the linked density and its
    gradient against float64 per leaf and for the model, the launches
    (#7 and #10, #9 on the way back, none of #1-#4), the round trip
    v -> x -> v; (c)
    NUTS (kernel='auto' -> nuts_batched_t) on `p27_nuts_prior`, #2's small
    design (the item kernel) on every leapfrog with VonMises' cos opcode
    on its tape, against the exact means (R-hat, divergences, 5 MCSE);
    (d) the discrete families against scipy (`p27_discrete`); (e) the
    slab+structured model of tools/tpu_sweep.py:79-90 at B = 131072, fused
    against plain and composed at tpu_sweep.py's tolerances; (f) #14 on
    the cos and sin opcodes. `time_gate=False` leaves out the
    PATH27_LIMIT_S gate, which holds the warm time. Returns (line,
    launches, err, (a)'s (vT, dvT, cf, loops))."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.kernels import prim_probe as pp
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk
    from tpu_bijectors_torch.vectorize import fused_plan as fp

    t0 = time.perf_counter()
    f32 = torch.float32
    line, err = {"part_s": {}}, {}
    launches = dict.fromkeys(P27_KERNELS, 0)
    eps32 = float(np.finfo(np.float32).eps)

    def part(key):
        torch.cuda.synchronize()
        line["part_s"][key] = time.perf_counter() - t0 - sum(line["part_s"].values())

    # (a) the served families, fused, at the model's own draws (0.6 N(0, 1)
    # states put Kolmogorov's and KSOneSided's densities below float32's
    # tiny, where the families clamp: float64 clamps elsewhere). The
    # Censored leaf's atoms at its bounds link to +-inf: those entries take
    # `traced_states`' 0.6 N(0, 1)
    def draws_states(model):
        gen_a = torch.Generator(device=dev).manual_seed(SEED + 273)
        x = p27_served_model(dists, dev, f32).sample(gen_a, (BATCH,))
        vT_a = model.unconstrainer().to_linked_vec(x)[0].T.contiguous()
        fill, dvT_a = traced_states(dev, vT_a.shape[0], vT_a.shape[1])
        return torch.where(torch.isfinite(vT_a), vT_a, fill).contiguous(), dvT_a

    la, prep, ea, made = run_traced_model(dev, "remaining-served", p27_served_model,
                                          states=draws_states, timing=False)
    vT, dvT, cf, loops = prep
    for k, n in la.items():
        if k in launches:
            launches[k] += n
    others = {k: n for k, n in la.items() if n and k not in SLAB_KERNELS + ("slab_jvp",
                                                                             "slab_traced")}
    expect(f"path 27 (a): #1-#4 alone launched, through the traced kind ({others or 'no other'})",
           not others and la["slab_traced"] >= 4)
    err.update(ea)
    u = made["u"]
    made["vT"] = vT
    tapes = {i: t for i, t in loops.tapes.items()}
    has_cos = any(name == "cos" for t in tapes.values() for name, *_ in t.instructions())
    expect("path 27 (a): a tape holds the cos opcode (VonMises, Cosine)", has_cos)
    line["a"] = {"traced_entries": len(loops.entries), "tapes": {
        str(o): [t.n_ins, t.n_slots, len(t.consts)] for o, t in tapes.items()},
        "nan_columns_all_extreme": p27_extremes(dev, made, cf, loops, families_rows(u))}
    part("a")

    # (b) the declined leaves, composed
    model = tbt.Model(p27_composed_model(dists, dev, f32), device=dev)
    # float64 on the card for the plain-torch leaves, on the CPU for the two
    # whose links run kernels (float32 only)
    ub64 = tbt.Model(p27_composed_model(dists, dev, torch.float64), device=dev).unconstrainer()
    ub64c = tbt.Model(p27_composed_model(dists, "cpu", torch.float64),
                      device="cpu").unconstrainer()
    ub = model.unconstrainer()
    expect("path 27 (b): no fused plan (the composed path)", fp._plan(ub) is None)
    gen = torch.Generator(device=dev).manual_seed(SEED + 271)
    x0 = p27_composed_model(dists, dev, f32).sample(gen, (BATCH,))
    vb = ub.to_linked_vec(x0)[0]
    vbT = vb.T.contiguous()
    # the batch-major entry point: on the card the transposed one serves a
    # fused plan alone
    fbm = model.batched_logdensity_fn()
    kernels.reset_launch_counts()
    lp_chunks, lpg_chunks, g_chunks = [], [], []
    for c in range(0, BATCH, P27_CHUNK):
        lp_chunks.append(fbm(vb[c: c + P27_CHUNK]))
        lpg_c, g_c = fbm.value_and_grad_fn(vb[c: c + P27_CHUNK])
        lpg_chunks.append(lpg_c)
        g_chunks.append(g_c)
    torch.cuda.synchronize()
    lb = {k: n for k, n in kernels.LAUNCHES.items() if n}
    lp_b, lpg_b, g_b = torch.cat(lp_chunks), torch.cat(lpg_chunks), torch.cat(g_chunks).T
    del lp_chunks, lpg_chunks, g_chunks
    print(f"launches on path 27 (b)'s density and gradient: {lb}", flush=True)
    expect("path 27 (b): #7 (MvLogitNormal's link) and #10 (MatrixBeta's) launched, none of "
           "#1-#4", lb.get("simplex_inverse_logdet", 0) > 0 and lb.get("pd_inverse", 0) > 0
           and not any(lb.get(k, 0) for k in SLAB_KERNELS + ("slab_jvp", SMALL)))
    for k in ("simplex_inverse_logdet", "pd_inverse"):
        launches[k] += lb.get(k, 0)
    rows_b = families_rows(ub)
    worst = {}
    lp64_b = torch.zeros(BATCH, dtype=torch.float64, device=dev)
    g64_b = torch.zeros(vbT.shape, dtype=torch.float64, device=dev)
    for name, r in rows_b.items():
        c32 = ub.children[ub.names.index(name)]
        on_cpu = name in ("mln", "mb")
        c64 = (ub64c if on_cpu else ub64).children[ub64.names.index(name)]
        e_lp = e_g = 0.0
        for c in range(0, BATCH, P27_CHUNK):
            cols = slice(c, c + P27_CHUNK)
            v64 = vbT[r, cols].double()
            v64 = (v64.cpu() if on_cpu else v64).requires_grad_(True)
            lp64 = c64._linked_logdensity_t_children(v64)
            (g64,) = torch.autograd.grad(lp64.sum(), v64)
            lp64, g64 = lp64.detach().to(dev), g64.to(dev)
            lp64_b[cols] += lp64
            g64_b[r, cols] = g64
            v32 = vbT[r, cols].clone().requires_grad_(True)
            lp32 = c32._linked_logdensity_t_children(v32)
            (g32,) = torch.autograd.grad(lp32.sum(), v32)
            e_lp = max(e_lp, float(((lp32.double() - lp64).abs() / (lp64.abs() + 1.0)).max()))
            e_g = max(e_g, float(((g32.double() - g64).abs() / (g64.abs() + 1.0)).max()))
        tol = P27_RTOL_SCALAR if r.stop - r.start == 1 else P27_RTOL_STRUCTURED
        worst[name] = (e_lp, e_g)
        expect(f"path 27 (b) {name}: lp and g within {tol:g} of float64 (|err| / (|float64| + 1):"
               f" {e_lp:.3e}, {e_g:.3e})", e_lp <= tol and e_g <= tol)
    # the model's entry points against the float64 sums of its leaves
    e_model = {
        "lp": check("path 27 (b): batched_logdensity_fn lp vs float64", lp_b, lp64_b,
                    P27_RTOL_STRUCTURED, lp64_b.abs() + 1.0),
        "vg_lp": check("path 27 (b): value_and_grad_fn lp vs float64", lpg_b, lp64_b,
                       P27_RTOL_STRUCTURED, lp64_b.abs() + 1.0),
        "g": check("path 27 (b): value_and_grad_fn g vs float64", g_b, g64_b,
                   P27_RTOL_STRUCTURED, g64_b.abs() + 1.0),
    }
    line["b"] = {"rel_err": worst, "model_max_abs_err": e_model, "launches": lb}
    del lp64_b, g64_b, g_b, lpg_b
    # the round trip v -> x -> v, its launches
    (x1, ld1), l_inv = launch_delta(lambda: ub.from_linked_vec(vb))
    (v2, ld2), l_fwd = launch_delta(lambda: ub.to_linked_vec(x1))
    print(f"path 27 (b) round trip launches: inverse {l_inv}, forward {l_fwd}", flush=True)
    expect("path 27 (b): from_linked_vec launches #7 and #10, to_linked_vec #9",
           l_inv.get("simplex_inverse_logdet", 0) > 0 and l_inv.get("pd_inverse", 0) > 0
           and l_fwd.get("simplex_forward_logdet", 0) > 0)
    for k, n in list(l_inv.items()) + list(l_fwd.items()):
        if k in launches:
            launches[k] += n
    mbr = rows_b["mb"]
    other = [i for i in range(vb.shape[1]) if not mbr.start <= i < mbr.stop]
    xa = torch.cat([vb[:, i: i + 1] for i in other], 1)
    check("path 27 (b) round trip v -> x -> v, all but MatrixBeta's rows",
          torch.cat([v2[:, i: i + 1] for i in other], 1), xa, ATOL_ROUNDTRIP,
          xa.abs() + 1.0)
    ev = torch.linalg.eigvalsh(x1["mb"].double().cpu())
    kappa = ev[:, -1] / ev[:, 0]
    row_err = (v2[:, mbr] - vb[:, mbr]).abs().amax(dim=1).double().cpu()
    ratio = float((row_err / (kappa * eps32 + ATOL_ROUNDTRIP)).max())
    print(f"path 27 (b) round trip, MatrixBeta rows: max error {float(row_err.max()):.3e}, max "
          f"kappa {float(kappa.max()):.3e}, max error / (kappa eps32 + {ATOL_ROUNDTRIP:g}) "
          f"{ratio:.3e}", flush=True)
    expect("path 27 (b) round trip, MatrixBeta rows within kappa(U) eps32", ratio <= 1.0)
    check("path 27 (b) round trip: to_linked_vec's log-det is minus from_linked_vec's", ld2, -ld1,
          RTOL_ROUNDTRIP_LD, ld1.abs() + 1e-3 * ld1.abs().max())
    line["b"]["roundtrip_mb_ratio"] = ratio
    del x0, x1, v2, vb, vbT
    part("b")

    # (c) NUTS on the served prior
    prior = tbt.Model(p27_nuts_prior(dists, dev, f32), device=dev)
    kernel = prior._auto_kernel()
    pu = prior.unconstrainer()
    tape_ops_ = [name for e in fp._plan(pu) if e.loop == "traced" for name, *_ in
                 e.tape.instructions()]
    expect(f"path 27 (c): kernel='auto' takes nuts_batched_t ({kernel}), VonMises' tape with "
           "the cos opcode", kernel == "nuts_batched_t" and "cos" in tape_ops_)
    ts = time.perf_counter()
    (raw, state, stats), lc = launch_delta(lambda: prior.sample(
        torch.Generator(device=dev).manual_seed(SEED), kernel="auto", constrained=False,
        **P27_NUTS))
    sample_s = time.perf_counter() - ts
    xs = prior.constrain(raw)
    r_hat = float(np.max(diagnostics.rhat(raw)))
    n_div = int(stats.diverging.sum())
    exact = p27_exact_means()
    dev_mcse = {}
    for k, m in exact.items():
        dr = xs[k].double()
        dev_mcse[k] = abs(float(dr.mean()) - m) / float(diagnostics.mcse_mean(dr))
    print(f"path 27 (c): R-hat {r_hat:.4f}, divergences {n_div}, launches {lc}, means' "
          f"deviations in MCSE {dev_mcse}, {sample_s:.1f} s", flush=True)
    expect("path 27 (c): #2's small design (the item kernel) on every leapfrog, its large "
           f"design on none ({lc})", lc.get(SMALL, 0) > 0
           and lc.get("slab_value_and_grad", 0) == 0 and lc.get("slab_traced", 0) > 0)
    expect(f"path 27 (c): R-hat {r_hat:.4f} <= 1.05", r_hat <= 1.05)
    n_tr = P27_NUTS["n_chains"] * P27_NUTS["n_samples"]
    expect(f"path 27 (c): divergences {n_div} <= 1% of {n_tr}", n_div <= 0.01 * n_tr)
    for k, dm in dev_mcse.items():
        expect(f"path 27 (c): the mean of {k} within 5 MCSE of its exact mean ({dm:.2f})",
               dm <= 5.0)
    launches[SMALL] += lc.get(SMALL, 0)
    launches["slab_traced"] += lc.get("slab_traced", 0)
    line["c"] = {"kernel": kernel, "rhat": r_hat, "divergences": n_div, "dev_in_mcse": dev_mcse,
                 "launches": lc, "seconds": sample_s, "step_size": float(state.eps),
                 "leapfrogs_per_transition": float(stats.n_steps.float().mean())}
    part("c")

    # (d) the discrete families against scipy
    line["d"] = p27_discrete(dev)
    part("d")

    # (e) the mixed slab+structured model of tools/tpu_sweep.py:79-90
    kw = dict(device=dev, dtype=f32)
    d = dists
    mixed = tbt.Model(d.NamedProduct.of(
        mu=d.IIDProduct(d.Normal(0.5, 2.0, **kw), 4), sig=d.LogNormal(0.1, 0.5, **kw),
        w=d.Dirichlet(np.ones(5) * 1.3, **kw), c=d.LKJ(4, 2.0, **kw),
        wi=d.Wishart(6.0, np.eye(3), **kw), mvd=d.MvNormalDiag(np.zeros(3), np.ones(3), **kw),
        mvt=d.MvNormalTril(np.zeros(3), np.array([[1.3, 0.0, 0.0], [0.4, 0.9, 0.0],
                                                  [-0.2, 0.3, 1.6]]), **kw)), device=dev)
    um = mixed.unconstrainer()
    ve = torch.as_tensor(0.6 * np.random.default_rng(SEED + 272).standard_normal(
        (mixed.dim(), BATCH)), dtype=f32, device=dev)
    fm = mixed.batched_logdensity_t_fn()
    (lp_e, (lpv_e, g_e)), le = launch_delta(lambda: (fm(ve), fm.value_and_grad_fn(ve)))
    cfm, loopsm, c0m = fk._prep(um, ve)
    lp_pe, g_pe = fb.slab_value_and_grad_plain(ve, cfm, loopsm)
    v_r = ve.detach().requires_grad_(True)
    comp = um._linked_logdensity_t_children(v_r)
    (g_ce,) = torch.autograd.grad(comp.sum(), v_r)
    comp = comp.detach()
    print(f"path 27 (e) launches: {le}", flush=True)
    expect("path 27 (e): the fused #1 and #2 launched", le.get("slab_value", 0) > 0
           and le.get("slab_value_and_grad", 0) > 0)
    for k in ("slab_value", "slab_value_and_grad"):
        launches[k] += le.get(k, 0)

    def close(tag, got, ref, rtol, atol):
        # tpu_sweep.py's assert_allclose: |got - ref| <= atol + rtol |ref|
        return check(f"{tag} (rtol {rtol:g}, atol {atol:g})", got, ref, 1.0,
                     atol + rtol * ref.double().abs())

    line["e"] = {
        "lp_vs_plain": close("path 27 (e): fused lp vs plain", lp_e, lp_pe + c0m, 1e-4, 5e-4),
        "lp_vs_composed": close("path 27 (e): fused lp vs composed", lp_e, comp, 1e-4, 5e-4),
        "vg_lp_vs_composed": close("path 27 (e): value_and_grad lp vs composed", lpv_e, comp,
                                   1e-4, 5e-4),
        "g_vs_plain": close("path 27 (e): fused g vs plain", g_e, g_pe, 2e-4, 1e-3),
        "g_vs_composed": close("path 27 (e): fused g vs composed", g_e, g_ce, 2e-4, 1e-3),
    }
    del ve, g_e, g_pe, g_ce
    part("e")

    # (f) #14 on cos and sin
    rows_f = {}
    before = kernels.LAUNCHES["prim_probe"]
    for op in ("cos", "sin"):
        x, y, z = pp.inputs(op, dev)
        r = pp.check_op(op, x, y, z)
        rows_f[op] = r
        expect(f"path 27 (f) #14 {op}: value and tangent within {pp.TOL:g} of plain and float64, "
               f"the same NaN/inf pattern ({r})", r["ok"])
        err["prim_probe"] = max(err.get("prim_probe", 0.0), r["err_value_plain"],
                                r["err_tangent_plain"])
    launches["prim_probe"] += kernels.LAUNCHES["prim_probe"] - before
    expect("path 27 (f): prim_probe launched", launches["prim_probe"] > 0)
    line["f"] = rows_f
    part("f")

    dt = time.perf_counter() - t0
    line.update({"seconds": dt, "launches": launches})
    print(f"path 27: {dt:.1f} s (parts {line['part_s']}), launches {launches}", flush=True)
    if time_gate:
        expect(f"path 27 within {PATH27_LIMIT_S:g} s", dt < PATH27_LIMIT_S)
    return line, launches, err, prep


# --- path 28: the engines that need no flows, the flows and NeuTra ------------

# Its limit holds the warm time alone (tools/torch_path28.py): 111.4-182.8 s
# on the H100 (PERF.md sections 5-6, the slowest on a machine 1.6 times
# slower at cell 2), most of it (f)'s NUTS, which needs cell 4's 300 + 200
# transitions for its R-hat gate (150 kept draws failed it twice: 1.0520,
# 1.0537) and takes 7979 batched leapfrogs at the bench density's 10.3-15.7
# ms; (a) adds 21-30 s and (b)-(e) about 20 s. A longer or deeper NeuTra
# fit does not shorten its trees (tools/neutra_fit_depth.py). 240 s leaves
# that slowest run a margin of 1.3
PATH28_LIMIT_S = 240.0
# (a) parallel tempering on the bench model's prior / likelihood split
P28_PT = dict(n_temps=4, n_warmup=100, n_samples=100, n_leapfrog=8)
# (b) the ensemble on a small conjugate model: w ~ Dirichlet(1, 1, 1, 1),
# p ~ Beta(2, 3); multinomial counts of w and Bernoulli draws of p
P28_ENS = dict(n_warmup=300, n_samples=700)
P28_ENS_WALKERS = 64
P28_ENS_COUNTS = (12.0, 7.0, 3.0, 18.0)
P28_ENS_BETA = (2.0, 3.0)
P28_ENS_HEADS = (13, 40)  # heads of trials
# (c) SBC on w ~ Dirichlet(1, 1, 1, 1), mu ~ N(0, 1), 20 categorical draws
# of w and 5 N(mu, 1) observations a simulation
P28_SBC = dict(n_sims=CHAINS, n_warmup=100, n_samples=128, thin=2)
P28_SBC_DRAWS, P28_SBC_OBS = 20, 5
P28_SBC_MIN_P = 1e-3
P28_PRIOR_N = BATCH  # (d)'s prior predictive draws
# (e) the flows at dim 151; the stacks' widths
P28_FLOW = dict(n_layers=2, hidden=64)
P28_RQS_K = 8
P28_NSF_RT_B = 4096
# (f) NeuTra on the bench model with the likelihood
P28_NEUTRA_FIT = dict(n_steps=300, n_mc=32, n_layers=2, hidden=64)
# NUTS at cell 4's settings: at 150 kept draws (after 150 or 250 warmup)
# the max R-hat over the 151 coordinates was 1.052-1.054 on the card
# (tools/torch_path28.py; PERF.md section 6)
P28_NEUTRA = dict(n_chains=CHAINS, n_warmup=WARMUP, n_samples=KEPT, max_depth=MAX_DEPTH,
                  target_accept=TARGET_ACCEPT)
# (e)'s float32 flows against their float64 evaluation on the same weights
# and inputs: |y32 - y64| <= P28_ULPS * eps32 * (|y64| + scale) elementwise,
# the log-dets with their largest |value| + 1 as scale, the round trip
# x -> y -> x against x likewise (the planar map's scales from its
# condition: `planar_scales`)
P28_ULPS = 64.0
P28_KERNELS_A = ("lkj_logdet", "lkj_inverse")
P28_SIMPLEX = ("simplex_inverse_logdet", SIMPLEX_SMALL)


def p28_ensemble_model(dists, tbt, device, dtype):
    """(b): a Dirichlet(1, 1, 1, 1) leaf and a Beta(2, 3) leaf with a
    multinomial and a Bernoulli likelihood; returns (model, exact posterior
    means of the constrained w and p)."""
    kw = dict(device=device, dtype=dtype)
    c = torch.tensor(P28_ENS_COUNTS, **kw)
    h, n = P28_ENS_HEADS

    def loglik(x):
        return (torch.sum(c * torch.log(x["w"])) + h * torch.log(x["p"])
                + (n - h) * torch.log1p(-x["p"]))

    priors = dists.NamedProduct.of(w=dists.Dirichlet(np.ones(4), **kw),
                                   p=dists.Beta(*P28_ENS_BETA, **kw))
    a = 1.0 + np.asarray(P28_ENS_COUNTS)
    pa, pb = P28_ENS_BETA[0] + h, P28_ENS_BETA[1] + n - h
    return tbt.Model(priors, loglik, device=device), {"w": a / a.sum(), "p": pa / (pa + pb)}


def p28_sbc_model(dists, device, dtype):
    """(c) and (d): prior, simulate (the whole batch of draws: counts of
    P28_SBC_DRAWS categorical draws of w, P28_SBC_OBS N(mu, 1) draws) and
    the likelihood of one simulation."""
    kw = dict(device=device, dtype=dtype)
    prior = dists.NamedProduct.of(w=dists.Dirichlet(np.ones(4), **kw),
                                  mu=dists.Normal(0.0, 1.0, **kw))

    def simulate(generator, x):
        w, mu = x["w"], x["mu"]
        idx = torch.multinomial(w, P28_SBC_DRAWS, replacement=True, generator=generator)
        counts = torch.nn.functional.one_hot(idx, 4).sum(1).to(w.dtype)
        z = mu[:, None] + torch.randn((mu.shape[0], P28_SBC_OBS), generator=generator,
                                      dtype=mu.dtype, device=mu.device)
        return {"counts": counts, "z": z}

    def loglik(data, x):
        return (torch.sum(data["counts"] * torch.log(x["w"]))
                - 0.5 * torch.sum((data["z"] - x["mu"]) ** 2))

    return prior, simulate, loglik


def p28_launches(before):
    from tpu_bijectors_torch import kernels

    return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES
            if kernels.LAUNCHES[k] != before[k]}


def count_syncs(fn):
    """(fn(), the card's synchronizations while it ran, their sources):
    torch's sync debug mode in 'warn', each warning's Python stack (its
    last frames) recorded."""
    import traceback
    import warnings

    if not torch.cuda.is_available():
        return fn(), 0, []
    stacks = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")][-6:]
            stacks.append(" <- ".join(f"{f.filename.split('/')[-1]}:{f.lineno}"
                                      for f in reversed(frames)))

    torch.cuda.synchronize()
    # switching the mode on warns once itself (torch.cuda's own call), so it
    # comes before the recording starts
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, len(stacks), sorted(set(stacks))


def w_dev_in_mcse(w, counts):
    """max over the 16 coordinates of |mean - Dirichlet(1 + counts) mean| /
    MCSE, from draws (n, chains, 16)."""
    from tpu_bijectors_torch import diagnostics

    post = (1.0 + counts) / (16.0 + counts.sum())
    mcse = diagnostics.mcse_mean(w)
    return float(np.max(np.abs(w.double().mean(dim=(0, 1)).cpu().numpy() - post) / mcse))


def run_p28_tempering(dev, loglik, counts):
    """(a): `run_parallel_tempering` on the bench model's batch-major prior
    (`Model(bench).batched_logdensity_fn()`: #5, #7) and the likelihood
    hier_loglik(constrain(v)) (#6, #7), 4 rungs x 64 chains; then (d)'s
    posterior predictive from the cold draws. Returns (line, launches,
    cold draws constrained)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.infer import hmc_batched, run_parallel_tempering

    model = tbt.Model(bench_model(dists, dev, torch.float32), device=dev)
    prior = model.batched_logdensity_fn()

    def lik(v):
        return torch.func.vmap(loglik)(model.constrain(v))

    lik.batch_capable = True
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q0 = model.init_positions(gen, CHAINS, scale=0.3)
    # first uses (the densities' tables of constants, made once; torch's
    # own handles) come before the counted run: a run of one sweep each way
    run_parallel_tempering(prior, lik, gen, q0, **{**P28_PT, "n_warmup": 1, "n_samples": 1})
    syncs_before = dict(hmc_batched.SYNCS)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    res, n_sync, where = count_syncs(lambda: run_parallel_tempering(
        prior, lik, gen, q0, **P28_PT))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p28_launches(before)
    sweeps = P28_PT["n_warmup"] + P28_PT["n_samples"]
    samples = model.constrain(res.samples)
    dev_w = w_dev_in_mcse(samples["w"], counts)
    from tpu_bijectors_torch import diagnostics

    line = {
        "rungs": P28_PT["n_temps"], "chains": CHAINS, **P28_PT, "seconds": dt,
        "ms_per_sweep": 1e3 * dt / sweeps,
        "ms_per_lattice_leapfrog": 1e3 * dt / (sweeps * (P28_PT["n_leapfrog"] + 1)),
        "card_syncs": n_sync, "sync_sources": where,
        "engine_reads": {k: hmc_batched.SYNCS[k] - syncs_before[k] for k in syncs_before},
        "swap_accept": res.swap_accept.tolist(), "accept": res.accept.tolist(),
        "eps": res.eps.tolist(), "betas": res.betas.tolist(),
        "log_evidence": float(res.log_evidence),
        "max_w_dev_in_mcse": dev_w,
        "max_rhat": float(np.max(diagnostics.rhat(res.samples))),
        "launches": launches,
    }
    expect(f"path 28 (a): cold draws {tuple(res.samples.shape)} finite",
           tuple(res.samples.shape) == (P28_PT["n_samples"], CHAINS, 151)
           and bool(torch.isfinite(res.samples).all()))
    expect(f"path 28 (a): w means within 5 MCSE of Dirichlet(1 + counts) (max {dev_w:.2f})",
           dev_w <= 5.0)
    expect(f"path 28 (a): TI log-evidence finite ({line['log_evidence']:.3f})",
           math.isfinite(line["log_evidence"]))
    expect(f"path 28 (a): each pair's swap acceptance in (0, 1] ({line['swap_accept']})",
           all(0.0 < a <= 1.0 for a in line["swap_accept"]))
    expect(f"path 28 (a): no host read in a sweep (card syncs {n_sync} at {where}, "
           f"engine reads {line['engine_reads']})",
           n_sync == 0 and not any(line["engine_reads"].values()))
    if dev.type == "cuda":
        expect(f"path 28 (a): #5, #6, #7 launched ({launches})",
               all(launches.get(k, 0) > 0 for k in P28_KERNELS_A)
               and sum(launches.get(k, 0) for k in P28_SIMPLEX) > 0)
    return line, launches, samples


def run_p28_ensemble(dev):
    """(b): `run_ensemble` with 64 walkers on the conjugate model, its
    batch-major density (#7 on the half-ensembles)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import run_ensemble

    model, exact = p28_ensemble_model(dists, tbt, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q0 = model.init_positions(gen, P28_ENS_WALKERS, scale=0.3)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    res = run_ensemble(model.batched_logdensity_fn(), gen, q0, **P28_ENS)
    x = model.constrain(res.samples)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p28_launches(before)
    devs = {}
    for k in ("w", "p"):
        mcse = np.atleast_1d(diagnostics.mcse_mean(x[k]))
        mean = x[k].double().mean(dim=(0, 1)).cpu().numpy()
        devs[k] = float(np.max(np.abs(mean - exact[k]) / mcse))
    line = {"walkers": P28_ENS_WALKERS, **P28_ENS, "seconds": dt,
            "ms_per_sweep": 1e3 * dt / (P28_ENS["n_warmup"] + P28_ENS["n_samples"]),
            "accept_rate": float(res.accept_rate), "max_dev_in_mcse": devs,
            "launches": launches}
    expect(f"path 28 (b): means within 5 MCSE of the exact posterior ({devs})",
           max(devs.values()) <= 5.0)
    if dev.type == "cuda":
        expect(f"path 28 (b): #7 launched ({launches})",
               sum(launches.get(k, 0) for k in P28_SIMPLEX) > 0)
    return line, launches


def run_p28_sbc(dev):
    """(c): `sbc_ranks` with kernel='nuts_batched', the simulations as 64
    chains (`to_linked_vec` of the prior draws: #9; the density: #7)."""
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.infer import sbc_ranks, sbc_uniformity

    prior, simulate, loglik = p28_sbc_model(dists, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    res = sbc_ranks(prior, simulate, loglik, gen, max_depth=MAX_DEPTH, **P28_SBC)
    p = sbc_uniformity(res.ranks, res.n_draws)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p28_launches(before)
    L = res.n_draws
    line = {**P28_SBC, "seconds": dt, "n_draws": L, "p_values": p.tolist(),
            "ranks_min": int(res.ranks.min()), "ranks_max": int(res.ranks.max()),
            "launches": launches}
    expect(f"path 28 (c): ranks {tuple(res.ranks.shape)} in 0 .. {L}",
           tuple(res.ranks.shape) == (P28_SBC["n_sims"], 4)
           and 0 <= line["ranks_min"] and line["ranks_max"] <= L)
    expect(f"path 28 (c): every coordinate's uniformity p-value >= {P28_SBC_MIN_P:g} "
           f"({line['p_values']})", min(line["p_values"]) >= P28_SBC_MIN_P)
    if dev.type == "cuda":
        expect(f"path 28 (c): #7 and #9 launched ({launches})",
               sum(launches.get(k, 0) for k in P28_SIMPLEX) > 0
               and launches.get("simplex_forward_logdet", 0) > 0)
    return line, launches


def run_p28_prior_predictive(dev):
    """(d), first half: `prior_predictive` of (c)'s model at n = 131072, its
    moments against the exact ones: E counts_k = 5, Var counts_k = 18
    (w_k ~ Beta(1, 3)), E z = 0, Var z = 2."""
    from tpu_bijectors_torch import dists
    from tpu_bijectors_torch.infer import prior_predictive

    prior, simulate, _ = p28_sbc_model(dists, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    theta, y = prior_predictive(prior, simulate, gen, P28_PRIOR_N)
    n = P28_PRIOR_N
    worst = {}
    for key, mean, var in (("counts", P28_SBC_DRAWS / 4.0, 18.0), ("z", 0.0, 2.0)):
        d = y[key].double()
        c = d - d.mean(0)
        m2 = (c * c).mean(0)
        se_var = torch.sqrt(((c ** 4).mean(0) - m2 ** 2) / n)
        worst[key] = max(float(((d.mean(0) - mean).abs() / math.sqrt(var / n)).max()),
                         float(((m2 - var).abs() / se_var).max()))
    dt = time.perf_counter() - t0
    expect(f"path 28 (d): prior predictive draws ({tuple(y['counts'].shape)}, "
           f"{tuple(y['z'].shape)})", tuple(y["counts"].shape) == (n, 4)
           and tuple(y["z"].shape) == (n, P28_SBC_OBS) and theta["w"].shape == (n, 4))
    expect(f"path 28 (d): prior predictive means and variances within 5 standard errors "
           f"({worst})", max(worst.values()) <= 5.0)
    return {"n": n, "seconds": dt, "worst_in_se": worst}


def run_p28_posterior_predictive(dev, samples, counts):
    """(d), second half: `posterior_predictive` from (a)'s cold draws
    (leaves (n_kept, 64, ...): has_chains inferred), the 200 counts drawn
    from w; `ppc_pvalue` of the largest count against a recount on the
    host."""
    from tpu_bijectors_torch.infer import posterior_predictive, ppc_pvalue

    def simulate(generator, x):
        idx = torch.multinomial(x["w"], int(counts.sum()), replacement=True,
                                generator=generator)
        return torch.nn.functional.one_hot(idx, 16).sum(1).to(x["w"].dtype)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    y_rep = posterior_predictive(simulate, samples, gen)
    n_total = samples["w"].shape[0] * samples["w"].shape[1]
    obs = torch.as_tensor(counts, dtype=torch.float32, device=dev)
    p = float(ppc_pvalue(torch.amax, obs, y_rep))
    # the host's count of replicated maxima at or above the observed one
    recount = int(np.sum(y_rep.amax(1).cpu().numpy() >= counts.max()))
    expect(f"path 28 (d): posterior predictive {tuple(y_rep.shape)} (has_chains inferred)",
           tuple(y_rep.shape) == (n_total, 16))
    expect(f"path 28 (d): ppc_pvalue {p} is the host's recount {recount} of {n_total}",
           round(p * n_total) == recount and abs(p - recount / n_total) <= EPS32)
    return {"n_total": n_total, "ppc_max_count": p, "recount": recount}


def flow_err(got, ref, scale, ulps):
    """max |got - ref| / (ulps eps32 (|ref| + scale)) (<= 1 passes)."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / (ulps * EPS32 * (ref.abs() + scale))).max())


def planar_scales(b64, x64):
    """The planar map's per-state error scales in float32, from its float64
    quantities: w'z carries eps32 |w| |z| of error, which moves y by
    |u_hat| sech^2 of it and the log-det by |c| sech^2 / (1 + c sech^2)
    times its 2|tanh|, c = w'u_hat; the inverse's root alpha takes it times
    x = 1 / (1 + c sech^2) (the map's condition, large where c is near -1).
    Returns (forward scale, round-trip scale), each (B,)."""
    u_hat, c = b64._u_hat()
    t = torch.tanh(x64 @ b64.w + b64.b.reshape(()))
    sech2 = 1.0 - t * t
    cond = 1.0 / (1.0 + c * sech2)
    s = torch.linalg.vector_norm(b64.w) * torch.linalg.vector_norm(x64, dim=-1)
    s_fwd = s * (torch.linalg.vector_norm(u_hat) + c.abs()) * sech2 * cond + 1.0
    return s_fwd, s_fwd * cond


def run_p28_flows(dev, batch=None):
    """(e): every flow layer and the MAF and NSF-AR stacks at dim 151 and
    B = 131072 in float32, against their float64 evaluation on the same
    weights and inputs (forward and log-det), the round trip, the RQS's
    identity tails at +-(B + 1) and +-1e10 with no NaN, and find_alpha's
    gradient against the implicit rule in float64."""
    from tpu_bijectors_torch import flows
    from tpu_bijectors_torch.bijectors import Invert

    dim, batch = 151, batch or BATCH
    g64 = torch.Generator(device=dev).manual_seed(SEED)
    f64 = dict(dtype=torch.float64, device=dev)
    rng = np.random.default_rng(28)
    x64 = torch.as_tensor(rng.standard_normal((batch, dim)), **f64)
    x32 = x64.float()
    made = {
        # w and u at 1/sqrt(dim): w'u is O(1). With N(0, 1) entries w'u is
        # N(0, 151), and where it is below about -17 w'u_hat = log1pexp(w'u)
        # - 1 rounds to -1 in float32, so the layer's float32 log-det is
        # -inf on the hyperplane w'z + b = 0 (in either package)
        "planar": flows.PlanarLayer(*(t / math.sqrt(dim) for t in (
            torch.randn(dim, generator=g64, **f64), torch.randn(dim, generator=g64, **f64))),
            torch.randn((), generator=g64, **f64)),
        "radial": flows.RadialLayer.init(g64, dim, **f64),
        "rqs": flows.RationalQuadraticSpline.init(g64, P28_RQS_K, 3.0, event_dim=dim, **f64),
        "batchnorm": flows.InvertibleBatchNorm(
            0.1 * torch.randn(dim, generator=g64, **f64),
            0.1 * torch.randn(dim, generator=g64, **f64),
            0.1 * torch.randn(dim, generator=g64, **f64),
            torch.rand(dim, generator=g64, **f64) + 0.5),
        "maf_stack": flows.maf_stack(g64, dim, **P28_FLOW, **f64),
        "nsf_stack": flows.nsf_ar_stack(g64, dim, **P28_FLOW, **f64),
    }
    rows, worst = {}, 0.0
    for name, b64 in made.items():
        b32 = flows.with_flow_parameters(b64, [p.float() for p in flows.flow_parameters(b64)])
        # the NSF stack's inverse (151 fixed-point passes of (B, 151, K)
        # spline tables a layer) on the first P28_NSF_RT_B states
        n_rt = P28_NSF_RT_B if name == "nsf_stack" else batch
        t0 = time.perf_counter()
        with torch.no_grad():
            y, ld = b32.forward_and_log_det(x32)
            y_ref, ld_ref = b64.forward_and_log_det(x64)
            x_back = b32.inverse(y[:n_rt])
            if name == "rqs":  # elementwise: the log-dets summed per state
                ld, ld_ref = ld.sum(-1), ld_ref.sum(-1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        s_fwd, s_rt = 1.0, 1.0
        if name == "planar":
            s_fwd, s_rt = planar_scales(b64, x64)
        ld_scale = s_fwd if name == "planar" else float(ld_ref.abs().max()) + 1.0
        r = {"y": flow_err(y, y_ref, s_fwd[:, None] if name == "planar" else 1.0, P28_ULPS),
             "logdet": flow_err(ld, ld_ref, ld_scale, P28_ULPS),
             "round_trip": flow_err(x_back, x64[:n_rt],
                                    s_rt[:n_rt, None] if name == "planar" else 1.0,
                                    P28_ULPS),
             "seconds": dt}
        rows[name] = r
        worst = max(worst, r["y"], r["logdet"], r["round_trip"])
        expect(f"path 28 (e) {name}: finite, y {r['y']:.3f}, log-det {r['logdet']:.3f}, "
               f"round trip {r['round_trip']:.3f} of their bounds",
               all(bool(torch.isfinite(t).all()) for t in (y, ld, x_back))
               and max(r["y"], r["logdet"], r["round_trip"]) <= 1.0)
        del y, ld, y_ref, ld_ref, x_back
    # Invert of the MAF stack: the data-fitting direction, at a slice
    inv = Invert(flows.with_flow_parameters(
        made["maf_stack"], [p.float() for p in flows.flow_parameters(made["maf_stack"])]))
    with torch.no_grad():
        u, ld_u = inv.forward_and_log_det(x32[:4096])
        u64, ld_u64 = Invert(made["maf_stack"]).forward_and_log_det(x64[:4096])
    rows["invert_maf_stack"] = {"u": flow_err(u, u64, 1.0, P28_ULPS),
                                "logdet": flow_err(ld_u, ld_u64, float(ld_u64.abs().max()) + 1.0,
                                                   P28_ULPS)}
    expect(f"path 28 (e): Invert(maf_stack) against float64 ({rows['invert_maf_stack']})",
           max(rows["invert_maf_stack"].values()) <= 1.0)
    # the RQS's identity tails and the NSF stack's outside the box
    tails = torch.tensor([-1e10, -5.0, -4.0 - 1e-3, 4.0 + 1e-3, 5.0, 1e10], device=dev)
    xt = tails.repeat(dim, 1).T.contiguous()
    rqs32, nsf32 = (flows.with_flow_parameters(made[k], [p.float() for p in
                                                        flows.flow_parameters(made[k])])
                    for k in ("rqs", "nsf_stack"))
    with torch.no_grad():
        yr, ldr = rqs32.forward_and_log_det(xt)
        xr = rqs32.inverse(yr)
        yn, ldn = nsf32.forward_and_log_det(xt)
    no_nan = all(not bool(torch.isnan(t).any()) for t in (yr, ldr, xr, yn, ldn))
    expect("path 28 (e): RQS identity tails: y = x, log-det 0, inverse x, no NaN (also the "
           "NSF stack's)", no_nan and bool(torch.equal(yr, xt)) and bool(torch.equal(xr, xt))
           and bool((ldr == 0).all()))
    # find_alpha's gradient (float32, autograd through the Function) against
    # the implicit rule at the float64 root
    W, U, Bb = (torch.as_tensor(a.ravel(), device=dev) for a in np.meshgrid(
        np.linspace(-10.0, 20.0, 31), [-0.99, -0.5, 0.0, 0.5, 2.0, 10.0], [-3.0, 0.0, 1.0, 5.0],
        indexing="ij"))
    args = [a.float().requires_grad_(True) for a in (W, U, Bb)]
    grads = torch.autograd.grad(flows.find_alpha(*args).sum(), args)
    alpha64 = flows.find_alpha(W.double(), U.double(), Bb.double())
    t = torch.tanh(alpha64 + Bb.double())
    xx = 1.0 / (1.0 + U.double() * (1.0 - t * t))
    rule = (xx, -t * xx, xx - 1.0)
    # the float32 root sits within eps32 (|alpha| + |wt_y| + 2|u| + 1) of the
    # float64 one (the last bracket's width); the partials move by their
    # alpha-derivative (at most x + 2|u| x^2) times that
    scale = ((xx + 2.0 * U.abs() * xx * xx)
             * (alpha64.abs() + W.abs() + 2.0 * U.abs() + 1.0))
    ga = max(flow_err(g, r, scale, P28_ULPS) for g, r in zip(grads, rule))
    rows["find_alpha_grad"] = ga
    expect(f"path 28 (e): find_alpha's gradient vs the implicit rule ({ga:.3f} of its bound)",
           ga <= 1.0)
    return {"dim": dim, "batch": batch, **P28_FLOW, "rows": rows, "worst_to_bound": worst}


def run_p28_neutra(dev, loglik, counts, fit_kw=None):
    """(f): `neutra_sample(Model(bench, hier_loglik), kernel='nuts_batched')`
    with a MAF transport fitted by `fit_neutra_flow` (timed apart) at
    `fit_kw` (default P28_NEUTRA_FIT), 64 chains: every leapfrog the
    flow's masked products over the chains, then the batch-major density
    with the likelihood (#6, #7; the prior's LKJ term from #6's factor, so
    no #5). Returns (line, launches)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.infer import fit_neutra_flow, neutra_sample

    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    fit_kw = fit_kw or P28_NEUTRA_FIT
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    fit = fit_neutra_flow(model.batched_logdensity_fn(), gen, model.dim(), dtype=torch.float32,
                          device=dev, **fit_kw)
    sync()
    t1 = time.perf_counter()
    mid = dict(kernels.LAUNCHES)
    v, res, stats = neutra_sample(model, gen, constrained=False, flow=fit.flow, **P28_NEUTRA)
    sync()
    t2 = time.perf_counter()
    launches = p28_launches(before)
    leapfrogs = kernels.LAUNCHES["lkj_inverse"] - mid["lkj_inverse"]  # one a batched leapfrog
    w = model.constrain(v)["w"]
    losses = fit.losses.double().cpu().numpy()
    dev_w = w_dev_in_mcse(w, counts)
    n_div = int(stats.diverging.sum())
    n_trans = P28_NEUTRA["n_chains"] * P28_NEUTRA["n_samples"]
    line = {**P28_NEUTRA, "fit": fit_kw, "seconds": t2 - t0, "fit_s": t1 - t0,
            "ms_per_fit_step": 1e3 * (t1 - t0) / fit_kw["n_steps"], "sample_s": t2 - t1,
            "batched_leapfrogs": leapfrogs, "ms_per_leapfrog": 1e3 * (t2 - t1) / max(leapfrogs, 1),
            "loss_first_50": float(losses[:50].mean()), "loss_last_50": float(losses[-50:].mean()),
            "leapfrogs_per_transition": float(stats.n_steps.float().mean()),
            "divergences": n_div, "max_rhat": float(np.max(diagnostics.rhat(v))),
            "max_w_dev_in_mcse": dev_w, "launches": launches}
    expect(f"path 28 (f): the ELBO's last 50 losses below its first 50 "
           f"({line['loss_last_50']:.3f} < {line['loss_first_50']:.3f})",
           line["loss_last_50"] < line["loss_first_50"])
    expect(f"path 28 (f): draws {tuple(v.shape)} finite",
           tuple(v.shape) == (P28_NEUTRA["n_samples"], CHAINS, 151)
           and bool(torch.isfinite(v).all()))
    expect(f"path 28 (f): w means within 5 MCSE of Dirichlet(1 + counts) (max {dev_w:.2f})",
           dev_w <= 5.0)
    expect(f"path 28 (f): max R-hat {line['max_rhat']:.4f} <= 1.05", line["max_rhat"] <= 1.05)
    expect(f"path 28 (f): divergences {n_div} <= 1% of {n_trans}", n_div <= 0.01 * n_trans)
    if dev.type == "cuda":
        expect(f"path 28 (f): #6, #7 launched ({launches})",
               launches.get("lkj_inverse", 0) > 0
               and sum(launches.get(k, 0) for k in P28_SIMPLEX) > 0)
    return line, launches


def run_engines_and_flows(dev, cells="abcdef", time_gate=True):
    """Path 28 (float32): (a) parallel tempering, (b) the ensemble sampler,
    (c) SBC, (d) the predictive checks (the posterior half from (a)'s
    draws, with (a)), (e) the flows, (f) NeuTra, the cells named in
    `cells`. The launch counters are read around each cell. Returns (the
    `path28` line, the launches)."""
    loglik, counts = hier_loglik_and_counts(dev)
    line, launches, part_s = {}, {}, {}
    t0 = time.perf_counter()

    def add(ls):
        for k, n in ls.items():
            launches[k] = launches.get(k, 0) + n

    for c in cells:
        t = time.perf_counter()
        if c == "a":
            line["a"], ls, samples = run_p28_tempering(dev, loglik, counts)
            line["d_posterior"] = run_p28_posterior_predictive(dev, samples, counts)
            add(ls)
        elif c == "b":
            line["b"], ls = run_p28_ensemble(dev)
            add(ls)
        elif c == "c":
            line["c"], ls = run_p28_sbc(dev)
            add(ls)
        elif c == "d":
            line["d_prior"] = run_p28_prior_predictive(dev)
        elif c == "e":
            line["e"] = run_p28_flows(dev)
        elif c == "f":
            line["f"], ls = run_p28_neutra(dev, loglik, counts)
            add(ls)
        part_s[c] = time.perf_counter() - t
    dt = time.perf_counter() - t0
    line.update({"cells": cells, "seconds": dt, "part_s": part_s, "launches": launches})
    print(f"path 28 ({cells}): {dt:.1f} s (parts {part_s}), launches {launches}", flush=True)
    if time_gate:
        expect(f"path 28 within {PATH28_LIMIT_S:g} s", dt < PATH28_LIMIT_S)
    return line, launches


# --- path 29: serving export and the sharded runners ----------------------------

# The main process's part: (a) and (b), the world-size-1 run of (c) and the
# wait for the ranks; the ranks of (c) and (d) start after the build, beside
# the other paths, since their cell-2-sized NUTS run alone outlasts the
# limit (its host-bound leapfrog, PERF.md section 5)
PATH29_LIMIT_S = 60.0
P29_BM_B = 4096  # (b)'s batch
# (c): the world-size-1 run (NCCL) against the unsharded one, bit for bit,
# short; the two ranks (gloo: NCCL refuses two ranks on one card) at cell
# 2's settings, CHAINS / P29_RANKS chains each
P29_WS1 = dict(n_warmup=30, n_samples=10, max_depth=MAX_DEPTH, target_accept=TARGET_ACCEPT)
P29_RANKS = 2
P29_RANK_FLAG = "--path29-rank"
# (c)'s posterior means against cell 2's: |m - m2| <= P29_MCSE * sqrt(mcse^2
# + mcse2^2) on each of the 151 linked coordinates, and w against
# Dirichlet(1 + counts) within P29_MCSE of its own MCSE, as cell 2's gate
P29_MCSE = 5.0
P29_LINKS = ("lkj_logdet", "lkj_inverse", "simplex_inverse_logdet")


def p29_iid_blocks(dists, dev):
    """(d)'s IID blocks of the bench model's structured leaves, two each:
    the parameter-parallel inverse links (#6; #7 with x)."""
    kw = dict(device=dev, dtype=torch.float32)
    return {"corr": dists.IIDProduct(dists.LKJ(16, 2.0, **kw), P29_RANKS),
            "w": dists.IIDProduct(dists.Dirichlet(np.ones(16), **kw), P29_RANKS)}


def run_p29_export(dev):
    """Path 29 (a) and (b): the bench model's artifacts. (a) the transposed
    density and its value and gradient at B = 131072, exported, saved to
    bytes and loaded: the graph's `tbt::` nodes, one launch of #1 / #2 a
    call of the loaded artifact, its output bit for bit the live one, a
    wrong batch raising, and an export with the kernels disabled raising.
    (b) the batch-major density (#5, #7) and `constrain` (#6, #7: the
    port's `from_linked_vec` forms x with its log-det, so #8, the x-only
    inverse, is not on it) at P29_BM_B likewise. Returns (the line's
    parts, the launches)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels, serving

    model = tbt.Model(bench_model(dists, dev, torch.float32), device=dev)
    v = 0.5 * np.random.default_rng(SEED).standard_normal((BATCH, 151))
    vT = torch.as_tensor(np.ascontiguousarray(v.T), dtype=torch.float32, device=dev)
    vb = torch.as_tensor(v[:P29_BM_B], dtype=torch.float32, device=dev)
    ft, fb = model.batched_logdensity_t_fn(), model.batched_logdensity_fn()
    cases = (
        ("a value", lambda: serving.export_logdensity(model, BATCH, transposed=True), ft, vT,
         ("slab_value",)),
        ("a value_and_grad", lambda: serving.export_logdensity(
            model, BATCH, with_grad=True, transposed=True), ft.value_and_grad_fn, vT,
         ("slab_value_and_grad",)),
        ("b density", lambda: serving.export_logdensity(model, P29_BM_B), fb, vb,
         ("lkj_logdet", SIMPLEX_SMALL)),
        ("b constrain", lambda: serving.export_constrain(model, P29_BM_B), model.constrain, vb,
         ("lkj_inverse", SIMPLEX_SMALL)),
    )
    parts, launches = {}, {}
    for name, export, live_fn, x, keys in cases:
        t = time.perf_counter()
        blob = export()
        fn = serving.load(blob)
        export_s = time.perf_counter() - t
        ops = sorted({str(n.target)[4:-8] for n in fn.exported_program.graph.nodes
                      if str(n.target).startswith("tbt.")})
        expect(f"path 29 ({name}): the artifact's tbt:: nodes {ops} are {sorted(keys)} "
               f"(#7's small design under its own name)",
               ops == sorted(k.replace(SIMPLEX_SMALL, "simplex_inverse_logdet") for k in keys))
        live = live_fn(x)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = fn(x)
        torch.cuda.synchronize()
        ls = {k: n for k, n in kernels.LAUNCHES.items() if n}
        expect(f"path 29 ({name}): one launch of each of {keys} a call ({ls})",
               ls == {k: 1 for k in keys})
        pairs = (list(zip(got, live)) if isinstance(got, tuple)
                 else [(got[k], live[k]) for k in live] if isinstance(got, dict)
                 else [(got, live)])
        equal = all(torch.equal(a, b) for a, b in pairs)
        expect(f"path 29 ({name}): the loaded artifact's output equals the live one bit for bit",
               equal)
        bad = x[:, :-1] if name.startswith("a") else x[:-1]
        try:
            fn(bad.contiguous())
            raised = False
        except ValueError:
            raised = True
        expect(f"path 29 ({name}): the artifact raises on a state of shape "
               f"{tuple(bad.shape)}", raised)
        for k, n in ls.items():
            launches[k] = launches.get(k, 0) + n
        parts[name] = {"bytes": len(blob), "export_s": export_s, "equal": equal,
                       "artifact_ms": time_slow_ms(lambda: fn(x), device_only=False),
                       "live_ms": time_slow_ms(lambda: live_fn(x), device_only=False),
                       "launches": ls}
    kernels.enable(False)
    try:
        serving.export_logdensity(model, BATCH, transposed=True)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    finally:
        kernels.enable(True)
    expect(f"path 29 (a): an export with the kernels disabled raises ({raised[:60]})",
           "disabled" in raised)
    return parts, launches


def p29_sampler_model(dev):
    """Cell 2's model, density and starts: (model, the transposed density,
    its generator (seed SEED) after CHAINS N(0, 1) starts, the starts)."""
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists

    loglik, counts = hier_loglik_and_counts(dev)
    model = tbt.Model(bench_model(dists, dev, torch.float32), loglik=loglik, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return model, model.batched_logdensity_t_fn(), gen, model.init_positions(gen, CHAINS), counts


def run_p29_world_size_one(dev):
    """Path 29 (c) on one rank: chain_parallel_nuts on a one-rank NCCL
    group (`kernel='nuts_batched_t'`) against the unsharded
    warmup_and_sample from the same generator state: draws, step size and
    inverse mass bit for bit."""
    import torch.distributed as dist

    from tpu_bijectors_torch import kernels
    from tpu_bijectors_torch.infer import warmup_and_sample
    from tpu_bijectors_torch.shard import chain_parallel_nuts, make_mesh

    _, f, gen, q0, _ = p29_sampler_model(dev)
    state0 = gen.get_state()
    kw = dict(kernel="nuts_batched_t", **P29_WS1)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            sh = chain_parallel_nuts(f, make_mesh("chain"), gen, q0, **kw)
            torch.cuda.synchronize()
            launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
        finally:
            dist.destroy_process_group()
    gen.set_state(state0)
    ref = warmup_and_sample(f, gen, q0, **kw)
    equal = (torch.equal(sh[0], ref[0]) and torch.equal(sh[1].eps, ref[1].eps)
             and torch.equal(sh[1].inv_mass, ref[1].inv_mass))
    expect("path 29 (c): chain_parallel_nuts on a one-rank NCCL group is the unsharded "
           "warmup_and_sample bit for bit", equal)
    expect(f"path 29 (c): its leapfrogs ran #2's small design ({launches})",
           launches.get(SMALL, 0) > 0)
    return {"equal": equal, "launches": launches}, launches


def start_p29_ranks():
    """Start path 29's ranks of (c) and (d), their store in a temporary
    directory: (processes, the directory)."""
    tmp = tempfile.TemporaryDirectory()
    return [start_child(P29_RANK_FLAG, str(r), tmp.name) for r in range(P29_RANKS)], tmp


def path29_rank(rank, tmp, dev="cuda"):
    """A rank of path 29 (gloo over P29_RANKS processes on the one card):
    (c) chain_parallel_nuts at cell 2's settings on this rank's
    CHAINS / P29_RANKS chains, then (d) `param_parallel_logdensity` on the
    bench prior (the tree layout) and `param_parallel_from_linked` on
    `p29_iid_blocks` at B = 131072 against the unsharded density and
    `from_linked_vec`; prints its checks, then one JSON line with its
    results, launches, seconds and failures."""
    import torch.distributed as dist

    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import diagnostics, dists, kernels
    from tpu_bijectors_torch.kernels import build
    from tpu_bijectors_torch.shard import (
        chain_parallel_nuts,
        gather_chains,
        make_mesh,
        param_parallel_from_linked,
        param_parallel_logdensity,
        shard_chains,
        shard_params,
    )
    from tpu_bijectors_torch.vectorize import unconstrain

    dev = torch.device(dev)
    if dev.type == "cuda":
        build.load()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=P29_RANKS)
    out = {"rank": rank}
    try:
        chains, params = make_mesh("chain"), make_mesh("param")
        # (c)
        model, f, gen, q0, counts = p29_sampler_model(dev)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        raw, state, stats = chain_parallel_nuts(
            f, chains, gen, shard_chains(chains, q0), n_warmup=WARMUP, n_samples=KEPT,
            max_depth=MAX_DEPTH, target_accept=TARGET_ACCEPT, kernel="nuts_batched_t")
        torch.cuda.synchronize()
        out["c_s"] = time.perf_counter() - t
        out["c_launches"] = {k: n for k, n in kernels.LAUNCHES.items() if n}
        out["eps"] = float(state.eps).hex()
        out["inv_mass"] = digest([state.inv_mass])
        out["divergences"] = int(stats.diverging.sum())
        out["leapfrogs_per_transition"] = float(stats.n_steps.float().mean())
        x = model.constrain(raw)
        w, corr = x["w"], x["corr"]
        expect(f"path 29 (c) rank {rank}: simplex sums 1",
               bool(torch.all((w.sum(-1) - 1).abs() < 1e-5)) and bool(torch.all(w >= 0)))
        expect(f"path 29 (c) rank {rank}: the correlation draws' unit diagonals",
               bool(torch.all((torch.diagonal(corr, dim1=-2, dim2=-1) - 1).abs() < 1e-5)))
        expect(f"path 29 (c) rank {rank}: the correlation draws positive definite",
               bool(torch.all(torch.linalg.cholesky_ex(corr.double())[1] == 0)))
        raw_all = gather_chains(chains, raw, dim=1)
        if rank == 0:
            post = (1.0 + counts) / (16.0 + counts.sum())
            w_all = model.constrain(raw_all)["w"]
            dev_w = (np.abs(w_all.double().mean(dim=(0, 1)).cpu().numpy() - post)
                     / diagnostics.mcse_mean(w_all))
            out["max_w_dev_in_mcse"] = float(np.max(dev_w))
            out["max_rhat"] = float(np.max(diagnostics.rhat(raw_all)))
            out["means"] = raw_all.double().mean(dim=(0, 1)).tolist()
            out["mcse"] = np.asarray(diagnostics.mcse_mean(raw_all)).tolist()
            expect(f"path 29 (c): w within {P29_MCSE:g} MCSE of Dirichlet(1 + counts) "
                   f"(max {np.max(dev_w):.2f})", bool(np.all(dev_w <= P29_MCSE)))
        del raw, raw_all, x, w, corr
        # (d)
        t = time.perf_counter()
        u = tbt.Model(bench_model(dists, dev, torch.float32), device=dev).unconstrainer()
        rng = np.random.default_rng(SEED)
        v = torch.as_tensor(0.5 * rng.standard_normal((BATCH, 151)), dtype=torch.float32,
                            device=dev)
        fn = param_parallel_logdensity(u, params)
        v_loc = shard_params(params, fn.layout.pack(v))
        iid = {k: unconstrain(d, device=dev) for k, d in p29_iid_blocks(dists, dev).items()}
        y = {k: torch.as_tensor(0.5 * rng.standard_normal((BATCH, b.linked_vec_length)),
                                dtype=torch.float32, device=dev) for k, b in iid.items()}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        lp = fn(v_loc)
        xs = {k: param_parallel_from_linked(b, params)(shard_params(params, y[k]))
              for k, b in iid.items()}
        torch.cuda.synchronize()
        out["d_launches"] = {k: n for k, n in kernels.LAUNCHES.items() if n}
        owned = fn.layout.assign[params.get_local_rank("param")]
        out["d_owned"] = [list(u.names)[c] for c in owned]
        err = {"lp": check(f"path 29 (d) rank {rank}: the tree's density vs unsharded", lp,
                           u.linked_logdensity(v), RTOL_COMPOSED)}
        n = 1  # this rank's blocks of each IID pair
        for k, b in iid.items():
            x_ref, ld_ref = b.from_linked_vec(y[k])
            x_got, ld_got = xs[k]
            err[f"{k} x"] = check(f"path 29 (d) rank {rank}: {k} x vs unsharded", x_got,
                                  x_ref[:, rank * n:(rank + 1) * n], RTOL_COMPOSED)
            err[f"{k} logdet"] = check(f"path 29 (d) rank {rank}: {k} log-det vs unsharded",
                                       ld_got, ld_ref, RTOL_COMPOSED)
        out["d_s"] = time.perf_counter() - t
        out["d_err"] = err
        ls = out["d_launches"]
        expect(f"path 29 (d) rank {rank}: #6 and #7 launched ({ls})",
               ls.get("lkj_inverse", 0) > 0 and ls.get("simplex_inverse_logdet", 0) > 0)
        expect(f"path 29 (d) rank {rank}: #5 launched where the rank owns corr ({owned})",
               (ls.get("lkj_logdet", 0) > 0) == ("corr" in out["d_owned"]))
    finally:
        dist.destroy_process_group()
    out["failures"] = failures
    print(json.dumps({"child": out}), flush=True)
    return 0


def join_p29_ranks(ranks, cell2):
    """Wait for path 29's ranks and check what crosses them: the adapted
    step size and inverse mass bit for bit equal on every rank, the
    posterior means against cell 2's (`cell2`: its means and MCSE, or
    None) within P29_MCSE combined MCSE. Returns (the ranks' results, the
    launches of (c) and (d) summed over the ranks)."""
    procs, tmp = ranks
    res = [join_child(p, f"path 29 rank {r}") for r, p in enumerate(procs)]
    tmp.cleanup()
    expect(f"path 29 (c): the step size the same on every rank ({[r['eps'] for r in res]})",
           len({r["eps"] for r in res}) == 1)
    expect("path 29 (c): the inverse mass the same on every rank bit for bit",
           len({r["inv_mass"] for r in res}) == 1)
    launches = {}
    for r in res:
        for k, n in list(r["c_launches"].items()) + list(r["d_launches"].items()):
            launches[k] = launches.get(k, 0) + n
    expect(f"path 29 (d): #5, #6 and #7 launched over the ranks ({launches})",
           all(launches.get(k, 0) > 0 for k in P29_LINKS))
    if cell2 is not None:
        m, s = np.asarray(res[0]["means"]), np.asarray(res[0]["mcse"])
        dev_m = np.abs(m - cell2[0]) / np.sqrt(s ** 2 + cell2[1] ** 2)
        res[0]["max_mean_dev_from_cell2_in_mcse"] = float(np.max(dev_m))
        expect(f"path 29 (c): the 151 linked means within {P29_MCSE:g} combined MCSE of cell "
               f"2's (max {np.max(dev_m):.2f})", bool(np.all(dev_m <= P29_MCSE)))
    return res, launches


def run_serving_and_shard(dev, ranks, cell2=None, time_gate=True):
    """Path 29 in the main process: (a) and (b) (`run_p29_export`), (c)'s
    world-size-1 run, then the wait for the ranks (`start_p29_ranks`,
    started earlier) and the checks across them. Returns (the `path29`
    line, the launches)."""
    t0 = time.perf_counter()
    parts, launches = run_p29_export(dev)
    t1 = time.perf_counter()
    ws1, ls = run_p29_world_size_one(dev)
    for k, n in ls.items():
        launches[k] = launches.get(k, 0) + n
    t2 = time.perf_counter()
    res, ls = join_p29_ranks(ranks, cell2)
    for k, n in ls.items():
        launches[k] = launches.get(k, 0) + n
    t3 = time.perf_counter()
    dt = t3 - t0
    line = {"seconds": dt, "part_s": {"ab": t1 - t0, "c_world_size_1": t2 - t1,
                                      "waiting_for_ranks": t3 - t2},
            "ab": parts, "c_world_size_1": ws1, "ranks": res, "launches": launches,
            "ranks_backend": "gloo: NCCL refuses two ranks on one device; one H100 cannot "
                             "check a multi-GPU run"}
    print(f"path 29: {dt:.1f} s (parts {line['part_s']}; ranks (c) "
          f"{[round(r['c_s'], 1) for r in res]} s, (d) {[round(r['d_s'], 1) for r in res]} s), "
          f"launches {launches}", flush=True)
    if time_gate:
        expect(f"path 29 within {PATH29_LIMIT_S:g} s", dt < PATH29_LIMIT_S)
    return line, launches

# The two longest host-bound samplers, cells 7 (pd_conjugate) and 10
# (mv_conjugate), run in a second process beside the other paths: the card
# is idle through most of their host loops, and the script's phases came
# within 17 s of its 1200 s limit on a slow machine with every path in one
# process (PERF.md section 5). Path 28's sampler cells, (a) tempering (with
# (d)'s posterior half) and (f) NeuTra, run in a third: after cells 7 and
# 10 they would make the second process the longest (PERF.md section 6).
# Their draws do not change: each seeds its own generator and
# reads its own launch counts. The kernel timing waits for both.
SAMPLERS_CHILD_FLAG = "--samplers-child"
PATH28_CHILD_FLAG = "--path28-child"
P28_CHILD_CELLS = "af"


def samplers_child():
    """The second process: cells 7 and 10 on the kernels the first built;
    their check lines, then one JSON line with their sampler lines, cell
    7's launches, their seconds and their failures."""
    from tpu_bijectors_torch.kernels import build

    build.load()
    dev = torch.device("cuda")
    t = time.perf_counter()
    pd_line, pd_launches = run_pd_sampler(dev)
    t_pd = time.perf_counter() - t
    mv_line, _ = run_mv_sampler(dev)
    print(json.dumps({"child": {
        "pd": pd_line, "pd_launches": pd_launches, "mv": mv_line, "failures": failures,
        "seconds": {"pd_conjugate": t_pd, "mv_conjugate": time.perf_counter() - t - t_pd}}}),
        flush=True)
    return 0


def path28_child():
    """The third process: path 28's cells P28_CHILD_CELLS on the kernels
    the first built; their check lines, then one JSON line with the path's
    line, its launches and its failures."""
    from tpu_bijectors_torch.kernels import build

    build.load()
    line, launches = run_engines_and_flows(torch.device("cuda"), P28_CHILD_CELLS,
                                           time_gate=False)
    print(json.dumps({"child": {"p28": line, "p28_launches": launches, "failures": failures}}),
          flush=True)
    return 0


CHILDREN = {SAMPLERS_CHILD_FLAG: samplers_child, PATH28_CHILD_FLAG: path28_child}


def start_child(flag, *args):
    """Start the child process `flag` names (with `args`), its output to a
    temporary file."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, *args],
                            stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out


def join_child(child, what):
    """Wait for a child process, print its output and take over its
    failures (tagged `what`); returns its result. Raises when it did not
    end with one."""
    proc, out = child
    rc = proc.wait()
    out.seek(0)
    text = out.read()
    out.close()
    print(text, end="", flush=True)
    last = text.strip().splitlines()[-1] if text.strip() else ""
    if rc != 0 or not last.startswith('{"child"'):
        raise RuntimeError(f"the process of {what} exited {rc} with no result")
    res = json.loads(last)["child"]
    failures.extend(f"{what}: {f}" for f in res["failures"])
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) == 2 and sys.argv[1] in CHILDREN:
        return CHILDREN[sys.argv[1]]()
    if len(sys.argv) == 4 and sys.argv[1] == P29_RANK_FLAG:
        return path29_rank(int(sys.argv[2]), sys.argv[3])
    import tpu_bijectors_torch as tbt
    from tpu_bijectors_torch import dists, kernels
    from tpu_bijectors_torch.kernels import build
    from tpu_bijectors_torch.vectorize import fused_base as fb
    from tpu_bijectors_torch.vectorize import fused_kernel as fk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # wall-clock seconds of each phase, printed as one `phases_s` line
    phases, clock = {}, [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        phases[phase] = now - clock[0]
        clock[0] = now

    ptxas = {}
    so = build.build(ptxas)
    build.load()
    lap("build")
    print(f"build: {so.name} in {phases['build']:.1f} s", flush=True)
    # registers, shared memory and spills of each kernel (-Xptxas=-v); a
    # library already built under build/ is loaded as it is, with no report
    print(json.dumps({"ptxas": ptxas or "not compiled in this run: no report"}), flush=True)
    child = start_child(SAMPLERS_CHILD_FLAG)
    child28 = start_child(PATH28_CHILD_FLAG)
    ranks29 = start_p29_ranks()

    model = tbt.Model(bench_model(dists, dev, torch.float32), device=dev)
    u = model.unconstrainer()
    dim = model.dim()
    expect(f"dim {dim} == 151", dim == 151)
    rng = np.random.default_rng(SEED)
    v = 0.5 * rng.standard_normal((BATCH, dim))
    vT = torch.as_tensor(np.ascontiguousarray(v.T), dtype=torch.float32, device=dev)
    f = model.batched_logdensity_t_fn()

    # --- the main path: value, value-and-gradient, autograd ------------------
    kernels.reset_launch_counts()
    for _ in range(3):
        lp = f(vT)
    for _ in range(3):
        lp_vg, g_vg = f.value_and_grad_fn(vT)
    vr = vT.detach().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(u.linked_logdensity_t(vr).sum(), vr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the main path: {launches}", flush=True)
    for k in SLAB_KERNELS:
        expect(f"{k} launched on the main path", launches[k] > 0)
    expect(f"{SMALL} not launched on the main path (B = {BATCH})", launches[SMALL] == 0)
    expect("lp shape (B,)", lp.shape == (BATCH,) and lp_vg.shape == (BATCH,))
    expect("g shape (dim, B)", g_vg.shape == (dim, BATCH) and g_ag.shape == (dim, BATCH))

    # --- value ---------------------------------------------------------------
    cf, _, c0sum = fk._prep(u, vT)
    val_plain = fb.slab_value_plain(vT, cf)
    scale = val_plain.abs() + c0sum.abs()
    err = {}
    err["slab_value"] = check(
        "value kernel vs plain", fk.slab_value(vT, cf), val_plain, RTOL_LP, scale
    )
    check("linked_logdensity_t vs plain fused", lp, val_plain + c0sum, RTOL_LP, scale)
    composed = u._linked_logdensity_t_children(vT)
    check("linked_logdensity_t vs composed", lp, composed, RTOL_COMPOSED, scale)
    model64 = tbt.Model(bench_model(dists, dev, torch.float64), device=dev)
    vT64 = vT.double()
    cf64, _, c0sum64 = fk._prep(model64.unconstrainer(), vT64)
    lp64 = fb.slab_value_plain(vT64, cf64) + c0sum64
    check("linked_logdensity_t vs plain float64", lp, lp64, RTOL_LP, scale)
    del composed, vT64, lp64

    # --- value and gradient --------------------------------------------------
    lp_p, g_p = fb.slab_value_and_grad_plain(vT, cf)
    lp_k, g_k = fk.slab_value_and_grad(vT, cf)
    err["slab_value_and_grad"] = max(
        check("value-and-grad kernel lp vs plain", lp_k, lp_p, RTOL_LP, scale),
        check("value-and-grad kernel g vs plain", g_k, g_p, RTOL_G),
    )
    check("value_and_grad_fn lp vs plain", lp_vg, lp_p + c0sum, RTOL_LP, scale)
    check("value_and_grad_fn g vs plain", g_vg, g_p, RTOL_G)

    # --- autograd ------------------------------------------------------------
    ones = torch.ones(BATCH, device=dev)
    g_vjp_plain = fb.slab_vjp_plain(vT, cf, ones)
    err["slab_vjp"] = check(
        "vjp kernel vs plain", fk.slab_vjp(vT, cf, ones), g_vjp_plain, RTOL_G
    )
    check("autograd g vs value_and_grad_fn g", g_ag, g_vg, RTOL_G)
    check("autograd g vs plain partials", g_ag, g_p, RTOL_G)
    del lp_p, g_p, lp_k, g_k, g_vjp_plain, g_ag, g_vg

    # --- extreme states ------------------------------------------------------
    vx = 1e10 * rng.standard_normal((4096, dim))
    vx[::7] = np.sign(vx[::7]) * 1e10
    vxT = torch.as_tensor(np.ascontiguousarray(vx.T), dtype=torch.float32, device=dev)
    lpx = f(vxT)
    lpx_vg, gx = f.value_and_grad_fn(vxT)
    expect("lp finite at 1e10 states", bool(torch.isfinite(lpx).all()))
    expect("value_and_grad lp finite at 1e10", bool(torch.isfinite(lpx_vg).all()))
    expect("g finite at 1e10 states", bool(torch.isfinite(gx).all()))
    cfx, _, c0x = fk._prep(u, vxT)
    lpx_p, gx_p = fb.slab_value_and_grad_plain(vxT, cfx)
    check("1e10: lp vs plain", lpx, lpx_p + c0x, RTOL_LP, lpx_p.abs() + c0x.abs())
    check("1e10: Dirichlet and LKJ rows of g vs plain", gx[16:], gx_p[16:], RTOL_G)
    check("1e10: Normal and LogNormal rows of g vs plain", gx[:16], gx_p[:16], RTOL_G)
    lap("transposed serving and its checks")

    # --- the inverse-link kernels, their entry points, the likelihood --------
    loglik, counts = hier_loglik_and_counts(dev)
    err.update(check_link_kernels(dev, vT, vxT, counts))
    check_link_entry_points(dev, vT, loglik, counts)
    lap("link kernel checks")
    for k, e in check_simplex_designs(dev, vT, vxT).items():
        err[k] = max(err.get(k, 0.0), e)
    lap("simplex design checks")

    # --- the second main path: NUTS with the likelihood ----------------------
    sampler_line, sampler_launches, sampler_raw = run_sampler(dev, loglik, counts,
                                                              "nuts_batched_t")
    launches.update({k: sampler_launches[k] for k in (SIMPLEX_SMALL, "lkj_inverse")})
    lap("nuts_batched_t sampler")

    # --- the third: the batch-major entry points -------------------------------
    xT = simplex_points_T(vT)
    xfaces = face_points(rng, 4096)
    err.update(check_batch_major_kernels(dev, vT, xT, vxT, xfaces))
    lap("batch-major kernel checks")
    logdet_err = check_link_logdets(dev, vT, xT, vxT, xfaces)
    for k in ("lkj_logdet", "simplex_forward_logdet"):
        err[k] = max(err[k], logdet_err[k])
    lap("link log-det checks")
    bm_launches, bm_e2e = run_batch_major_serving(dev, vT, scale, loglik)
    launches.update({k: bm_launches[k] for k in BATCH_MAJOR_KERNELS})
    launches["simplex_inverse_logdet"] = bm_launches["simplex_inverse_logdet"]  # B = 131072
    lap("batch-major serving and its checks")

    # --- the fourth: batch-major NUTS with the likelihood ----------------------
    bm_sampler_line, _, _ = run_sampler(dev, loglik, counts, "nuts_batched")
    lap("nuts_batched sampler")

    # --- the Wishart families: the PD kernels and the PD entry ---------------
    err.update(check_pd_kernels(dev, vT, vxT))
    err["pd_trace_grad"] = max(err["pd_trace_grad"], check_pd_trace_grad(dev, vT))
    err["pd_logdensity"] = max(err["pd_logdensity"], check_pd_logdensity(dev, vT))
    for fam in PD_MODES:
        for S in (None, random_spd(3)):
            check_pd_entry(dev, vT, fam, S)
    lap("PD kernel checks")
    # --- the fifth: transposed serving of pdonly and its solve-mode twin -----
    pd_t, pd_e2e = {}, {}
    for fam in PD_MODES:
        _, lp_f, g_f, e = run_pd_transposed_serving(dev, vT, fam)
        pd_t[fam] = (lp_f, g_f)
        pd_e2e.update(e)
    lap("PD transposed serving")
    # --- the sixth: batch-major serving of the same models ---------------------
    for k in ("pd_logdensity", "pd_trace_grad"):
        launches[k] = 0
    for fam in PD_MODES:
        pd_launches, e = run_pd_batch_major_serving(dev, vT, fam, *pd_t[fam])
        for k in ("pd_logdensity", "pd_trace_grad"):
            launches[k] += pd_launches[k]
        pd_e2e.update(e)
    del pd_t
    lap("PD batch-major serving")
    # --- the seventh: NUTS on the conjugate Wishart model (pd_conjugate) -----
    # runs in the second process (`samplers_child`)

    # --- the eighth: transposed serving of mvdense, all four modes ------------
    # the tangent of the forward-mode checks: N(0, 1), numpy seed 3
    dvT = torch.as_tensor(np.random.default_rng(3).standard_normal((dim, BATCH)),
                          dtype=torch.float32, device=dev)
    mv_launches, lp_mv, g_mv, mv_e2e, mv_err = run_mv_transposed_serving(dev, vT, dvT)
    launches["slab_jvp"] = mv_launches["slab_jvp"]
    err["slab_jvp"] = mv_err["slab_jvp"]
    lap("mvdense transposed serving")
    # --- the ninth: batch-major serving of mvdense (no kernel) -----------------
    mv_e2e.update(run_mv_batch_major_serving(dev, vT, lp_mv, g_mv))
    del lp_mv, g_mv
    lap("mvdense batch-major serving")
    # --- the tenth: NUTS on mvdense with a conjugate likelihood (mv_conjugate) -
    # runs in the second process (`samplers_child`)
    # --- the eleventh: the repairs (wide, pdwide, LKJ(64)); #4 on the models --
    # of the earlier slices
    repair_variants = {**check_wide(dev), **check_pdwide(dev), **check_lkj64(dev)}
    err["slab_jvp"] = max(err["slab_jvp"], check_jvp_earlier(dev, vT))
    lap("repair checks and #4 on the earlier models")

    # --- the twelfth: transposed serving of families, all four modes ----------
    (_, fam_vT, fam_dvT, lp_fam, g_fam, fam_err, fam_e2e,
     fam_prep) = run_families_transposed_serving(dev)
    for k, e in fam_err.items():
        err[k] = max(err[k], e)
    lap("families transposed serving")
    # --- the thirteenth: batch-major serving of families ---------------------
    fam_bm_launches, fam_bm_e2e, err["lkj_logdet_chol"] = run_families_batch_major_serving(
        dev, fam_vT, lp_fam, g_fam)
    err["lkj_logdet_chol"] = max(err["lkj_logdet_chol"], logdet_err["lkj_logdet_chol"])
    launches["lkj_logdet_chol"] = fam_bm_launches["lkj_logdet_chol"]
    fam_e2e.update(fam_bm_e2e)
    del lp_fam, g_fam
    lap("families batch-major serving")
    # --- the fourteenth: NUTS on eight schools --------------------------------
    es_line = run_eight_schools(dev)
    lap("eight_schools sampler")
    # --- the fifteenth: the probe of the slab math (#13) -----------------------
    probe_launches, _, err["transcend_probe"], probe_in = run_probe(dev)
    launches["transcend_probe"] = probe_launches["transcend_probe"]
    lap("transcend probe")
    # --- the sixteenth: transposed serving of the traced models ---------------
    tr_launches, tr_preps, tr_err, tr_e2e = run_traced_serving(dev)
    launches["slab_traced"] = tr_launches["slab_traced"]
    for k, e in tr_err.items():
        err[k] = max(err.get(k, 0.0), e)
    lap("traced serving")
    # --- the seventeenth: NUTS on the generic-traced prior ---------------------
    tr_sampler_line = run_traced_sampler(dev)
    lap("traced sampler")
    # --- the eighteenth: the per-opcode probe of the interpreter (#14) ---------
    pp_launches, _, err["prim_probe"] = run_prim_probe(dev)
    launches["prim_probe"] = pp_launches["prim_probe"]
    lap("prim probe")
    # --- the nineteenth to twenty-second: ChEES with the dense metric, dense --
    # NUTS through a checkpoint, SMC and ADVI (each path's own launches)
    new_lines, new_launches = [], {}
    for run, phase in ((run_chees_dense, "chees_dense"),
                       (run_eight_schools_dense, "eight_schools_dense"),
                       (run_smc_eight_schools, "smc_eight_schools"),
                       (run_advi_mv, "advi_mv_conjugate")):
        line, ls = run(dev)
        new_lines.append(line)
        for k, n in ls.items():
            new_launches[k] = new_launches.get(k, 0) + n
        lap(phase)
    # --- the twenty-third and twenty-fourth: MAP + Laplace with the ----------
    # evidence estimators, Pathfinder, and NUTS from Pathfinder's starts
    ml_line, ls = run_map_laplace(dev, loglik, sampler_raw)
    # cell 2's linked means and their MCSE, for path 29 (c)'s two ranks
    from tpu_bijectors_torch import diagnostics

    cell2 = (sampler_raw.double().mean(dim=(0, 1)).cpu().numpy(),
             np.asarray(diagnostics.mcse_mean(sampler_raw)))
    del sampler_raw
    lap("map_laplace")
    pf_line, ls2 = run_pathfinder(dev, loglik)
    lap("pathfinder")
    pf_sampler_line, ls3, _ = run_sampler(dev, loglik, counts, "auto", init="pathfinder")
    lap("nuts_batched_t from pathfinder")
    # --- the twenty-fifth: forward mode, parameter tangents, the flat-vector --
    # API, the samplers and the property sweep
    p25_line, p25_launches, p25_err = run_flat_api_and_tangents(dev)
    lap("flat API, tangents, samplers, sweep")
    # --- the twenty-sixth: the remaining bijectors, CDF/Quantile ----------------
    p26_line, p26_launches, p26_err = run_bijectors_and_quantiles(dev)
    lap("bijectors and quantiles")
    # --- the twenty-seventh: the remaining distribution families ------------
    p27_line, p27_launches, p27_err, p27_prep = run_remaining_families(dev)
    for k, e in p27_err.items():
        err[k] = max(err.get(k, 0.0), e)
    lap("remaining families")
    # --- the twenty-eighth: the engines that need no flows, the flows and ---
    # NeuTra; (a) and (f) run in the third process (P28_CHILD_CELLS)
    p28_line, p28_launches = run_engines_and_flows(dev, "bcde", time_gate=False)
    lap("engines and flows")
    # --- the twenty-ninth: serving export and the sharded runners; (c)'s ----
    # two ranks and (d) run in their own processes, started after the build
    p29_line, p29_launches = run_serving_and_shard(dev, ranks29, cell2)
    lap("serving and shard")
    print(f"nuts from pathfinder's starts: warmup {pf_sampler_line['warmup_s']:.1f} s (the fit "
          f"included), step {pf_sampler_line['step_size']:.4f}, "
          f"{pf_sampler_line['leapfrogs_per_transition']:.2f} leapfrogs a transition; path 2: "
          f"{sampler_line['warmup_s']:.1f} s, {sampler_line['step_size']:.4f}, "
          f"{sampler_line['leapfrogs_per_transition']:.2f}", flush=True)
    for k in (SMALL, SIMPLEX_SMALL, "simplex_inverse_logdet", "lkj_inverse", "pd_inverse",
              "pd_logdensity", "pd_trace_grad"):
        new_launches[k] = new_launches.get(k, 0) + sum(d.get(k, 0) for d in (ls, ls2, ls3))
    for k, n in (list(p25_launches.items()) + list(p26_launches.items())
                 + list(p27_launches.items()) + list(p28_launches.items())
                 + list(p29_launches.items())):
        new_launches[k] = new_launches.get(k, 0) + n
    prep_s = time_prep(dev)
    lap("_prep first calls")
    # --- #2's small design on every model the paths drive ---------------------
    err[SMALL], small_preps = check_small_design(dev)
    launches[SMALL] = sampler_launches[SMALL]  # cell 2's leapfrogs
    for k, n in new_launches.items():  # and paths 19-22's
        launches[k] += n
    lap("small-design checks")
    err["slab_value"] = max(err["slab_value"], check_run_walk(dev))
    lap("run-walk checks")

    # --- cells 7 and 10 and path 28 (a), (f), from the other processes -------
    res = join_child(child, "cells 7/10")
    pd_sampler_line, mv_sampler_line = res["pd"], res["mv"]
    launches["pd_inverse"] += res["pd_launches"]["pd_inverse"]
    lap("waiting for cells 7 and 10")
    print(json.dumps({"second_process_s": res["seconds"]}), flush=True)
    res28 = join_child(child28, f"path 28 ({P28_CHILD_CELLS})")
    for k, n in res28["p28_launches"].items():
        launches[k] += n
    lap("waiting for path 28 (a), (f)")
    neutra = res28["p28"]["f"]
    print(f"path 28 (f) NeuTra: {neutra['leapfrogs_per_transition']:.2f} leapfrogs a "
          f"transition a chain; cell 4 (nuts_batched, the same model unwarped): "
          f"{bm_sampler_line['leapfrogs_per_transition']:.2f}", flush=True)

    # --- timing ----------------------------------------------------------------
    # the variants the paths also run: the LKJ inverse writing W for the
    # backward (the leapfrog's case), the LKJ log-det's Cholesky form, and
    # the kernels each batched leapfrog launches at the samplers' 64 chains
    # in their layout (the swapped view; #2 on the (151, 64) state)
    from tpu_bijectors_torch.kernels import lkj as kl
    from tpu_bijectors_torch.kernels import pd as kp
    from tpu_bijectors_torch.kernels import simplex as ks

    yc = vT[C_ROWS].T
    variants = {
        "lkj_inverse with W (swapped)": (
            lambda: kl.lkj_inverse(yc, 16, want_w=True), BATCH * 4 * (120 + 256 + 1 + 16 + 256),
            BATCH * (120 * OPS_LKJ_SLOT + 2 * 816),
            lambda: kl.lkj_inverse_plain(yc, 16, want_w=True)),
        "lkj_logdet chol=True (swapped)": lambda: kl.lkj_logdet(yc, 16, True),
    }
    n = CHAINS
    yc64, yp64, yw64 = vT[C_ROWS, :n].T, vT[PD_ROWS, :n].T, vT[W_ROWS, :n].T
    variants.update({
        "lkj_inverse (swapped, B = 64)": (
            lambda: kl.lkj_inverse(yc64, 16), n * 4 * (120 + 256 + 1 + 16),
            n * (120 * OPS_LKJ_SLOT + 2 * 816), lambda: kl.lkj_inverse_plain(yc64, 16)),
        "lkj_inverse with W (swapped, B = 64)": (
            lambda: kl.lkj_inverse(yc64, 16, want_w=True), n * 4 * (120 + 256 + 1 + 16 + 256),
            n * (120 * OPS_LKJ_SLOT + 2 * 816),
            lambda: kl.lkj_inverse_plain(yc64, 16, want_w=True)),
        "pd_inverse (swapped, B = 64)": (
            lambda: kp.pd_inverse(yp64, PD_K), n * 4 * (136 + 256 + 1 + 256),
            n * PD_OPS["inverse"], lambda: kp.pd_inverse_plain(yp64, PD_K)),
    })
    # #7 in both designs at the samplers' 64 chains and at B = 131072, and
    # #12 in both modes at 64 (the solve mode at 131072: pd_variants)
    yw = vT[W_ROWS].T
    for y in (yw64, yw):
        B = y.shape[0]
        for design in ks.DESIGNS:
            variants[f"simplex_inverse_logdet {design} design (swapped, B = {B})"] = (
                lambda y=y, d=design: ks.simplex_inverse_logdet(y, design=d),
                B * 4 * (15 + 16 + 1), B * 15 * OPS_SIMPLEX_COORD,
                lambda y=y: ks.simplex_inverse_logdet_plain(y))
    yp64b = layouts(vT, PD_ROWS, n, "batch-major slice")["batch-major slice"]
    eye = torch.eye(PD_K, device=dev)
    for mode in PD_MODES.values():
        variants[f"pd_trace_grad {mode} (batch-major slice, B = 64)"] = (
            lambda m=mode: kp.pd_trace_grad(yp64b, PD_K, eye, m),
            n * 4 * (136 + 136) + eye.numel() * 4, n * PD_OPS[f"{mode}_grad"],
            lambda m=mode: kp.pd_trace_grad_plain(yp64b, PD_K, eye, m))
        # #11 at a sampler's batch, in the batch-major slice and the swapped view
        for lay, y in (("batch-major slice", yp64b), ("swapped", yp64)):
            variants[f"pd_logdensity {mode} ({lay}, B = 64)"] = (
                lambda m=mode, y=y: kp.pd_logdensity(y, PD_K, eye, m),
                n * 4 * (136 + 3) + eye.numel() * 4, n * PD_OPS[mode],
                lambda m=mode, y=y: kp.pd_logdensity_plain(y, PD_K, eye, m))
    # #5 (both variants) and #9 at 64 elements in each layout (at B = 131072:
    # their kernel_table rows)
    lc_rows = slice(FAM_LC_ROW0, FAM_LC_ROW0 + 10)
    for lay, y in layouts(vT, C_ROWS, n, "batch-major slice").items():
        variants[f"lkj_logdet ({lay}, B = 64)"] = (
            lambda y=y: kl.lkj_logdet(y, 16), n * 4 * (120 + 1 + 16),
            n * 120 * OPS_LKJ_LOGDET_SLOT, lambda y=y: kl.lkj_logdet_plain(y, 16))
    for lay, y in layouts(fam_vT, lc_rows, n, "batch-major slice").items():
        variants[f"lkj_logdet_chol ({lay}, B = 64)"] = (
            lambda y=y: kl.lkj_logdet(y, 5, True), n * 4 * (10 + 1 + 5),
            n * 10 * OPS_LKJ_LOGDET_SLOT, lambda y=y: kl.lkj_logdet_plain(y, 5, True))
    for lay, x in layouts(xT, X_ROWS, n, "contiguous").items():
        variants[f"simplex_forward_logdet ({lay}, B = 64)"] = (
            lambda x=x: ks.simplex_forward_logdet(x), n * 4 * (15 + 15 + 1),
            n * 15 * OPS_SIMPLEX_FWD_COORD, lambda x=x: ks.simplex_forward_logdet_plain(x))
    # #2 at the samplers' 64 chains in both designs on every sampler cell's
    # model (the traced kind: cell 17's generic-traced), and the launch floor
    variants.update(small_design_variants(small_preps))
    # a yardstick, not the same function (X = LL' from #10's own L alone, as
    # cuBLAS forms it): never a library_ms
    L_pd = kp.pd_inverse(vT[PD_ROWS].T, PD_K)[2]
    variants["yardstick: torch.bmm(L, L.mT) on pd_inverse's L (B = 131072)"] = (
        lambda: torch.bmm(L_pd, L_pd.mT))
    pd_preps = {}
    for fam in PD_MODES:
        pd_u = tbt.Model(pd_model(dists, dev, torch.float32, fam), device=dev).unconstrainer()
        pd_preps[fam] = fk._prep(pd_u, vT)[:2]
    variants.update(pd_variants(vT, dvT, pd_preps))
    mv_u = tbt.Model(mvdense_model(dists, dev, torch.float32)[0], device=dev).unconstrainer()
    variants.update(mv_variants(vT, dvT, *fk._prep(mv_u, vT)[:2]))
    variants.update(repair_variants)
    variants.update(families_variants(fam_vT, fam_dvT, *fam_prep))
    variants.update(traced_variants(tr_preps))
    variants.update(traced_variants({"remaining-served": p27_prep}))
    variants.update(engine_variants(dev, vT))
    rows = time_kernels(kernel_table(vT, xT, cf, ones, dvT, fam_vT, probe_in,
                                     tr_preps["generic-traced"]), launches, err, variants)
    lap("kernel timing")
    small_b_sweep(dev, vT)
    simplex_small_b_sweep(vT)
    lap("small-batch sweeps")

    # the entry points as a caller sees them: host dispatch included, at the
    # full batch and at a sampler's batch of 64 chains
    v64 = vT[:, :64].contiguous()
    e2e = {
        "value_ms_B131072": time_ms(lambda: f(vT), device_only=False),
        "value_and_grad_ms_B131072": time_ms(
            lambda: f.value_and_grad_fn(vT), device_only=False
        ),
        "value_ms_B64": time_ms(lambda: f(v64), device_only=False),
        "value_and_grad_ms_B64": time_ms(
            lambda: f.value_and_grad_fn(v64), device_only=False
        ),
    }
    e2e.update(bm_e2e)
    e2e.update(pd_e2e)
    e2e.update(mv_e2e)
    e2e.update(fam_e2e)
    e2e.update(tr_e2e)
    e2e.update({f"prep_{k}": v for k, v in prep_s.items()})
    lap("entry-point timing")
    print(json.dumps({"end_to_end": e2e}), flush=True)
    print(json.dumps({"phases_s": phases}), flush=True)
    print(json.dumps({"sampler": sampler_line}), flush=True)
    print(json.dumps({"sampler": bm_sampler_line}), flush=True)
    print(json.dumps({"sampler": pd_sampler_line}), flush=True)
    print(json.dumps({"sampler": mv_sampler_line}), flush=True)
    print(json.dumps({"sampler": es_line}), flush=True)
    print(json.dumps({"sampler": tr_sampler_line}), flush=True)
    for line in new_lines:
        print(json.dumps({"sampler": line}), flush=True)
    print(json.dumps({"map_laplace": ml_line}), flush=True)
    print(json.dumps({"pathfinder": pf_line}), flush=True)
    print(json.dumps({"sampler": pf_sampler_line}), flush=True)
    print(json.dumps({"path25": p25_line, "path25_err": p25_err}), flush=True)
    print(json.dumps({"path26": p26_line, "path26_err": p26_err}), flush=True)
    print(json.dumps({"path27": p27_line, "path27_err": p27_err}), flush=True)
    print(json.dumps({"path28": p28_line, "path28_third_process": res28["p28"]}), flush=True)
    print(json.dumps({"path29": p29_line}), flush=True)

    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of magi_v2_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the last line below is printed
only when all of them passed):

1. Device: requires CUDA; prints the card's name and power limit as
   nvidia-smi reports them, and the torch and CUDA versions.
2. Build: compiles the hand-written kernels (csrc/*.cu, one nvcc process
   per source, in parallel, sm_90a).
3. Kernels vs plain: each K1 kernel, launched as the sampler's target
   launches it (``ManifoldPlan``: arguments checked once, fixed buffers)
   and through its one-shot wrapper, against its plain PyTorch version on
   the same inputs at the SEIR bench shapes (256 chains, N_I = 161, D = 3)
   and at a chain count and grid that fill no tile (37 chains, N_I = 333);
   two runs of one launch must agree bit for bit; the same for the
   functors of the six other registered fields (SIRW, FitzHugh-Nagumo,
   Hes1, Hes1-log, Lotka-Volterra, protein transduction) at 37 chains and
   N_I = 333 and at the Hes1 path's 64 chains and N_I = 129. K2 (the
   leapfrog update, one launch per leapfrog on every mass form) on the
   full dense metric of the SEIR recipe (489 wide) and on a diagonal and
   dense tails of 3 and 8
   at the Lorenz width (3081), at 64, 256 and 257 chains, the replayed
   leapfrog's launch and the kinetic launches, each run twice; K2's full
   dense metric at the widths its earlier design refused (float64 1297,
   1545 and 3081, float32 3105, at 64 and 257 chains); K2's NUTS form (a
   signed step per chain, a mask with a NaN force in a masked chain, the
   velocities out), which opens a doubling's first leaf, at 64, 256 and
   257 chains; the NUTS leaf kernel (a leaf's close, epilogue, counter and
   next opening in one launch) on the dense 489 metric, a 3081 diagonal
   and a tail of 8 at 3081, at 64, 256 and 257 chains, at an odd, an even
   and a one-leaf doubling's leaf, each launch twice, masked chains
   untouched; K2's NUTS form and the leaf kernel also on the Hes1 path's
   397-wide diagonal at 64 chains. K1's fwd in its whitened form (t1 =
   ||z||^2 from dz and z0, the seed -(beta_T/beta) z; R delta's half of
   RmD set to NaN, unread) as the whitened target launches it and through
   its one-shot wrapper, at the SEIR shapes, at 37 chains and N_I = 333,
   and in the given kernels (FitzHugh-Nagumo, 16 chains, N_I = 81), each
   launch twice bit for bit, float32 within 5e-7 and float64 within 1e-14
   of each output's scale. K1 with a temperature per chain (parallel
   tempering: the launches of stride 1), drawn in (0.1, 1]: fwd, its
   whitened form, energy and bwd, through the plan and the one-shot
   wrappers, at SEIR's 256 chains and N_I = 161, the Hes1 PT path's 80
   chains and N_I = 129, and 37 chains at N_I = 333 with a functor and
   with the given kernels, each launch twice bit for bit, every chain at
   one temperature giving the stride-0 launch's bits, within the same 5e-7
   and 1e-14; timed beside the stride-0 launch. K6, the swap kernel,
   against its plain version at 5 rungs x 16 replicas x 397 (the Hes1 PT
   path), 4 x 64 x 489 and 3 x 7 x 3081 (rows that share no 16-byte
   alignment), both parities, one lp NaN, uniforms held away from ties:
   q, lp and the counters equal. Float32 and float64, timed with CUDA
   events.
3b. The pairwise Matern build on a non-uniform float64 grid of 1100
   points: the direct build against the row tiles ``ops/kernels.py``
   takes from 1024 points up, within 1e-12 of each output's scale; peak
   memory and time of each printed.
4. SEIR path: SEIR data (t_max 4, 81 observations), ``initial_fit`` and a
   256-chain, L = 192, dense-metric HMC ``predict`` (1000 + 1000 steps) in
   float32 on the card. Fails on non-finite draws, a kernel that never
   launched, a transition that replayed no captured leapfrog, rhat_max >
   1.05, or a theta mean more than 15% from truth. The predict's phases
   print with the sampling setup split into its parts.
5. The composed float64 SEIR target on the card against the same target on
   the CPU (plain versions), for 8 states near the fit.
6. Leapfrog profile of the SEIR path: ms per leapfrog of the sampler's
   bound transition (replayed CUDA graphs) and of the eager transition
   with the kernels and with their plain versions swapped in, host time of
   one graph replay and of each bound call of the target (the K1 launches,
   the stages around them), and torch.profiler's device time by kernel
   and device busy share over one replayed and one eager transition; then
   20 transitions by graph and by eager from the same state and noise,
   compared. Then 20 parallel-tempering HMC transitions (4 rungs x 64
   replicas, each chain at its rung's beta and step, a swap round after
   each) by the bound transition and the swap graph and by their eager
   forms, bit for bit.
6b. SEIR NUTS path: the same fit, ``predict`` with the default algorithm
   (NUTS, trees up to depth 10) and otherwise the bench recipe, 256
   chains, 200 + 200 transitions, float32. Fails on non-finite draws, a
   kernel that never launched (K1, K2, the leaf kernel), a transition
   that replayed no leaf, leaves that launched K2, rhat_max > 1.05 or a theta mean more than 15% from truth; prints
   the mean depth, leaves a chain and leaves replayed a transition (the
   masked lockstep's share), divergences, ESS and the phases. Then 20
   NUTS transitions by replayed graphs and by the eager form from the same
   state and noise, which must agree bit for bit; a profile of one leaf
   (which must launch the leaf kernel once beside its evaluation, and no
   K2 or other op) and one transition (device time by kernel, busy
   share), and the share of leaf replays in which no chain was active.
   Then the whitened SEIR path on the same fit: ``predict(reparam=
   "whitened")`` with the NUTS recipe, 256 chains, 100 + 100 transitions,
   float32, dense storage; fails on non-finite draws, K1's fwd launched in
   its GN form or never in its whitened form (counted as
   "manifold_fwd_whitened_seir"), a transition that replayed no leaf, or a
   theta mean more than 15% from truth (rhat, ESS, depth, step printed
   only); its composed float64 target card vs CPU, 20 NUTS transitions by
   graph and by eager (bit for bit) and the leaf's profile. Then
   ``map_warmstart_iters`` on the SEIR fit (precond, dense): 200 Adam
   steps whose log-posterior must rise, and a short predict that takes
   them. Then the SEIR L-BFGS and forecast block: ``initial_fit(1)`` with
   ``MagiConfig(hparam_optimizer="lbfgs")`` on the same data (its
   hparam_mle wall printed beside the Adam fit's, with L-BFGS's
   iterations, both objectives and the fitted phi and sigma^2; fails
   unless its objective is at most Adam's + 1e-3 and theta_init is
   finite); the NUTS recipe on it, 256 chains, 150 + 150;
   ``extend_for_forecast(5.0, results=...)`` (N_I = 161 -> 201, a dense
   metric 609 wide), K1 at N_I = 201 and K2's NUTS form and the leaf
   kernel at dense 609 against their plain versions (each launch twice
   bit for bit), and the recipe on the extended grid, 256 chains, 200 +
   200: fails on non-finite draws, K1 or the leaf kernel not launched,
   rhat_max > 1.05 or a theta mean more than 15% from truth; prints the
   forecast's posterior-mean RMSE and 95% band coverage of the true
   trajectory on (4, 5]. Then checkpoint/resume on the extended model (64
   chains, 100 + 100, blocks of 25 transitions): an uninterrupted run with
   ``profile_timings`` (its timings printed), a run crashed after two
   sampling blocks and one crashed after two warmup blocks, each resumed,
   which must equal the uninterrupted run bit for bit; and a 5 + 5
   predict inside ``utils.profiling.device_trace``, whose trace must name
   K1's three kernels. And an ODE
   field with no CUDA functor (FitzHugh-Nagumo, defined here): K1's given
   kernels (PyTorch evaluates the field and its VJPs) against their plain
   versions at its path's shapes (16 chains, N_I = 81) and at 257 chains
   and N_I = 333, then its composed target and HMC and NUTS predicts on
   the card (16 chains, 100 + 100 steps; 200 + 200 before the Hes1 path
   joined the smoke), which must launch K1, held against the CPU's. Then
   tests/test_pt.py's bimodal harness on the card (weight 0.8, 4 rungs x
   8 replicas, HMC, 600 + 3000): the beta = 1 rung's right-mode share must
   lie in (0.6, 0.95), every pair's swap acceptance exceed 0.05, and K6
   launch once a sampling transition.
6f. Chain sharding on the SEIR HMC recipe over two shards of the card
   (``parallel.chain_mesh([cuda:0, cuda:0])``, predict's sampler call
   routed through ``parallel.run_chains_sharded``): float64, 64 chains,
   20 + 20, must equal the one-shard run to 1e-10 of the draws' scale;
   float32, 256 chains, 100 + 100, must launch K1 and K2 and keep theta
   within 15% of truth, its wall printed beside the one-shard run's. Then
   ``hmc_jitter=False`` on the recipe (64 chains, 10 + 10): every
   transition must take exactly 192 leapfrogs.
6c. Hes1 path (partially observed: H never observed): the data of
   examples/hes1.py, ``initial_fit(2)`` at the config's full iteration
   counts (N_I = 129, gradient matching for H and theta), beta = 1, and a
   64-chain centered NUTS predict (150 + 150 transitions since the
   refresh and sharding phases joined the smoke, 300 + 300, 500 + 500 and
   1000 + 1000 before; no
   annealing,
   sigma pinned at 0.15^2, diagonal mass) in float32. Fails on non-finite
   draws, K1 not launched through the Hes1-log functor or launched
   through its given kernels, K2 or the leaf kernel not launched, a
   transition that replayed no leaf, a chain whose mean theta[5] is at
   most 8 (out of the truth basin), or a pooled theta mean more than 3
   posterior sd from the JAX package's recovery (results/hes1_long2.json);
   rhat, ESS, depth and leaves are printed. Then the composed float64
   centered target on the card against the CPU (8 states), 20 NUTS
   transitions from the predict's last states by replayed graphs and by
   eager (bit for bit) and the device profile of one transition. H's 95%
   band coverage of the true H is printed.
6d. Hes1 with Laplace starts, on the same fit: the per-evaluation
   unwhitening of map_estimate's "gn" objective timed both ways (dense
   solve_triangular, K4 at one chain), float64; then
   ``map_estimate(sigma_sqs_fixed=0.15^2, laplace_draws=64)`` and a
   64-chain centered NUTS predict from its joint draws
   (``init_states``), 150 + 150 transitions, the Hes1 recipe otherwise
   (scripts/hes1_long.py --init laplace, cut from 16 x 3000 + 8000).
   Fails on a Laplace Hessian not SPD beyond float64 roundoff (an
   eigenvalue below -1e-12 of its largest), a MAP outside the truth basin,
   non-finite draws, a chain whose mean f is at most 8, or a pooled theta
   more than 3 posterior sd from the JAX package's Laplace-start run
   (results/hes1_laplace_r4.json); prints the MAP's wall, L-BFGS-B
   iterations and convergence (not gated: the JAX package's own
   map_estimate does not meet its criterion on this fit), H's band
   coverage beside the heuristic starts', rhat and ESS.
6e. Hes1 with parallel tempering, on the same fit (scripts/hes1_pt.py's
   recipe): ``predict(pt_betas=(1, 0.6, 0.36, 0.22, 0.13))``, 16
   replicas a rung (80 chains), centered, no annealing, sigma pinned,
   heuristic starts, NUTS, 150 + 150 (cut from 3000 + 8000), float32.
   Fails on non-finite draws, K1 not launched with a temperature per chain
   through the Hes1-log functor, any launch of K1's given kernels, K6 not
   launched, the swap graph not replayed once a sampling transition, or a
   returned chain axis other than 16; prints, not gated, the swap
   acceptance per pair, the beta = 1 rung's draws by mode (f > 8), the
   chains that changed mode, theta by mode, H's band coverage beside 6c's
   and 6d's, rhat, ESS, depth and leaves. Then its composed float64
   target with a temperature per state card vs CPU, 20 PT NUTS transitions
   with swaps by graph and by eager (bit for bit), and the device time of
   a transition with its swap round and of a swap round alone.
7. Lorenz fit: the dense-grid configuration (257 observations, t_max 2,
   discretization 2: N_I = 1025, bandsize 100), ``initial_fit`` in float32,
   with theta started from the same data's discretization-1 fit (its
   hyperparameters by L-BFGS) through ``initial_fit(2, thetas_init=...)``
   (see ``lorenz_fit``).
8. Lorenz kernels vs plain: K1 with the Lorenz model; K3 (block-banded
   matvec and adjoint, single and paired: [R; m] delta and [R' | -m'] gcat
   are one launch each) on the fit's band-truncated R, m, S and K4 (the
   block-banded solve and adjoint) on its banded Gauss-Newton factor,
   both called through the banded target's own stages (so on the strided
   views the sampler passes) at 64, 256 and 257 chains, in float64 and
   float32, each launch run twice and compared bit for bit; K3 and K4
   print their time at each chain count, K4 also its residual
   ||Ux - y|| / ||y||, and 300 launches at 257 chains must all agree with
   the first. K4 is also checked as
   ``unwhiten_draws`` calls it on the hybrid run's 500 x 256 draws:
   (C, 1, N) right-hand sides in chunks of up to 87,296, many waves of
   clusters. Each kernel's
   time is printed beside one PyTorch call that computes the same function
   (the yardstick: torch.bmm with the densified operator for K3, for a
   pair the faster of two such calls and one on the stacked operators;
   torch.linalg.solve_triangular on the densified factor for K4).
9. Hybrid path: ``predict(storage="hybrid")``, 256 chains, L <= 64,
   300 + 300 steps, reference annealing at a 0.3 floor, sigma pinned at
   0.25, diagonal mass. Fails on non-finite draws, a kernel that never
   launched, a transition that replayed no captured leapfrog, a step size
   below 1e-2, mean acceptance below 0.5, or a theta
   mean more than 15% from (10, 28, 8/3).
10. Banded path: the same with ``storage="banded"``, 64 chains, 200 + 200
   steps; theta is printed, not gated (the band-truncated target is
   biased by design).
11. The composed float64 hybrid and banded targets on the card against the
   same targets on the CPU (plain versions), for 8 states near the fit.
12. Leapfrog profile of the hybrid path, and K4's float32 time per launch
   at 256 chains back to back and in that leapfrog, beside its bound and
   solve_triangular's time.
13. Leapfrog profile of the banded path at its 64 chains, as phase 6.
14. The hybrid and banded paths' transitions by graph and by eager, 20
   each from the same state and noise, compared as in phase 6.
15. Centered coordinates in banded storage on the Lorenz fit: the composed
   float64 target card vs CPU (8 states), then ``predict(reparam=
   "centered", storage="banded")``, 64 chains, 100 + 100 HMC steps (L <=
   64), sigma pinned at 0.25; fails on non-finite draws, K1, K2 or one of
   K3's four entries never launched, K3 not once per evaluation, or K4
   launched (step and theta printed only: centered coordinates at N_I =
   1025 are ~1e8-stiff); then 20 transitions by graph and by eager.
16. The mid-warmup refresh on the Lorenz banded path:
   ``predict(storage="banded", precond_refresh_steps=100)``, 64 chains,
   the banded recipe, 100 + 100 after stage A, for the "remap" and
   "laplace" restarts. Fails on non-finite draws, no warning, or K1, K2,
   K3's four entries or K4 not launched after the rebuild; then the
   rebuilt float64 target at the new anchor card vs CPU (8 states, 1e-10).
   Step, acceptance, divergences, rhat and the walls of stage A, the
   rebuild and stage B are printed, not gated (the JAX package measured
   the refresh harmful at this scale).
17. Host staging on the Lorenz hybrid recipe (64 chains, 100 + 200,
   blocks of 50): ``stage_above_bytes=0`` against the default must give
   the same results bit for bit; peak device memory through the sampler
   and the predict printed for both.

The last lines are the card's name and power limit, a JSON object with
each kernel's launch count (from the path named beside it; K2's NUTS form
and the leaf kernel from the SEIR NUTS and the Hes1 paths, K1's given
kernels from the FitzHugh-Nagumo predicts, K1's Hes1-log functor from the
Hes1 path, K1's whitened fwd from the whitened SEIR path, K1 with a
temperature per chain and K6 from the Hes1 PT path, the
``*_seir_forecast`` entries from the forecast's predict), error, times,
the bound (the least time the card could take for the same work, from
this run's inputs and the published H100 SXM peaks) and the yardstick's
time (null where no one PyTorch call computes the same function), and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# kernel-vs-plain tolerances, relative to the largest |value| of each
# logical output (output_parts): float64 sums differ only in order;
# float32 sums of ~500 terms in another order differ by a few ulps of the
# total
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# K4 in float32: the solve's error is ~kappa(U) eps32 ~ 1e-4 of max |x|
# (magi_v2_tpu/ops/banded.py), so the kernel and the plain version each
# carry that much
SOLVE_TOL = {torch.float32: 5e-4, torch.float64: 1e-12}
# K3 sums each row's products in another order than the plain version's
# GEMM (four column quarters per tile, then the quarters): a few ulps of a
# sum of some 300 terms, relative to max |y|
MATVEC_TOL = {torch.float32: 2e-6, torch.float64: 1e-13}
# composed float64 target, card vs CPU, relative to max |value|
COMPOSED_TOL = 1e-9
TRUE_THETAS = np.array([6.0, 0.6, 1.8])
NUM_CHAINS, NUM_LEAPFROGS, NUM_STEPS = 256, 192, 1000
LORENZ_THETAS = np.array([10.0, 28.0, 8.0 / 3.0])
# the hybrid run's 500 + 500 cut to 300 + 300 when the refresh, staging
# and sharding phases joined the smoke, to keep its wall inside its limit;
# K4's unwhitening check keeps the 500 draws it was sized for
LORENZ_CHAINS, LORENZ_LEAPFROGS, LORENZ_STEPS = 256, 64, 300
UNWHITEN_DRAWS = 500
BANDED_CHAINS, BANDED_STEPS = 64, 200
# a chain count that fills one of K4's chain groups in part
RAGGED_CHAINS = 257
MIN_STEP_SIZE, MIN_ACCEPT = 1e-2, 0.5
REPLACES = {
    "manifold_fwd": "magi_v2_tpu/sampler/precond.py:540",
    "manifold_energy": "magi_v2_tpu/posterior.py:288",
    "manifold_bwd": "magi_v2_tpu/sampler/precond.py:549",
    # the whitened target's t1 = ||z||^2 (through posterior.py:230)
    "manifold_fwd_whitened": "magi_v2_tpu/sampler/magi_state.py:102",
    "leapfrog_update": "magi_v2_tpu/sampler/hmc.py:63",
    "leapfrog_update_nuts": "magi_v2_tpu/sampler/nuts.py:58",
    "nuts_leaf": "magi_v2_tpu/sampler/nuts.py:130",
    # the centered target: log_posterior under value_and_grad
    "hes1_centered": "magi_v2_tpu/sampler/magi_state.py:38",
    "banded_matvec": "magi_v2_tpu/ops/banded.py:212",
    "banded_matvec_adjoint": "magi_v2_tpu/ops/banded.py:212",
    "banded_matvec_pair": "magi_v2_tpu/ops/banded.py:212",
    "banded_matvec_adjoint_pair": "magi_v2_tpu/ops/banded.py:212",
    "banded_solve": "magi_v2_tpu/ops/banded.py:315",
    "banded_solve_adjoint": "magi_v2_tpu/ops/banded.py:315",
    # the sampling phase's per-chain temperature (step_chains_pt's vmapped
    # tempered_logp_grad), and the swap round
    "k1_per_chain": "magi_v2_tpu/sampler/run.py:584",
    "pt_swap": "magi_v2_tpu/sampler/run.py:612",
}
SOURCES = {
    "manifold": "magi_v2_tpu_torch/csrc/manifold.cu",
    "banded": "magi_v2_tpu_torch/csrc/banded.cu",
    "leapfrog": "magi_v2_tpu_torch/csrc/leapfrog.cu",
    "nuts": "magi_v2_tpu_torch/csrc/nuts.cu",
    "pt": "magi_v2_tpu_torch/csrc/pt.cu",
}


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet), for the
# bounds: float32 and float64 outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12
# K1's operations per (chain, grid point, component), counted from
# csrc/manifold.cu: fwd (x, f, dr, the t1 seed, the t1 and t4 sums), energy
# (the t2 sum and the g_Ds seed), bwd (the VJPs in x and theta, the
# residual, gpart)
K1_FLOPS = {"manifold_fwd": 16, "manifold_energy": 5, "manifold_bwd": 17}
# the same for the given kernels of a field with no functor, which read the
# field's values (fwd) and its VJPs (bwd) that PyTorch computed
K1_GIVEN_FLOPS = {"manifold_fwd": 14, "manifold_energy": 5,
                  "manifold_bwd": 9}


def bound(nbytes, flops, dtype=torch.float32):
    """The least time (ms) the card could take to move ``nbytes`` (each
    input read once, each output written once) and do ``flops`` operations
    of ``dtype``, and which of the two sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k1_bound(kname, C, N, D, P, dtype, given=False, per_chain=False):
    """The bound of one K1 kernel at C chains, N grid points, D
    components and P parameters: what it reads and writes per
    csrc/manifold.cu (the (C, D, N) blocks, the (D, N) reference rows, the
    sigma/theta entries of q and grad, t14 and lp; for the given kernels
    also the field's values or its VJPs; with a temperature per chain its
    C temperatures)."""
    # the whitened fwd reads dz and z0 in place of R delta and a0: the
    # same bytes and operations as the GN form's
    kname = kname.replace("_whitened", "")
    pts, row, tail = C * N * D, D * N, C * (D + P)
    elems = {"manifold_fwd": 5 * pts + 5 * row + tail + 2 * C,
             "manifold_energy": 2 * pts + row + tail + 3 * C,
             "manifold_bwd": 4 * pts + 3 * row + 2 * tail}[kname]
    if given:
        elems += {"manifold_fwd": pts, "manifold_energy": 0,
                  "manifold_bwd": pts + C * P}[kname]
    if per_chain:
        elems += C
    size = torch.finfo(dtype).bits // 8
    flops = (K1_GIVEN_FLOPS if given else K1_FLOPS)[kname]
    return bound(elems * size, flops * pts, dtype)


def _counters():
    from magi_v2_tpu_torch.ops import banded, manifold, nuts, pt
    from magi_v2_tpu_torch.sampler import hmc

    return (manifold, banded, hmc, nuts, pt)


def reset_launch_counts():
    from magi_v2_tpu_torch.sampler import hmc

    for mod in _counters():
        mod.reset_launch_counts()
    hmc.reset_graph_counts()


def graph_counts():
    from magi_v2_tpu_torch.sampler import hmc

    return hmc.graph_counts()


def launch_counts():
    from magi_v2_tpu_torch.ops import manifold

    out = {}
    for mod in _counters():
        out.update(mod.launch_counts())
    out.update(manifold.functor_launch_counts())
    return out


def check_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this smoke runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return smi


def build():
    from magi_v2_tpu_torch.ops._build import load_library

    lib = load_library()
    print(f"build: {lib.build_seconds:.1f} s -> "
          f"{', '.join(p.name for p in lib.paths)}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    return lib


# K1's checks, by model: the states' sigma_pre and theta_pre (each +- 0.1)
# and the reference trajectories x0 (D, N), at the magnitudes of the
# model's paths (theta_pre the softplus pre-image of the registry's values
# where it has them). "fhn" is the smoke's own FitzHugh-Nagumo, a field
# registered nowhere (K1's given kernels).
def _rand(g, shape):
    return torch.rand(shape, generator=g, dtype=torch.float64)


def _randn(g, shape):
    return torch.randn(shape, generator=g, dtype=torch.float64)


K1_STATES = {
    "seir": (-10.5, (1.8, -0.3, 1.5), lambda g, s: 0.5 * _rand(g, s)),
    "lorenz": (-1.5, (10.0, 28.0, 2.6), lambda g, s: 15.0 * _randn(g, s)),
    "fhn": (-1.5, (-1.5, -1.5, 2.95), lambda g, s: 1.5 * _randn(g, s)),
    "fitzhugh_nagumo": (-1.5, (-1.5, -1.5, 2.95),
                        lambda g, s: 1.5 * _randn(g, s)),
    "sirw": (-8.0, (0.5, -0.5, -1.0, 0.2, -1.5),
             lambda g, s: 0.5 * _rand(g, s)),
    "hes1": (-3.0, None, lambda g, s: 0.5 + 4.0 * _rand(g, s)),
    "hes1_log": (-3.0, None,
                 lambda g, s: torch.log(0.5 + 4.0 * _rand(g, s))),
    "lotka_volterra": (-2.0, None, lambda g, s: 0.5 + 2.0 * _rand(g, s)),
    "protein_transduction": (-6.0, None, lambda g, s: _rand(g, s)),
}
# the six functors ported with the partially observed path
NEW_FUNCTORS = ("sirw", "fitzhugh_nagumo", "hes1", "hes1_log",
                "lotka_volterra", "protein_transduction")


def kernel_inputs(dtype, device, C=256, N=161, seed=0, model="seir"):
    """Inputs of the three K1 kernels at realistic magnitudes of ``model``
    (``K1_STATES``)."""
    from magi_v2_tpu_torch.models import MODEL_REGISTRY

    reg = MODEL_REGISTRY["fitzhugh_nagumo" if model == "fhn" else model]
    D, P = reg.D, reg.D_thetas
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s, scale=1.0: (scale * torch.randn(s, generator=g,
                                                   dtype=torch.float64))
    dim = N * D + D + P
    sigma_pre, theta_pre, draw_x0 = K1_STATES[model]
    if theta_pre is None:
        theta_pre = np.log(np.expm1(np.asarray(reg.true_thetas)))
    q = r(C, dim)
    q[:, N * D: N * D + D] = sigma_pre + r(C, D, scale=0.1)
    q[:, N * D + D:] = torch.tensor(theta_pre) + r(C, P, scale=0.1)
    x0T = draw_x0(g, (D, N))
    mask = torch.zeros(D, N, dtype=torch.float64)
    mask[:, ::2] = 1.0
    inp = dict(
        delta=r(C, D, N, scale=1e-3), RmD=r(D, C, 2 * N, scale=5.0), q=q,
        x0T=x0T, a0=r(D, N, scale=50.0), f0=r(D, N, scale=0.5),
        s0=r(D, N, scale=20.0), mask=mask,
        y=mask * (x0T + r(D, N, scale=0.005)),
        sigma_lb=torch.full((D,), 1e-5, dtype=torch.float64),
        n_ds=torch.full((D,), (N + 1) / 2, dtype=torch.float64),
        beta_temp=torch.tensor(0.3, dtype=torch.float64),
        Ds=r(D, C, N, scale=3.0), gdr=r(D, C, N, scale=100.0),
    )
    out = {k: v.to(device=device, dtype=dtype).contiguous()
           for k, v in inp.items()}
    out["beta"] = D * N / float(inp["n_ds"].sum())
    return out


def gn_band_inputs(N=1025, D=3, b=100, bw=None, width=None, sqrts=True,
                   seed=0):
    """Synthetic NumPy float64 arguments (args, kwargs) of
    ``sampler.precond.gauss_newton_precision_band``: symmetric operators
    (their square roots with ``sqrts``) and m nonzero within ``width``
    (default b) of the diagonal and read at bandsize b, random Jacobians,
    half the grid observed, the precision's band ``bw`` (default 4 D b, its
    natural bandwidth with the square roots). The defaults are the Lorenz
    dense grid's shapes: N_I = 1025, D = 3, bandsize 100, bw 1200."""
    rng = np.random.default_rng(seed)
    i = np.arange(N)
    near = np.abs(i[:, None] - i[None, :]) <= (b if width is None else width)

    def sym():
        A = rng.standard_normal((D, N, N))
        return (A + A.transpose(0, 2, 1)) * near

    C_ops, K_ops = sym(), sym()
    m = rng.standard_normal((D, N, N)) * near
    J = rng.standard_normal((N, D, D))
    obs = (rng.random((N, D)) < 0.5).astype(np.float64)
    sigma = rng.uniform(0.1, 1.0, D)
    args = (C_ops, m, K_ops, 1.7, obs, sigma, J, 4 * D * b if bw is None
            else bw)
    kw = dict(comp_bandwidth=b)
    if sqrts:
        kw.update(C_inv_sqrts=C_ops, K_inv_sqrts=K_ops)
    return args, kw


def _relerr(a, b):
    scale = float(torch.max(torch.abs(a))) or 1.0
    err = float(torch.max(torch.abs(a - b)))
    return err, err / scale


def output_parts(name, t, N, D):
    """The logical outputs stacked in one kernel output, so that each is
    held to its own scale (t1 is ~1e4 where t4 is ~1e2, for example)."""
    ND = N * D
    if name == "gcat":
        return {"g_Rd": t[..., :N], "g_dr": t[..., N:]}
    if name == "t14":
        return {"t1": t[:, 0], "t4": t[:, 1]}
    if name == "grad":
        return {"g_z": t[:, :ND], "g_sigma_pre": t[:, ND:ND + D],
                "g_theta_pre": t[:, ND + D:]}
    return {name: t}


def part_errors(pairs, N, D):
    """{part: (max abs err, relative err)} of (name, reference, tested)
    triples, split by ``output_parts``."""
    out = {}
    for name, ref, got in pairs:
        for part, r in output_parts(name, ref, N, D).items():
            out[part] = _relerr(r, output_parts(name, got, N, D)[part])
    return out


# a timing's loop stops at about this many ms of device time (at least 10
# calls): the plain versions take milliseconds a call, and 200 of each
# set much of the smoke's wall
TIME_BUDGET_MS = 50.0


def _time_ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(1, min(reps, max(10, int(TIME_BUDGET_MS
                                        / max(start.elapsed_time(end),
                                              1e-3)))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, rearm=None, reps=50, rounds=5):
    """Device ms per call of ``fn`` (launches on the current stream):
    ``reps`` calls captured in one CUDA graph, replayed ``rounds`` times
    back to back. With ``rearm``, every call is preceded by it (it restores
    what the call changes that decides its work, so that every call does
    the work of the first), and a graph of ``rearm`` alone is timed and
    taken off."""
    def graph_of(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
        return graph

    def per_call(graph):
        graph.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(rounds):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (rounds * reps)

    if rearm is None:
        return per_call(graph_of(fn))

    def both():
        rearm()
        fn()

    return per_call(graph_of(both)) - per_call(graph_of(rearm))


def report(kname, dtype, errs, ms, plain_ms, tol, results, extra="",
           more=None):
    """Print one kernel check, raise above ``tol``, and keep the float32
    numbers (the sampling dtype), with ``more`` (bound, yardstick), in
    ``results``."""
    worst_part = max(errs, key=lambda p: errs[p][1])
    worst_rel = errs[worst_part][1]
    worst_abs = max(e[0] for e in errs.values())
    name = str(dtype).replace("torch.", "")
    print(f"{kname} {name}: max_abs_err {worst_abs:.3e}, relative per output "
          + ", ".join(f"{p} {e[1]:.1e}" for p, e in errs.items())
          + f" (tol {tol:.0e}){extra}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    if not worst_rel <= tol:
        raise AssertionError(
            f"{kname} {name} disagrees with its plain version: {worst_part} "
            f"relative error {worst_rel:.3e} > {tol:.0e}")
    if dtype == torch.float32:
        results[kname] = dict(max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms,
                              **(more or {}))


K1_CONSTS = ("x0T", "a0", "f0", "s0", "mask", "y", "sigma_lb", "n_ds")


def make_plan(f, x, device, dtype):
    """The K1 plan of the sampler's target on ``kernel_inputs`` ``x``:
    delta, RmD, Ds and gdr are the inputs, the other buffers new. Returns
    (plan, buffers, I)."""
    from magi_v2_tpu_torch.ops import manifold as mf

    C, D, N = x["delta"].shape
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    bufs = dict(delta=x["delta"], RmD=x["RmD"], Ds=x["Ds"], gdr=x["gdr"],
                gcat=new(D, C, 2 * N), t14=new(C, 2),
                **{k: new(D, C, N) for k in ("dr", "gDs", "gpart")})
    I = torch.zeros((N, 1), dtype=dtype, device=device)
    plan = mf.ManifoldPlan(f, I, {k: x[k] for k in K1_CONSTS}, x["beta"],
                           x["q"].shape[1], bufs)
    return plan, bufs, I


def same_twice(run, outputs, what):
    """Two runs of one launch must write the same bits: no sum may depend
    on the order in which blocks finish."""
    run()
    first = [t.clone() for t in outputs()]
    run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, outputs())):
        raise AssertionError(f"{what}: two runs of the same launch differ")


def check_kernels(device, model="seir", N=161, C=256, tag="", reps=200):
    """Each K1 kernel against its plain version, float32 and float64, as
    the target launches it (``ManifoldPlan``) and through its one-shot
    wrapper (the same kernel: the same bits); returns {name: {max_abs_err,
    ms, plain_ms}} for float32 (the sampling dtype); names carry the
    model's name as a suffix (``_lorenz``, ``_hes1_log``, ...; none for
    SEIR; ``_fhn`` for the smoke's FitzHugh-Nagumo, a field with no
    functor: K1's given kernels, with PyTorch's evaluation of the field
    and its VJPs in their time), and ``tag`` after it. Kernel and plain
    version are timed over ``reps`` calls each."""
    from magi_v2_tpu_torch.models import MODEL_REGISTRY
    from magi_v2_tpu_torch.ops import manifold as mf

    given = model == "fhn"
    f = fitzhugh_nagumo_f_vec if given else MODEL_REGISTRY[model].f_vec
    suffix = ("" if model == "seir" else f"_{model}") + tag
    results = {}
    stream = torch.cuda.current_stream(device).cuda_stream
    for dtype in (torch.float64, torch.float32):
        x = kernel_inputs(dtype, device, C=C, N=N, model=model)
        D, N = x["x0T"].shape
        plan, b, I = make_plan(f, x, device, dtype)
        q, bt = x["q"], x["beta_temp"]
        lp = torch.empty((C,), dtype=dtype, device=device)
        grad = torch.zeros_like(q)

        fwd_args = (f, I, x["delta"], x["RmD"], q, x["x0T"], x["a0"],
                    x["f0"], x["mask"], x["y"], x["sigma_lb"], bt, x["beta"])
        fwd = lambda: plan.fwd(q, bt, stream)
        same_twice(fwd, lambda: (b["dr"], b["t14"], b["gcat"][..., :N]),
                   f"manifold_fwd{suffix}")
        pdr, pgcat, pt14 = mf.manifold_fwd_plain(*fwd_args)
        # manifold_fwd writes only the first half of gcat
        fwd_err = part_errors([("dr", pdr, b["dr"]), ("t14", pt14, b["t14"]),
                               ("g_Rd", pgcat[..., :N], b["gcat"][..., :N])],
                              N, D)
        dr1, gcat1, t141 = mf.manifold_fwd(*fwd_args)
        one_shot = (torch.equal(dr1, b["dr"]) and torch.equal(t141, b["t14"])
                    and torch.equal(gcat1[..., :N], b["gcat"][..., :N]))

        # the next kernels on the plain version's outputs, as their plain
        # versions
        b["t14"].copy_(pt14)
        en_args = (f, x["Ds"], x["s0"], pt14, q, x["sigma_lb"], x["n_ds"],
                   bt, x["beta"])
        energy = lambda: plan.energy(q, bt, lp, stream)
        same_twice(energy, lambda: (lp, b["gDs"]),
                   f"manifold_energy{suffix}")
        plp, pgDs = mf.manifold_energy_plain(*en_args)
        en_err = part_errors([("lp", plp, lp), ("gDs", pgDs, b["gDs"])], N, D)
        lp1, gDs1 = mf.manifold_energy(*en_args)
        one_shot = (one_shot and torch.equal(lp1, lp)
                    and torch.equal(gDs1, b["gDs"]))

        b["gcat"].copy_(pgcat)
        bwd = lambda: plan.bwd(q, bt, grad, stream)
        same_twice(bwd, lambda: (b["gpart"], b["gcat"], grad),
                   f"manifold_bwd{suffix}")
        bwd_args = (f, I, x["gdr"], x["delta"], q, x["x0T"], x["mask"],
                    x["y"], x["sigma_lb"], x["n_ds"], bt)
        gc_p, gr_p = pgcat.clone(), torch.zeros_like(q)
        gp_p = mf.manifold_bwd_plain(*bwd_args, gc_p, gr_p)
        bwd_err = part_errors([("gpart", gp_p, b["gpart"]),
                               ("gcat", gc_p, b["gcat"]),
                               ("grad", gr_p, grad)], N, D)
        gc1, gr1 = pgcat.clone(), torch.zeros_like(q)
        gp1 = mf.manifold_bwd(*bwd_args, gc1, gr1)
        one_shot = (one_shot and torch.equal(gp1, b["gpart"])
                    and torch.equal(gc1, b["gcat"]) and torch.equal(gr1, grad))
        torch.cuda.synchronize()
        if not one_shot:
            raise AssertionError(f"K1 {model}: the one-shot wrappers and the "
                                 "plan launch one kernel and must agree "
                                 "bit for bit")

        P = q.shape[1] - N * D - D
        for kname, errs, fk, fp in (
            ("manifold_fwd", fwd_err, fwd,
             lambda: mf.manifold_fwd_plain(*fwd_args)),
            ("manifold_energy", en_err, energy,
             lambda: mf.manifold_energy_plain(*en_args)),
            ("manifold_bwd", bwd_err, bwd,
             lambda: mf.manifold_bwd_plain(*bwd_args, gc_p, gr_p)),
        ):
            # no one PyTorch call computes a K1 kernel's fused epilogue
            more = dict(k1_bound(kname, C, N, D, P, dtype, given),
                        library_ms=None)
            report(kname + suffix, dtype, errs, _time_ms(fk, reps),
                   _time_ms(fp, reps),
                   TOL[dtype], results,
                   extra=f" at {C} chains, N {N}, bound "
                         f"{more['bound_ms']:.4f} ms", more=more)
    return results


# K1's whitened fwd against its plain version, relative to each output's
# scale: what the K1 rows measured (PERF.md: float32 <= 4.9e-7, float64
# <= 1.1e-15)
WHITENED_TOL = {torch.float32: 5e-7, torch.float64: 1e-14}


def check_whitened_kernels(device, model="seir", N=161, C=256, tag="",
                           reps=200):
    """K1's fwd in its whitened form (t1 = sum dz (dz + 2 z0), the seed
    -(beta_T/beta) z), against its plain version in float64 and float32,
    launched as the whitened target launches it (``ManifoldPlan(...,
    whitened=True)``) and through the one-shot wrapper (the same bits),
    each launch twice bit for bit, with R delta's half of RmD set to NaN
    (the form must not read it); dz ~ 0.3 and z0 ~ 3 per coordinate, the
    whitened SEIR path's magnitudes. ``model`` as in ``check_kernels``
    ("fhn": the given kernels). Returns {name: {...}} for float32."""
    from magi_v2_tpu_torch.models import MODEL_REGISTRY
    from magi_v2_tpu_torch.ops import manifold as mf

    given = model == "fhn"
    f = fitzhugh_nagumo_f_vec if given else MODEL_REGISTRY[model].f_vec
    name = "manifold_fwd_whitened" + (
        "" if model == "seir" else f"_{model}") + tag
    results = {}
    stream = torch.cuda.current_stream(device).cuda_stream
    for dtype in (torch.float64, torch.float32):
        x = kernel_inputs(dtype, device, C=C, N=N, model=model)
        D, N = x["x0T"].shape
        g = torch.Generator(device="cpu").manual_seed(7)
        on = lambda t: t.to(device=device, dtype=dtype).contiguous()
        dz = on(0.3 * _randn(g, (C, D, N)))
        z0 = on(3.0 * _randn(g, (D, N)))
        RmD = x["RmD"].clone()
        RmD[..., :N] = float("nan")
        new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
        b = dict(delta=x["delta"], RmD=RmD, Ds=x["Ds"], gdr=x["gdr"], dz=dz,
                 gcat=new(D, C, 2 * N), t14=new(C, 2),
                 **{k: new(D, C, N) for k in ("dr", "gDs", "gpart")})
        consts = dict({k: x[k] for k in K1_CONSTS}, a0=z0)
        I = torch.zeros((N, 1), dtype=dtype, device=device)
        q, bt = x["q"], x["beta_temp"]
        plan = mf.ManifoldPlan(f, I, consts, x["beta"], q.shape[1], b,
                               whitened=True)
        fwd = lambda: plan.fwd(q, bt, stream)
        same_twice(fwd, lambda: (b["dr"], b["t14"], b["gcat"][..., :N]),
                   name)
        args = (f, I, x["delta"], RmD, q, x["x0T"], z0, x["f0"], x["mask"],
                x["y"], x["sigma_lb"], bt, x["beta"])
        pdr, pgcat, pt14 = mf.manifold_fwd_plain(*args, dz=dz)
        errs = part_errors([("dr", pdr, b["dr"]), ("t14", pt14, b["t14"]),
                            ("g_z", pgcat[..., :N], b["gcat"][..., :N])],
                           N, D)
        dr1, gcat1, t141 = mf.manifold_fwd(*args, dz=dz)
        torch.cuda.synchronize()
        if not (torch.equal(dr1, b["dr"]) and torch.equal(t141, b["t14"])
                and torch.equal(gcat1[..., :N], b["gcat"][..., :N])):
            raise AssertionError(f"{name}: the one-shot wrapper and the plan "
                                 "launch one kernel and must agree bit for "
                                 "bit")
        P = q.shape[1] - N * D - D
        more = dict(k1_bound("manifold_fwd_whitened", C, N, D, P, dtype,
                             given), library_ms=None)
        report(name, dtype, errs, _time_ms(fwd, reps),
               _time_ms(lambda: mf.manifold_fwd_plain(*args, dz=dz), reps),
               WHITENED_TOL[dtype], results,
               extra=f" at {C} chains, N {N}, bound "
                     f"{more['bound_ms']:.4f} ms", more=more)
    return results


# K1 with a temperature per chain (parallel tempering's rungs, stride 1):
# relative to each output's scale, the tolerances the K1 rows measured
# (PERF.md: float32 <= 4.9e-7, float64 <= 1.1e-15), as for the whitened
# form
PT_TOL = WHITENED_TOL
# (model, N_I, chains): SEIR's, the Hes1 PT path's 80 chains (5 rungs x 16
# replicas), a chain count and grid that fill no tile, and the given
# kernels there
HES1_PT_CHAINS = 80
K1_PT_CASES = (("seir", 161, 256), ("hes1_log", 129, HES1_PT_CHAINS),
               ("seir", 333, 37), ("fhn", 333, 37))


def check_k1_per_chain(device, model="seir", N=161, C=256, reps=200):
    """Each K1 kernel (fwd, its whitened form, energy, bwd) with one
    temperature per chain, drawn in (0.1, 1]: as the sampler's plan
    launches it (a (C,) beta_temp: the launch of stride 1) and through its
    one-shot wrapper (the same bits), against its plain version (which
    broadcasts beta_temp over the chains) on the same inputs, float64 and
    float32; each launch twice bit for bit, and the launch of stride 1
    with every chain at one beta gives the bits of the launch of stride 0
    at that beta. ``model`` as in ``check_kernels`` ("fhn": the given
    kernels). Returns {name: {...}} for float32, each kernel's time beside
    its stride-0 launch's ("stride0_ms"); names end in "_pt" and the
    model's name as in ``check_kernels``."""
    from magi_v2_tpu_torch.models import MODEL_REGISTRY
    from magi_v2_tpu_torch.ops import manifold as mf

    given = model == "fhn"
    f = fitzhugh_nagumo_f_vec if given else MODEL_REGISTRY[model].f_vec
    suffix = "_pt" + ("" if model == "seir" else f"_{model}")
    results = {}
    stream = torch.cuda.current_stream(device).cuda_stream
    for dtype in (torch.float64, torch.float32):
        x = kernel_inputs(dtype, device, C=C, N=N, model=model)
        D, N = x["x0T"].shape
        P = x["q"].shape[1] - N * D - D
        on = lambda t: t.to(device=device, dtype=dtype).contiguous()
        g = torch.Generator(device="cpu").manual_seed(11)
        bc = on(1.0 - 0.9 * _rand(g, (C,)))
        bt = x["beta_temp"]
        one_b = torch.full((C,), float(bt), dtype=dtype, device=device)
        q = x["q"]
        plan, b, I = make_plan(f, x, device, dtype)
        # the whitened form, as check_whitened_kernels makes it
        dz, z0 = on(0.3 * _randn(g, (C, D, N))), on(3.0 * _randn(g, (D, N)))
        RmDw = x["RmD"].clone()
        RmDw[..., :N] = float("nan")
        new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
        bw = dict(delta=x["delta"], RmD=RmDw, Ds=x["Ds"], gdr=x["gdr"], dz=dz,
                  gcat=new(D, C, 2 * N), t14=new(C, 2),
                  **{k: new(D, C, N) for k in ("dr", "gDs", "gpart")})
        wplan = mf.ManifoldPlan(f, I, dict({k: x[k] for k in K1_CONSTS},
                                           a0=z0), x["beta"], q.shape[1], bw,
                                whitened=True)
        lp = torch.empty((C,), dtype=dtype, device=device)
        grad = torch.zeros_like(q)
        fwd_args = lambda RmD, a0: (f, I, x["delta"], RmD, q, x["x0T"], a0,
                                    x["f0"], x["mask"], x["y"], x["sigma_lb"])
        en_args = lambda: (f, x["Ds"], x["s0"], b["t14"].clone(), q,
                           x["sigma_lb"], x["n_ds"])
        bwd_args = (f, I, x["gdr"], x["delta"], q, x["x0T"], x["mask"],
                    x["y"], x["sigma_lb"], x["n_ds"])

        def bwd_plain(beta):
            gc, gr = b["gcat"].clone(), torch.zeros_like(q)
            gp = mf.manifold_bwd_plain(*bwd_args, beta, gc, gr)
            return gp, gc[..., N:], gr[:, N * D:]

        def bwd_once(beta):
            gc, gr = b["gcat"].clone(), torch.zeros_like(q)
            gp = mf.manifold_bwd(*bwd_args, beta, gc, gr)
            return gp, gc[..., N:], gr[:, N * D:]

        # (name, the plan's launch at beta, what it writes, the plain
        # version's values of those, the one-shot wrapper's, output names)
        cases = (
            ("manifold_fwd", lambda beta: plan.fwd(q, beta, stream),
             lambda: (b["dr"], b["t14"], b["gcat"][..., :N]),
             lambda beta: _fwd_parts(mf.manifold_fwd_plain(
                 *fwd_args(x["RmD"], x["a0"]), beta, x["beta"]), N),
             lambda beta: _fwd_parts(mf.manifold_fwd(
                 *fwd_args(x["RmD"], x["a0"]), beta, x["beta"]), N),
             ("dr", "t14", "g_Rd")),
            ("manifold_fwd_whitened", lambda beta: wplan.fwd(q, beta, stream),
             lambda: (bw["dr"], bw["t14"], bw["gcat"][..., :N]),
             lambda beta: _fwd_parts(mf.manifold_fwd_plain(
                 *fwd_args(RmDw, z0), beta, x["beta"], dz=dz), N),
             lambda beta: _fwd_parts(mf.manifold_fwd(
                 *fwd_args(RmDw, z0), beta, x["beta"], dz=dz), N),
             ("dr", "t14", "g_z")),
            ("manifold_energy",
             lambda beta: plan.energy(q, beta, lp, stream),
             lambda: (lp, b["gDs"]),
             lambda beta: mf.manifold_energy_plain(*en_args(), beta,
                                                   x["beta"]),
             lambda beta: mf.manifold_energy(*en_args(), beta, x["beta"]),
             ("lp", "gDs")),
            ("manifold_bwd", lambda beta: plan.bwd(q, beta, grad, stream),
             lambda: (b["gpart"], b["gcat"][..., N:], grad[:, N * D:]),
             bwd_plain, bwd_once, ("gpart", "g_dr", "grad_tail")),
        )
        for kname, run, outputs, plain, once, names in cases:
            if kname == "manifold_energy":
                # energy reads t14: the plain fwd's at these temperatures
                b["t14"].copy_(_fwd_parts(mf.manifold_fwd_plain(
                    *fwd_args(x["RmD"], x["a0"]), bc, x["beta"]), N)[1])
            name = kname + suffix
            same_twice(lambda: run(bc), outputs, name)
            got = [t.clone() for t in outputs()]
            shot = once(bc)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(shot, got)):
                raise AssertionError(f"{name}: the one-shot wrapper and the "
                                     "plan launch one kernel and must agree "
                                     "bit for bit")
            run(one_b)
            strided = [t.clone() for t in outputs()]
            run(bt)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(strided, outputs())):
                raise AssertionError(f"{name}: a temperature per chain, all "
                                     "equal, does not give the bits of one "
                                     "temperature for all chains")
            errs = part_errors(zip(names, plain(bc), got), N, D)
            more = dict(k1_bound(kname, C, N, D, P, dtype, given,
                                 per_chain=True), library_ms=None,
                        stride0_ms=_time_ms(lambda: run(bt), reps))
            report(name, dtype, errs, _time_ms(lambda: run(bc), reps),
                   _time_ms(lambda: plain(bc), reps), PT_TOL[dtype], results,
                   extra=f" at {C} chains, N {N}, a temperature per chain; "
                         f"stride 0 {more['stride0_ms']:.4f} ms, bound "
                         f"{more['bound_ms']:.4f} ms", more=more)
    return results


def _fwd_parts(out, N):
    """(dr, t14, the t1 seed gcat[..., :N]) of a fwd's (dr, gcat, t14)."""
    dr, gcat, t14 = out
    return dr, t14, gcat[..., :N]


# K6, the swap kernel: (rungs, replicas, width) at the Hes1 PT path's
# shape (5 x 16, the 397-wide state), at the SEIR state's 489 (4 x 64) and
# at the Lorenz width with rows that share no 16-byte alignment (3 x 7 x
# 3081: the element-by-element path)
PT_SWAP_CASES = ((5, 16, 397), (4, 64, 489), (3, 7, 3081))
# a log u this close to log alpha is moved away (device logf and torch's
# log may differ by an ulp)
PT_SWAP_TIE = 0.05


def pt_swap_case(R, M, dim, dtype, device, seed=0):
    """One swap round's inputs: the ladder (1, 0.6, 0.36, ...), q (C, dim),
    lp (C,) spread so that both outcomes occur, one lp NaN (its pair is
    refused), and u (R - 1, M) with log u at least PT_SWAP_TIE from log
    alpha (computed as the plain version computes it)."""
    from magi_v2_tpu_torch.ops.pt import ladder_gaps

    g = torch.Generator(device="cpu").manual_seed(seed)
    C = R * M
    betas = tuple(0.6 ** r for r in range(R))
    q = torch.randn((C, dim), generator=g, dtype=torch.float64).to(dtype)
    lp = (-250.0 + 4.0 * torch.randn((C,), generator=g,
                                     dtype=torch.float64)).to(dtype)
    lp[M + 1] = float("nan")
    u = torch.rand((R - 1, M), generator=g, dtype=torch.float64).to(dtype)
    lpr = lp.view(R, M)
    la = ladder_gaps(betas, dtype, "cpu")[:, None] * (lpr[1:] - lpr[:-1])
    near = (torch.log(u) - la).abs() < PT_SWAP_TIE
    u = torch.where(near, 0.5 * u, u)
    return betas, q.to(device), lp.to(device), u.to(device)


def pt_swap_bound(R, M, dim, dtype, accepted):
    """K6's bound for one round with ``accepted`` swaps: the round's lp
    pairs and uniforms read, and each swap's two lp and two rows read and
    written once, over the memory rate (operations: a few a replica)."""
    size = torch.finfo(dtype).bits // 8
    pairs = len(range(0, R - 1, 2))
    elems = pairs * M * 3 + accepted * (2 + 4 * dim)
    return bound(elems * size + 8 * (R - 1), 4 * pairs * M, dtype)


def check_pt_swap(device, reps=200):
    """K6 against its plain version at PT_SWAP_CASES, float64 and float32,
    both parities: q, lp (NaN where NaN) and the counters must be equal.
    Each case must both accept and refuse. Timed at parity 0 (q and lp
    restored before each launch, in one CUDA graph); returns {"pt_swap":
    {...}} at the Hes1 shape, float32."""
    from magi_v2_tpu_torch.ops.pt import bind_pt_swap, pt_swap_plain

    results = {}
    for R, M, dim in PT_SWAP_CASES:
        for dtype in (torch.float64, torch.float32):
            betas, q, lp, u = pt_swap_case(R, M, dim, dtype, device)
            taken, offered = 0, 0
            for parity in (0, 1):
                qp, lpp, dp, dap = pt_swap_plain(q, lp, betas, u, parity)
                qk, lpk = q.clone(), lp.clone()
                prop = torch.zeros((R - 1,), dtype=torch.int32, device=device)
                accs = torch.zeros_like(prop)
                par = torch.tensor([parity], dtype=torch.int32, device=device)
                bind_pt_swap(qk, lpk, betas, u, par, prop, accs)(
                    torch.cuda.current_stream(device).cuda_stream)
                torch.cuda.synchronize()
                nan = torch.isnan(lpp)
                same = (torch.equal(qk, qp) and torch.equal(prop, dp)
                        and torch.equal(accs, dap)
                        and torch.equal(torch.isnan(lpk), nan)
                        and torch.equal(lpk[~nan], lpp[~nan]))
                if not same:
                    raise AssertionError(
                        f"pt_swap {R} x {M} x {dim} {dtype} parity {parity}"
                        ": the kernel's round differs from the plain one")
                taken += int(dap.sum())
                offered += int(dp.sum())
            if not 0 < taken < offered:
                raise AssertionError(f"pt_swap {R} x {M} x {dim}: the case "
                                     f"accepts {taken} of {offered}")
            # the timed round: parity 0 from the same state every time
            qk, lpk = q.clone(), lp.clone()
            prop = torch.zeros((R - 1,), dtype=torch.int32, device=device)
            accs = torch.zeros_like(prop)
            par = torch.zeros((1,), dtype=torch.int32, device=device)
            launch = bind_pt_swap(qk, lpk, betas, u, par, prop, accs)
            stream = lambda: torch.cuda.current_stream(device).cuda_stream

            def rearm():
                qk.copy_(q)
                lpk.copy_(lp)

            ms = _graph_ms(lambda: launch(stream()), rearm)
            plain_ms = _time_ms(lambda: pt_swap_plain(q, lp, betas, u, 0),
                                reps)
            n0 = int(pt_swap_plain(q, lp, betas, u, 0)[3].sum())
            more = dict(pt_swap_bound(R, M, dim, dtype, n0), library_ms=None)
            name = str(dtype).replace("torch.", "")
            print(f"pt_swap {name} at {R} rungs x {M} replicas x {dim}: "
                  f"equal to its plain version at both parities ({taken} of "
                  f"{offered} swaps accepted); kernel {ms:.4f} ms (parity 0,"
                  f" {n0} swaps, restored in a graph), plain {plain_ms:.4f} "
                  f"ms, bound {more['bound_ms']:.5f} ms")
            if dtype == torch.float32 and (R, M, dim) == PT_SWAP_CASES[0]:
                results["pt_swap"] = dict(max_abs_err=0.0, ms=ms,
                                          plain_ms=plain_ms, **more)
    return results


# K2's cases: (name, dim, k) at the three paths' shapes: the SEIR recipe's
# full dense metric (489 wide), the hybrid and banded runs' diagonal (3081),
# and dense tails of 3 (mass_matrix="tail_dense" with sigma pinned) and 8
K2_CASES = (("dense489", 489, 489), ("diag3081", 3081, 0),
            ("tail3", 3081, 3), ("tail8", 3081, 8))
# the kernels line's K2 entries: (name, case, chains), one per path
K2_ENTRIES = (("leapfrog_update_seir", "dense489", NUM_CHAINS),
              ("leapfrog_update", "diag3081", LORENZ_CHAINS),
              (f"leapfrog_update_c{BANDED_CHAINS}", "diag3081",
               BANDED_CHAINS))


def k2_bound(C, dim, k, dtype):
    """K2's bound for the leapfrog the sampler replays (two kicks, the
    velocity, the drift): q, p, g read and q, p written once, the
    diagonal and the dense block read once; 7 operations an element of
    the diagonal head (two kicks as FMAs, the velocity, the drift), and
    2k an element of the dense block's velocity plus its kicks and drift."""
    size = torch.finfo(dtype).bits // 8
    head = dim - k
    return bound((5 * C * dim + head + k * k) * size,
                 7 * C * head + C * k * (2 * k + 6), dtype)


def leapfrog_case(C, dim, k, dtype, device, seed=3):
    """(q, p, g, eps, inverse mass) of one K2 case on the card: standard
    normal states and momenta, forces of 100, a diagonal in [0.5, 1.5) and
    a dense block with a well-conditioned random SPD inverse."""
    from magi_v2_tpu_torch.sampler.mass import TailDenseMass

    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    dv = lambda t: t.to(device=device, dtype=dtype).contiguous()
    diag = torch.rand((dim,), generator=g, dtype=torch.float64) + 0.5
    if k:
        a = r(k, k)
        ti = a @ a.T / k + torch.eye(k, dtype=torch.float64)
        mass = TailDenseMass(dv(diag), dv(ti), dv(torch.linalg.cholesky(ti)))
    else:
        mass = dv(diag)
    return (dv(r(C, dim)), dv(r(C, dim)), dv(100.0 * r(C, dim)),
            torch.tensor(0.05, dtype=dtype, device=device), mass)


def check_leapfrog(device, chains=(BANDED_CHAINS, LORENZ_CHAINS,
                                   RAGGED_CHAINS), cases=K2_CASES,
                   dtypes=(torch.float64, torch.float32)):
    """K2 against its plain version for every case of ``cases`` at each
    chain count: the replayed leapfrog (two kicks, drift) and the kinetic
    launches (one kick and none, no drift), float64 and float32, each
    launch run twice and compared bit for bit, each output (q, p, the
    kinetic energies) held to its own scale. Returns the float32 numbers
    of ``K2_ENTRIES``: ms of the replayed leapfrog's launch, bound to its
    tensors as the sampler binds it, back to back (so the larger of the
    device time and the host's ~5-10 us a call), its plain version's, and
    the bound."""
    from magi_v2_tpu_torch.sampler.hmc import (
        bind_leapfrog,
        leapfrog_update,
        leapfrog_update_plain,
    )

    results = {}
    stream = torch.cuda.current_stream(device).cuda_stream
    timed = {(case, C): name for name, case, C in K2_ENTRIES}
    for dtype in dtypes:
        errs, lines = {}, []
        for case, dim, k in cases:
            for C in chains:
                q, p, gr, eps, mass = leapfrog_case(C, dim, k, dtype, device)
                for nkick, drift, kinetic in ((2, True, False),
                                              (1, False, True),
                                              (0, False, True),
                                              (2, True, True)):
                    outs = []
                    for fn in (leapfrog_update, leapfrog_update_plain):
                        qq, pp = q.clone(), p.clone()
                        kin = fn(qq, pp, gr, eps, mass, nkick, drift,
                                 kinetic)
                        outs.append([qq, pp] + ([kin] if kinetic else []))
                    qq, pp = q.clone(), p.clone()
                    kin = leapfrog_update(qq, pp, gr, eps, mass, nkick,
                                          drift, kinetic)
                    again = [qq, pp] + ([kin] if kinetic else [])
                    torch.cuda.synchronize()
                    tag = f"{case}_C{C}_k{nkick}{'d' if drift else ''}" + (
                        "K" if kinetic else "")
                    if not all(torch.equal(a, b)
                               for a, b in zip(outs[0], again)):
                        raise AssertionError(f"leapfrog_update {tag}: two "
                                             "runs of the same launch differ")
                    for part, ref, got in zip(("q", "p", "kinetic"),
                                              outs[1], outs[0]):
                        errs[f"{tag}_{part}"] = _relerr(ref, got)
                # the launch as the sampler binds it
                qq, pp = q.clone(), p.clone()
                launch = bind_leapfrog(qq, pp, gr, eps, mass, 2, True)
                ms = _time_ms(lambda: launch(stream))
                plain_ms = _time_ms(lambda: leapfrog_update_plain(
                    qq, pp, gr, eps, mass, 2, True, False))
                b = k2_bound(C, dim, k, dtype)
                lines.append(f"{case} C{C} {ms:.4f} / {plain_ms:.4f} ms "
                             f"(bound {b['bound_ms']:.4f} {b['bound_by']})")
                name = timed.get((case, C))
                if name is not None and dtype == torch.float32:
                    worst = max(e[0] for t, e in errs.items()
                                if t.startswith(f"{case}_C{C}_"))
                    results[name] = dict(max_abs_err=worst, ms=ms,
                                         plain_ms=plain_ms, **b,
                                         library_ms=None)
        worst_part = max(errs, key=lambda t: errs[t][1])
        tol = TOL[dtype]
        name = str(dtype).replace("torch.", "")
        print(f"leapfrog_update {name}: max_abs_err "
              f"{max(e[0] for e in errs.values()):.3e}, worst relative "
              f"{errs[worst_part][1]:.1e} ({worst_part}) of {len(errs)} "
              f"outputs (tol {tol:.0e}); kernel / plain ms of the replayed "
              "leapfrog's launch: " + "; ".join(lines))
        if not errs[worst_part][1] <= tol:
            raise AssertionError(
                f"leapfrog_update {name} disagrees with its plain version: "
                f"{worst_part} relative error {errs[worst_part][1]:.3e} > "
                f"{tol:.0e}")
    # no one PyTorch call does the fused kicks, velocity and drift
    return results


# K2 at the widths its earlier design refused (a CTA held all k kicked
# momenta of 16 chains in shared memory): float64 above 1296, float32 above
# 3104; 3081 is the Lorenz N_I = 1025 flat state
K2_WIDE_CASES = {torch.float64: (("dense1297", 1297, 1297),
                                 ("dense1545", 1545, 1545),
                                 ("dense3081", 3081, 3081)),
                 torch.float32: (("dense3105", 3105, 3105),)}
# K2's NUTS form (a doubling's first opening) on the SEIR NUTS path's
# shapes (the dense 489 metric) and on the Lorenz width's diagonal
K2_NUTS_CASES = (("dense489", 489, 489), ("diag3081", 3081, 0))
NUTS_CHAINS = (BANDED_CHAINS, NUM_CHAINS, RAGGED_CHAINS)


def check_wide_leapfrog(device):
    """K2 with the full dense metric at the widths of K2_WIDE_CASES against
    its plain version, at 64 and 257 chains, each launch twice."""
    for dtype, cases in K2_WIDE_CASES.items():
        check_leapfrog(device, chains=(BANDED_CHAINS, RAGGED_CHAINS),
                       cases=cases, dtypes=(dtype,))


def k2_nuts_bound(C, on, dim, k, dtype):
    """The bound of K2's opening NUTS launch (one kick, the velocity, the
    drift) at C chains of which ``on`` move: their q, p, g read and q, p
    written once, the mass read once, a step and a flag a chain; 5
    operations an element of the diagonal head, 2k + 4 an element of the
    dense block, for the chains that move (a masked chain's q and p are
    left as they are and it has no velocity out)."""
    size = torch.finfo(dtype).bits // 8
    head = dim - k
    return bound((5 * on * dim + head + k * k + C) * size + C,
                 5 * on * head + on * k * (2 * k + 4), dtype)


def check_leapfrog_nuts(device, chains=NUTS_CHAINS, cases=K2_NUTS_CASES,
                        record=("dense489", NUM_CHAINS,
                                "leapfrog_update_nuts")):
    """K2's NUTS form (a signed step per chain, a mask, the velocities
    out) against its plain version: the leaf's opening launch (one kick,
    drift) and closing launch (one kick, kinetic energy and velocity), at
    each chain count, float64 and float32, each launch twice bit for bit;
    a quarter of the chains masked, the first of them with a NaN force,
    and their q and p must come back bit for bit. Returns the float32
    numbers of the opening launch at ``record`` (case, chains, name): by
    default the SEIR path's dense 489 metric at 256 chains."""
    from magi_v2_tpu_torch.sampler.hmc import (
        bind_leapfrog,
        leapfrog_update,
        leapfrog_update_plain,
    )

    results = {}
    stream = torch.cuda.current_stream(device).cuda_stream
    for dtype in (torch.float64, torch.float32):
        errs, lines = {}, []
        for case, dim, k in cases:
            for C in chains:
                q, p, gr, eps, mass = leapfrog_case(C, dim, k, dtype, device)
                gen = torch.Generator(device="cpu").manual_seed(C)
                sign = torch.where(torch.rand(C, generator=gen) < 0.5, -1.0,
                                   1.0).to(device=device, dtype=dtype)
                step = (eps * sign).contiguous()
                active = (torch.rand(C, generator=gen) < 0.75).to(device)
                active[0] = False
                gr = gr.clone()
                gr[0] = float("nan")
                idle = ~active
                for nkick, drift, kinetic, with_v in ((1, True, False, False),
                                                      (1, False, True, True)):
                    outs = []
                    for fn in (leapfrog_update, leapfrog_update,
                               leapfrog_update_plain):
                        qq, pp = q.clone(), p.clone()
                        vv = torch.zeros_like(q) if with_v else None
                        kin = fn(qq, pp, gr, step, mass, nkick, drift,
                                 kinetic, active, vv)
                        outs.append([qq, pp] + ([kin] if kinetic else [])
                                    + ([vv] if with_v else []))
                    torch.cuda.synchronize()
                    tag = f"{case}_C{C}_k{nkick}{'d' if drift else ''}" + (
                        "K" if kinetic else "")
                    if not all(torch.equal(a, b)
                               for a, b in zip(outs[0], outs[1])):
                        raise AssertionError(f"leapfrog_update NUTS {tag}: "
                                             "two runs of the same launch "
                                             "differ")
                    if not (torch.equal(outs[0][0][idle], q[idle])
                            and torch.equal(outs[0][1][idle], p[idle])):
                        raise AssertionError(f"leapfrog_update NUTS {tag}: a "
                                             "masked chain's q or p changed")
                    for part, ref, got in zip(("q", "p", "kinetic", "v")
                                              if kinetic else ("q", "p"),
                                              outs[2], outs[0]):
                        # the NaN force of the masked first chain stays out
                        # of every output the kernel writes for it
                        ok = torch.isfinite(ref).all() and torch.isfinite(
                            got).all()
                        if not ok:
                            raise AssertionError(f"leapfrog_update NUTS {tag}"
                                                 f": non-finite {part}")
                        errs[f"{tag}_{part}"] = _relerr(ref, got)
                qq, pp = q.clone(), p.clone()
                launch = bind_leapfrog(qq, pp, gr, step, mass, 1, True,
                                       active=active)
                ms = _time_ms(lambda: launch(stream))
                plain_ms = _time_ms(lambda: leapfrog_update_plain(
                    qq, pp, gr, step, mass, 1, True, False, active))
                b = k2_nuts_bound(C, int(active.sum()), dim, k, dtype)
                lines.append(f"{case} C{C} {ms:.4f} / {plain_ms:.4f} ms "
                             f"(bound {b['bound_ms']:.4f} {b['bound_by']}, "
                             f"{int(active.sum())} chains move)")
                if (case, C) == record[:2] and dtype == torch.float32:
                    worst = max(e[0] for t, e in errs.items()
                                if t.startswith(f"{case}_C{C}_"))
                    results[record[2]] = dict(
                        max_abs_err=worst, ms=ms, plain_ms=plain_ms, **b,
                        library_ms=None)
        worst_part = max(errs, key=lambda t: errs[t][1])
        tol = TOL[dtype]
        name = str(dtype).replace("torch.", "")
        print(f"leapfrog_update NUTS form {name}: max_abs_err "
              f"{max(e[0] for e in errs.values()):.3e}, worst relative "
              f"{errs[worst_part][1]:.1e} ({worst_part}) of {len(errs)} "
              f"outputs (tol {tol:.0e}); masked chains untouched; kernel / "
              "plain ms of the opening launch: " + "; ".join(lines))
        if not errs[worst_part][1] <= tol:
            raise AssertionError(
                f"leapfrog_update NUTS {name} disagrees with its plain "
                f"version: {worst_part} relative error "
                f"{errs[worst_part][1]:.3e} > {tol:.0e}")
    return results


# the leaf kernel's cases: the SEIR NUTS path's dense 489 metric, and at
# the Lorenz width a diagonal and a dense tail of 8
NUTS_LEAF_CASES = (("dense489", 489, 489), ("diag3081", 3081, 0),
                   ("tail8", 3081, 8))
# its leaves (doubling d, leaf n): an odd leaf checked against 3 slots that
# opens the next, an even one (slot popcount(8) = 1) that opens the next,
# and the one leaf of a doubling (stored in slot 0, no opening)
NUTS_LEAVES = ((4, 7), (4, 8), (0, 0))
NUTS_DEPTH = 10
# bind_nuts_leaf's operands, in order
NUTS_LEAF_ARGS = ("q", "p", "g", "lp", "H0", "eps", "inv_mass", "leaf_u",
                  "ctr", "lsw", "sum_alpha", "prop_q", "ckpt_q", "ckpt_v",
                  "active", "turning", "diverging", "n_leaves", "vel")
# what a launch writes; the rows copied exactly, the rest to TOL
NUTS_LEAF_OUT = ("q", "p", "vel", "lsw", "sum_alpha", "prop_q", "ckpt_q",
                 "ckpt_v", "active", "turning", "diverging", "n_leaves",
                 "ctr")
NUTS_LEAF_EXACT = ("prop_q", "ckpt_q", "active", "turning", "diverging",
                   "n_leaves", "ctr")


def nuts_leaf_case(C, dim, k, dtype, device, d, n, seed=5):
    """The leaf kernel's operands ({name: tensor}) at leaf n of doubling d
    for C chains: K2's state, momenta, forces and mass (``leapfrog_case``)
    and a signed step a chain; energies within a few units of H0 except
    chain 1 (NaN log-density) and chain 2 (dH ~ 2000, a divergence); a
    fifth of the chains and the last one masked, the last with a NaN
    force. Each decision lies well away from its threshold, so that the
    rounding of the row sums (float32 sums of some 10^4 in energy) cannot
    flip it: the leaf's uniform 0.5 in log away from the acceptance
    threshold, and the slots q - 0.3 sign(eps) v_end with velocities
    +-v_end (every third chain all +, the others a random sign a slot), so
    the U-turn dots are +-0.3 |v_end|^2."""
    from magi_v2_tpu_torch.sampler.mass import mass_vel

    q, p, g, eps, mass = leapfrog_case(C, dim, k, torch.float64, "cpu")
    gen = torch.Generator(device="cpu").manual_seed(seed + 31 * n + C)
    r = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64)
    u = lambda *s: torch.rand(s, generator=gen, dtype=torch.float64)
    D = NUTS_DEPTH
    step = eps * torch.where(u(C) < 0.5, -1.0, 1.0)
    p_end = p + 0.5 * step[:, None] * g
    v_end = mass_vel(mass, p_end)
    lp, lsw, dH = r(C), r(C), r(C)
    H0 = -lp + 0.5 * torch.sum(p_end * v_end, dim=-1) - dH
    lp[1 % C] = float("nan")
    H0[2 % C] -= 2000.0
    # log u = the acceptance threshold -dH - logaddexp(lsw, -dH) +- 0.5
    leaf_u = u(C, (1 << D) - 1)
    m = -dH - torch.logaddexp(lsw, -dH)
    up = (u(C) < 0.5) & (m < -0.5)
    leaf_u[:, (1 << d) - 1 + n] = torch.exp(m + torch.where(up, 0.5, -0.5))
    leaf_u[[1 % C, 2 % C], (1 << d) - 1 + n] = 0.5
    sign = torch.where(u(D, C) < 0.5, -1.0, 1.0)
    sign[:, ::3] = 1.0
    ckpt_v = sign[:, :, None] * v_end
    ckpt_q = (q - 0.3 * torch.sign(step)[:, None] * v_end).expand(
        D, C, dim).clone()
    active = u(C) >= 0.2
    if C > 1:
        active[-1] = False
        g[-1] = float("nan")
    x = dict(q=q, p=p, g=g, lp=lp, H0=H0, eps=step, leaf_u=leaf_u, lsw=lsw,
             sum_alpha=u(C), prop_q=r(C, dim), ckpt_q=ckpt_q, ckpt_v=ckpt_v,
             vel=r(C, dim))
    out = {k_: v.to(device=device, dtype=dtype).contiguous()
           for k_, v in x.items()}
    out["inv_mass"] = (mass._replace(**{f: getattr(mass, f).to(
        device=device, dtype=dtype) for f in mass._fields}) if k
        else mass.to(device=device, dtype=dtype))
    out["ctr"] = torch.tensor([d, n], dtype=torch.int32, device=device)
    out["active"] = active.to(device)
    out["turning"] = torch.zeros(C, dtype=torch.bool, device=device)
    out["diverging"] = torch.zeros(C, dtype=torch.bool, device=device)
    out["n_leaves"] = torch.randint(0, 50, (C,), generator=gen,
                                    dtype=torch.int32).to(device)
    return out


def energy_scale(x, vel):
    """The scale of the running chains' leaf energies -lp + 0.5 p_end.v_end
    - H0 in the sums that make them: what an error in lsw or sum_alpha
    (each moves at most as much as dH) is measured against, since the
    kernel and the plain version add the kinetic sum's terms in other
    orders."""
    on = x["active"]
    p_end = x["p"] + 0.5 * x["eps"][:, None] * x["g"]
    terms = (0.5 * torch.sum(torch.abs(p_end * vel), dim=-1)
             + torch.abs(x["lp"]) + torch.abs(x["H0"]))[on]
    terms = terms[torch.isfinite(terms)]
    return float(terms.max()) if terms.numel() else 1.0


def nuts_leaf_bound(C, on, dim, k, dtype, d, n, taken):
    """The leaf kernel's bound at C chains of which ``on`` run the leaf,
    from this leaf's outcome: for each running chain its q, p, g rows read
    and p, v written (q too where the next leaf opens), the slot rows read
    (q and v of t slots at an odd n) or written (an even n); the proposal
    rows taken written; the mass read once; ten scalars a chain.
    Operations for each running chain: the products with the dense block
    (2k FMAs an element, one product at a doubling's last leaf, two
    otherwise), the kicks, velocity, drift and kinetic sum (10 an element)
    and 6 an element a slot checked."""
    from magi_v2_tpu_torch.ops.nuts import trailing_ones

    size = torch.finfo(dtype).bits // 8
    t = trailing_ones(n) if n % 2 else 0
    opens = n + 1 < (1 << d)
    rows = on * (5 + opens + (2 * t if n % 2 else 2)) + taken
    products = 2 if opens else 1
    return bound((rows * dim + dim + k * k + 10 * C) * size,
                 on * (products * 2 * k * k + 10 * dim + 6 * t * dim), dtype)


def check_nuts_leaf(device, chains=NUTS_CHAINS, cases=NUTS_LEAF_CASES,
                    leaves=NUTS_LEAVES,
                    record=("dense489", NUM_CHAINS, "nuts_leaf")):
    """The leaf kernel (close, epilogue, counter, next opening) against its
    plain version for each mass case, chain count and leaf, float64 and
    float32: each launch twice bit for bit, the chains masked before the
    launch untouched (a NaN force included), the flags, counts, counter
    and copied rows exact, q, p, v and the slots' v to TOL of their
    scale, the log-weights and acceptance sums to TOL of the energies'
    (``energy_scale``). Times the kernel at each case and chain count
    at the first leaf (float32): in a CUDA graph with q, p, the counter,
    ``active``, ``lsw`` and ``sum_alpha`` restored before every launch, so
    every timed launch does the work the bound counts; the plain version
    the same way, back to back. Returns the float32 numbers at ``record``
    (case, chains, name): by default the dense 489 case at the SEIR path's
    256 chains."""
    from magi_v2_tpu_torch.ops import nuts as nu

    results = {}
    stream = lambda: torch.cuda.current_stream(device).cuda_stream
    for dtype in (torch.float64, torch.float32):
        errs, lines = {}, []
        for case, dim, k in cases:
            for C in chains:
                for d, n in leaves:
                    x = nuts_leaf_case(C, dim, k, dtype, device, d, n)
                    runs = []
                    for plain in (False, False, True):
                        a = {k_: v.clone() if isinstance(v, torch.Tensor)
                             else v for k_, v in x.items()}
                        args = [a[k_] for k_ in NUTS_LEAF_ARGS]
                        if plain:
                            nu.nuts_leaf_plain(*args, 1000.0)
                        else:
                            nu.nuts_leaf(*args)
                        runs.append(a)
                    torch.cuda.synchronize()
                    tag = f"{case}_C{C}_d{d}_n{n}"
                    if not all(torch.equal(runs[0][o], runs[1][o])
                               for o in NUTS_LEAF_OUT):
                        raise AssertionError(f"nuts_leaf {tag}: two runs of "
                                             "the same launch differ")
                    idle = ~x["active"]
                    for o in NUTS_LEAF_OUT[:-1]:
                        rows = ((lambda t: t[:, idle]) if o.startswith("ckpt")
                                else (lambda t: t[idle]))
                        if not torch.equal(rows(runs[0][o]), rows(x[o])):
                            raise AssertionError(f"nuts_leaf {tag}: a masked "
                                                 f"chain's {o} changed")
                    for o in NUTS_LEAF_OUT:
                        ref, got = runs[2][o], runs[0][o]
                        if o in NUTS_LEAF_EXACT:
                            if not torch.equal(ref, got):
                                raise AssertionError(
                                    f"nuts_leaf {tag}: {o} differs from the "
                                    "plain version")
                            continue
                        fin = torch.isfinite(ref)
                        if not torch.equal(fin, torch.isfinite(got)):
                            raise AssertionError(f"nuts_leaf {tag}: {o} "
                                                 "finite where the plain "
                                                 "version is not")
                        err = _relerr(ref[fin], got[fin])
                        if o in ("lsw", "sum_alpha"):
                            err = (err[0], err[0] / energy_scale(
                                x, runs[2]["vel"]))
                        errs[f"{tag}_{o}"] = err
                    if (d, n) != leaves[0] or dtype != torch.float32:
                        continue
                    a = {k_: v.clone() if isinstance(v, torch.Tensor) else v
                         for k_, v in x.items()}
                    args = [a[k_] for k_ in NUTS_LEAF_ARGS]
                    launch = nu.bind_nuts_leaf(*args, 1000.0)

                    def rearm(a=a):
                        for k_ in ("q", "p", "ctr", "active", "lsw",
                                   "sum_alpha"):
                            a[k_].copy_(x[k_])

                    ms = _graph_ms(lambda: launch(stream()), rearm)

                    def plain(args=args):
                        rearm()
                        nu.nuts_leaf_plain(*args, 1000.0)

                    plain_ms = (_time_ms(plain, reps=20)
                                - _time_ms(rearm, reps=20))
                    on = int(x["active"].sum())
                    taken = int((runs[2]["prop_q"] != x["prop_q"]).any(
                        dim=1).sum())
                    b = nuts_leaf_bound(C, on, dim, k, dtype, d, n, taken)
                    lines.append(f"{tag} {ms:.4f} / {plain_ms:.4f} ms (bound "
                                 f"{b['bound_ms']:.4f} {b['bound_by']}, {on} "
                                 f"active, {taken} proposals)")
                    if (case, C) == record[:2]:
                        worst = max(e[0] for k_, e in errs.items()
                                    if k_.startswith(f"{tag}_"))
                        results[record[2]] = dict(max_abs_err=worst, ms=ms,
                                                    plain_ms=plain_ms, **b,
                                                    library_ms=None)
        worst_part = max(errs, key=lambda t: errs[t][1])
        tol = TOL[dtype]
        name = str(dtype).replace("torch.", "")
        print(f"nuts_leaf {name}: worst relative {errs[worst_part][1]:.1e} "
              f"({worst_part}) of {len(errs)} outputs (tol {tol:.0e}), "
              "flags, counts, counter and copied rows exact, masked chains "
              "untouched, each launch twice bit for bit; kernel / plain ms: "
              + "; ".join(lines))
        if not errs[worst_part][1] <= tol:
            raise AssertionError(f"nuts_leaf {name} disagrees with its plain "
                                 f"version: {worst_part} relative error "
                                 f"{errs[worst_part][1]:.3e} > {tol:.0e}")
    return results


def seir_data():
    from magi_v2_tpu_torch.models import seir_f_vec
    from magi_v2_tpu_torch.utils.data import simulate_ode

    return simulate_ode(seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
                        thetas=TRUE_THETAS, t_max=4.0, n_obs=81,
                        noise_sd=0.005)


def main_path(device, num_steps=NUM_STEPS):
    """initial_fit + the bench's HMC predict on the card, float32."""
    from magi_v2_tpu_torch import MAGI_v2, MagiConfig
    from magi_v2_tpu_torch.models import seir_f_vec
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    ts, X_obs, _ = seir_data()
    cfg = MagiConfig(dtype=torch.float32, device=str(device))
    model = MAGI_v2(D_thetas=3, ts_obs=ts, X_obs=X_obs, bandsize=80,
                    f_vec=seir_f_vec, config=cfg)
    t0 = time.perf_counter()
    model.initial_fit(discretization=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"setup (initial_fit): {setup_s:.2f} s {model.fit_timings}; thetas_init "
          f"{np.round(model.thetas_init, 4).tolist()}")

    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(
        num_results=num_steps, num_burnin_steps=num_steps,
        num_chains=NUM_CHAINS, seed=0, init_jitter=0.01, algorithm="hmc",
        hmc_num_leapfrogs=NUM_LEAPFROGS, mass_matrix="dense",
        anneal_mode="reference", dense_shrinkage=0.2,
        mass_window=(0.25, 0.45), mass_window2=(0.50, 0.72),
        mass_window1_diag=True,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()

    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    mean_L = float(kr["num_leapfrogs"].mean())
    evals = 2 * num_steps * mean_L * NUM_CHAINS / wall
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    print(f"predict wall: {wall:.2f} s ({num_steps}+{num_steps} steps, "
          f"{NUM_CHAINS} chains, L<={NUM_LEAPFROGS}); "
          f"{predict_phases(model, wall)}")
    print(f"mean acceptance {kr['accept_probs'].mean():.4f}, divergence "
          f"rate {kr['divergences'].mean():.5f}, step size "
          f"{float(kr['step_size']):.5f}")
    print(f"theta pooled means {np.round(theta_mean, 4).tolist()} "
          f"(truth {TRUE_THETAS.tolist()})")
    print(f"ESS_min {summ['ess_min']:.1f}, rhat_max {summ['rhat_max']:.4f}, "
          f"ESS/s {summ['ess_per_sec_min']:.2f}")
    print(f"fused evals/s (sampler-derived): {evals:.4g}")
    print(f"launch counts: {counts}")

    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("non-finite draws")
    check_launched(counts, mf.KERNELS + ("leapfrog_update",), "SEIR")
    check_replays(graphs, 2 * num_steps, "SEIR")
    if not summ["rhat_max"] <= 1.05:
        raise AssertionError(f"rhat_max {summ['rhat_max']:.4f} > 1.05")
    rel = np.abs(theta_mean - TRUE_THETAS) / TRUE_THETAS
    if not np.all(rel <= 0.15):
        raise AssertionError(f"theta means {theta_mean} off truth by {rel}")
    return model, counts


# 200 + 200 since the refresh, staging and sharding phases joined the smoke
# (500 + 500 from the Hes1 path on, 1000 + 1000 before), to keep the
# smoke's wall inside its limit
NUTS_STEPS = 200
NUTS_RECIPE = dict(mass_matrix="dense", anneal_mode="reference",
                   dense_shrinkage=0.2, mass_window=(0.25, 0.45),
                   mass_window2=(0.50, 0.72), mass_window1_diag=True)


def nuts_path(model, device, num_steps=NUTS_STEPS):
    """The SEIR predict with the default algorithm (NUTS, trees up to the
    config's depth 10) and otherwise the bench recipe, on the HMC phase's
    fit: 256 chains, dense metric, float32. Fails on non-finite draws, a
    kernel that never launched, a transition that replayed no leaf,
    rhat_max > 1.05 or a theta mean more than 15% from truth. Returns the
    launch counts and the kernel results."""
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(num_results=num_steps, num_burnin_steps=num_steps,
                        num_chains=NUM_CHAINS, seed=0, init_jitter=0.01,
                        **NUTS_RECIPE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()

    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    transitions = 2 * num_steps
    depths, leaves = kr["depths"], kr["num_leapfrogs"]
    # in masked lockstep a transition replays every leaf of every doubling
    # up to its deepest chain's depth
    replayed = 2.0 ** depths.max(axis=1) - 1.0
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    print(f"SEIR NUTS predict wall: {wall:.2f} s ({num_steps}+{num_steps} "
          f"transitions, {NUM_CHAINS} chains, max tree depth "
          f"{model.config.max_tree_depth}); {predict_phases(model, wall)}")
    print(f"SEIR NUTS sampling phase: mean depth {depths.mean():.3f} "
          f"(max {depths.max()}), mean leaves a chain and transition "
          f"{leaves.mean():.2f}, leaves replayed a transition "
          f"{replayed.mean():.2f} (so {1 - leaves.mean() / replayed.mean():.1%}"
          f" of the replayed leaf work is masked), divergence rate "
          f"{kr['divergences'].mean():.5f}, mean acceptance "
          f"{kr['accept_probs'].mean():.4f}, step size "
          f"{float(kr['step_size']):.5f}")
    print(f"SEIR NUTS over the predict: {graphs['nuts_leaf']} leaves "
          f"replayed ({graphs['nuts_leaf'] / transitions:.2f} a transition), "
          f"{graphs['nuts_prologue']} doublings, so "
          f"{graphs['nuts_prologue'] / transitions:.2f} reads of the device "
          "a transition")
    print(f"SEIR NUTS: theta pooled means {np.round(theta_mean, 4).tolist()} "
          f"(truth {TRUE_THETAS.tolist()}); ESS_min {summ['ess_min']:.1f}, "
          f"rhat_max {summ['rhat_max']:.4f}, ESS/s "
          f"{summ['ess_per_sec_min']:.2f}")
    print(f"SEIR NUTS launch counts: {counts}; CUDA graphs {graphs}")
    # K2 opens a doubling's first leaf (the prologue) and starts a
    # transition (the root); every other leaf is opened by the leaf kernel
    k2_graphs = graphs.get("nuts_root", 0) + graphs.get("nuts_prologue", 0)
    print(f"SEIR NUTS launches a leaf replayed: leaf kernel "
          f"{counts['nuts_leaf'] / graphs['nuts_leaf']:.4f}, K2 "
          f"{(counts['leapfrog_update'] - k2_graphs) / graphs['nuts_leaf']:.4f}"
          f" (K2's {counts['leapfrog_update']} launches less the "
          f"{k2_graphs} root and prologue replays: the step-size search's "
          "and the captures' first runs)")

    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("SEIR NUTS: non-finite draws")
    check_launched(counts, mf.KERNELS + ("leapfrog_update", "nuts_leaf"),
                   "SEIR NUTS")
    if not (graphs["captures"] == 5
            and graphs.get("nuts_start", 0) == transitions
            and graphs.get("nuts_leaf", 0) >= transitions):
        raise AssertionError(f"SEIR NUTS: not every one of {transitions} "
                             f"transitions replayed its leaves: {graphs}")
    if not (counts["nuts_leaf"] >= graphs["nuts_leaf"]
            and counts["leapfrog_update"] - k2_graphs < transitions):
        raise AssertionError("SEIR NUTS: the leaves launched K2 or not the "
                             f"leaf kernel: {counts}, {graphs}")
    if not summ["rhat_max"] <= 1.05:
        raise AssertionError(f"SEIR NUTS: rhat_max {summ['rhat_max']:.4f} > "
                             "1.05")
    rel = np.abs(theta_mean - TRUE_THETAS) / TRUE_THETAS
    if not np.all(rel <= 0.15):
        raise AssertionError(f"SEIR NUTS: theta means {theta_mean} off truth "
                             f"by {rel}")
    return counts, kr


# the whitened SEIR path: predict's default NUTS in the GP prior's
# whitened coordinates, otherwise the SEIR NUTS path's recipe; 100 + 100
# since the refresh, staging and sharding phases joined the smoke (300 +
# 300 before), to keep its wall inside its limit
WHITENED_STEPS = 100


def whitened_path(model, device, num_steps=WHITENED_STEPS):
    """``predict(reparam="whitened")`` on the HMC phase's SEIR fit: NUTS
    (trees up to depth 10), 256 chains, ``num_steps`` + ``num_steps``
    transitions, dense storage and metric, float32. Fails on non-finite
    draws, K1's fwd launched in its GN form or its whitened form never, a
    transition that replayed no leaf, or a theta mean more than 15% from
    truth; rhat, ESS, depth, leaves and the step are printed only (these
    coordinates keep the manifold's stiffness that the GN whitening
    removes). Returns the launch counts and the kernel results."""
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(num_results=num_steps, num_burnin_steps=num_steps,
                        num_chains=NUM_CHAINS, seed=0, init_jitter=0.01,
                        reparam="whitened", **NUTS_RECIPE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()

    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    transitions = 2 * num_steps
    depths, leaves = kr["depths"], kr["num_leapfrogs"]
    replayed = 2.0 ** depths.max(axis=1) - 1.0
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    print(f"SEIR whitened predict wall: {wall:.2f} s ({num_steps}+"
          f"{num_steps} transitions, {NUM_CHAINS} chains, NUTS, max tree "
          f"depth {model.config.max_tree_depth}); "
          f"{predict_phases(model, wall)}")
    print(f"SEIR whitened sampling phase: mean depth {depths.mean():.3f} "
          f"(max {depths.max()}), mean leaves a chain and transition "
          f"{leaves.mean():.2f}, leaves replayed a transition "
          f"{replayed.mean():.2f}, {graphs.get('nuts_leaf', 0)} leaves "
          f"replayed in all, divergence rate {kr['divergences'].mean():.5f}"
          f", mean acceptance {kr['accept_probs'].mean():.4f}, step size "
          f"{float(kr['step_size']):.5f}")
    print(f"SEIR whitened: theta pooled means "
          f"{np.round(theta_mean, 4).tolist()} (truth "
          f"{TRUE_THETAS.tolist()}); ESS_min {summ['ess_min']:.1f}, rhat_max "
          f"{summ['rhat_max']:.4f}, ESS/s {summ['ess_per_sec_min']:.2f}")
    print(f"SEIR whitened launch counts: {counts}; CUDA graphs {graphs}")

    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("SEIR whitened: non-finite draws")
    check_launched(counts, ["manifold_fwd_whitened_seir", "manifold_energy",
                            "manifold_bwd", "leapfrog_update", "nuts_leaf"],
                   "SEIR whitened")
    if counts["manifold_fwd_seir"] != 0:
        raise AssertionError("SEIR whitened: K1's fwd launched in its GN "
                             f"form: {counts}")
    if not (graphs.get("nuts_start", 0) == transitions
            and graphs.get("nuts_leaf", 0) >= transitions):
        raise AssertionError(f"SEIR whitened: not every one of {transitions}"
                             f" transitions replayed its leaves: {graphs}")
    rel = np.abs(theta_mean - TRUE_THETAS) / TRUE_THETAS
    if not np.all(rel <= 0.15):
        raise AssertionError(f"SEIR whitened: theta means {theta_mean} off "
                             f"truth by {rel}")
    return counts, kr


def warmstart_check(model, device, iters=200):
    """predict's ``map_warmstart_iters`` on the SEIR fit (precond, dense):
    ``iters`` Adam steps on the float32 target at beta 1 from the start
    near the fit, whose log-posterior must rise; then a short predict that
    takes them runs."""
    from magi_v2_tpu_torch.api import map_warmstart

    mode, _, _ = model._build_sampling_setup("precond", "dense",
                                             torch.float32)
    q0 = np.concatenate([mode.X0.cpu().numpy().ravel(), SEIR_TAIL])
    t0 = time.perf_counter()
    _, vals = map_warmstart(mode.logp_grad, q0, iters,
                            model.config.init_learning_rate, torch.float32,
                            device)
    wall = time.perf_counter() - t0
    print(f"map_warmstart on SEIR (precond, dense): lp {vals[0]:.3f} -> "
          f"{vals[-1]:.3f} over {iters} Adam steps ({wall:.2f} s)")
    if not vals[-1] > vals[0]:
        raise AssertionError("map_warmstart: the log-posterior did not rise")
    res = model.predict(num_results=20, num_burnin_steps=20, num_chains=16,
                        seed=0, algorithm="hmc", hmc_num_leapfrogs=16,
                        mass_matrix="diag", map_warmstart_iters=iters)
    torch.cuda.synchronize()
    if not np.all(np.isfinite(res["thetas_samps"])):
        raise AssertionError("map_warmstart: non-finite draws")
    print(f"predict(map_warmstart_iters={iters}): phases "
          + ", ".join(f"{k} {v:.2f}" for k, v in model.predict_timings.items()))


# The SEIR L-BFGS and forecast block: the SEIR data's fit with
# hparam_optimizer="lbfgs", the NUTS recipe's predict from it, then the grid
# extended to t = 5 at its spacing (N_I = 161 -> 201, a flat state and a
# dense metric 609 wide) and the recipe again there; then checkpoint/resume
# and a device trace on the extended model.
FORECAST_T_MAX = 5.0
FORECAST_GRID = 201
# the starting predict cut from 300 + 300 to keep the smoke's wall inside
# its limit (it only starts the forecast), the forecast's from 500 + 500
# when the refresh, staging and sharding phases joined the smoke
FORECAST_START_STEPS, FORECAST_STEPS = 150, 200
# K2's NUTS form and the leaf kernel at the forecast's dense metric
FORECAST_CASES = (("dense609", 609, 609),)
# an L-BFGS fit may end at most this far above Adam-1000's objective (the
# JAX package's own bound, tests/test_lbfgs.py)
LBFGS_SLACK = 1e-3
# the resume check: chains, transitions a phase, transitions a block
RESUME_CHAINS, RESUME_STEPS, RESUME_BLOCK = 64, 100, 25


def lbfgs_fit(device, adam_model):
    """``initial_fit(1)`` with ``MagiConfig(hparam_optimizer="lbfgs")`` on
    the SEIR path's data on the card (the fit in float64, sampling in
    float32). Prints its ``hparam_mle`` wall beside the Adam fit's
    (``adam_model``, the SEIR path's), L-BFGS's iterations (from a second,
    timed call of the fit), both final objectives and the fitted phi and
    sigma^2. Fails unless L-BFGS's objective is at most Adam's +
    LBFGS_SLACK and theta_init is finite."""
    from magi_v2_tpu_torch import MAGI_v2, MagiConfig, hparams, preprocess
    from magi_v2_tpu_torch.models import seir_f_vec
    from magi_v2_tpu_torch.posterior import softplus_inverse

    ts, X_obs, _ = seir_data()
    cfg = MagiConfig(dtype=torch.float32, device=str(device),
                     hparam_optimizer="lbfgs")
    model = MAGI_v2(D_thetas=3, ts_obs=ts, X_obs=X_obs, bandsize=80,
                    f_vec=seir_f_vec, config=cfg)
    t0 = time.perf_counter()
    model.initial_fit(discretization=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # the objective both fits minimize (hparam_fit_points="obs")
    I_fit, X_fit = ts.reshape(-1, 1), preprocess.linear_interpolate(X_obs)
    prior = hparams.fourier_prior(X_fit, t_range=float(ts[-1] - ts[0]))
    neg_map, _ = hparams.make_hparam_objective(
        I_fit, X_fit, prior, cfg.matern_nu, jitter=cfg.cholesky_jitter,
        device=device)

    def objective(m):
        pre = lambda a: softplus_inverse(torch.as_tensor(
            a, dtype=torch.float64, device=device))
        return float(neg_map({"phi1_pre": pre(m.phi1s),
                              "phi2_pre": pre(m.phi2s),
                              "sigma_sq_pre": pre(m.sigma_sqs_init)}))

    f_lbfgs, f_adam = objective(model), objective(adam_model)
    t0 = time.perf_counter()
    hp = hparams.fit_kernel_hparams(
        I_fit, X_fit, nu=cfg.matern_nu, num_iters=cfg.hparam_num_iters,
        cholesky_jitter=cfg.cholesky_jitter, optimizer="lbfgs",
        device=device)
    again_s = time.perf_counter() - t0
    # the trace repeats the final loss after the last iteration (Armijo
    # lowers it at every iteration before)
    losses = hp["losses"]
    iters = int(np.argmax(losses == losses[-1])) + 1
    sci = lambda a: ", ".join(np.format_float_scientific(v, 4) for v in a)
    rnd = lambda a: np.round(a, 6).tolist()
    print(f"SEIR L-BFGS fit: initial_fit {setup_s:.2f} s "
          f"{model.fit_timings}; hparam_mle "
          f"{model.fit_timings['hparam_mle']:.2f} s (Adam-"
          f"{adam_model.config.hparam_num_iters} "
          f"{adam_model.fit_timings['hparam_mle']:.2f} s in this smoke); "
          f"{iters} L-BFGS iterations ({again_s:.2f} s a second time); "
          f"objective {f_lbfgs:.6f} (Adam {f_adam:.6f}, difference "
          f"{f_lbfgs - f_adam:.3e}); phi1 {rnd(model.phi1s)} (Adam "
          f"{rnd(adam_model.phi1s)}), phi2 {rnd(model.phi2s)} (Adam "
          f"{rnd(adam_model.phi2s)}), sigma^2 {sci(model.sigma_sqs_init)} "
          f"(Adam {sci(adam_model.sigma_sqs_init)}); thetas_init "
          f"{np.round(model.thetas_init, 4).tolist()}")
    if not f_lbfgs <= f_adam + LBFGS_SLACK:
        raise AssertionError(f"L-BFGS fit: objective {f_lbfgs} above Adam's "
                             f"{f_adam} + {LBFGS_SLACK}")
    if not np.all(np.isfinite(model.thetas_init)):
        raise AssertionError("L-BFGS fit: theta_init not finite")
    return model


def seir_nuts_predict(model, num_steps, num_chains=NUM_CHAINS, seed=0,
                      **kw):
    """The SEIR NUTS recipe's predict on ``model``: (results, wall,
    launch counts, graph counts), the counts from this predict alone."""
    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(num_results=num_steps, num_burnin_steps=num_steps,
                        num_chains=num_chains, seed=seed, init_jitter=0.01,
                        **NUTS_RECIPE, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, launch_counts(), graph_counts()


def forecast_start(model, num_steps=FORECAST_START_STEPS):
    """The NUTS recipe on the L-BFGS fit, 256 chains: the draws the
    forecast starts from. Fails on non-finite draws."""
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    res, wall, _, _ = seir_nuts_predict(model, num_steps)
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    print(f"SEIR L-BFGS fit, NUTS predict wall: {wall:.2f} s ({num_steps}+"
          f"{num_steps} transitions, {NUM_CHAINS} chains); "
          f"{predict_phases(model, wall)}; theta pooled means "
          f"{np.round(thetas.reshape(-1, 3).mean(axis=0), 4).tolist()}, "
          f"rhat_max {summ['rhat_max']:.4f}, ESS_min {summ['ess_min']:.1f}")
    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("SEIR L-BFGS predict: non-finite draws")
    return res


def forecast_kernels(device):
    """K1 at the forecast's N_I = 201 (256 chains), K2's NUTS form and the
    leaf kernel at its dense 609 metric (256 chains), against their plain
    versions, each launch twice bit for bit; the float32 numbers under
    ``*_seir_forecast`` names."""
    timing = check_kernels(device, N=FORECAST_GRID, tag="_seir_forecast")
    record = lambda name: (FORECAST_CASES[0][0], NUM_CHAINS, name)
    timing.update(check_leapfrog_nuts(
        device, chains=(NUM_CHAINS,), cases=FORECAST_CASES,
        record=record("leapfrog_update_nuts_seir_forecast")))
    timing.update(check_nuts_leaf(
        device, chains=(NUM_CHAINS,), cases=FORECAST_CASES,
        record=record("nuts_leaf_seir_forecast")))
    return timing


def forecast_path(model, start, num_steps=FORECAST_STEPS):
    """``extend_for_forecast(5.0, results=start)`` and the NUTS recipe on
    the extended grid, 256 chains. Prints the forecast's posterior-mean
    RMSE and the 95% band's coverage of the true trajectory (simulated to
    t = 5) on (4, 5]. Fails on non-finite draws, K1 or the leaf kernel not
    launched, rhat_max > 1.05 or a theta mean more than 15% from truth.
    Returns the launch counts."""
    from magi_v2_tpu_torch.models import seir_f_vec
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.utils.data import simulate_ode
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    n_old = model.mag_I
    t0 = time.perf_counter()
    model.extend_for_forecast(FORECAST_T_MAX, results=start)
    extend_s = time.perf_counter() - t0
    if model.mag_I != FORECAST_GRID:
        raise AssertionError(f"forecast grid N_I {model.mag_I}, expected "
                             f"{FORECAST_GRID}")
    res, wall, counts, graphs = seir_nuts_predict(model, num_steps)
    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    _, _, X_true = simulate_ode(seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
                                thetas=TRUE_THETAS, t_max=FORECAST_T_MAX,
                                n_obs=FORECAST_GRID, noise_sd=0.0)
    future = model.I[:, 0] > 4.0 + 1e-9
    X = res["X_samps"][:, :, future].reshape(-1, future.sum(), 3)
    mean = X.mean(axis=0)
    lo, hi = np.quantile(X, [0.025, 0.975], axis=0)
    truth = X_true[future]
    rmse = np.sqrt(((mean - truth) ** 2).mean(axis=0))
    covered = ((truth >= lo) & (truth <= hi)).mean(axis=0)
    print(f"SEIR forecast: extend_for_forecast({FORECAST_T_MAX}) N_I "
          f"{n_old} -> {model.mag_I} in {extend_s:.2f} s; predict wall "
          f"{wall:.2f} s ({num_steps}+{num_steps} transitions, {NUM_CHAINS} "
          f"chains, dense metric {3 * model.mag_I + 6} wide); "
          f"{predict_phases(model, wall)}")
    print(f"SEIR forecast: mean depth {kr['depths'].mean():.3f}, mean leaves "
          f"a chain {kr['num_leapfrogs'].mean():.2f}, step size "
          f"{float(kr['step_size']):.5f}, mean acceptance "
          f"{kr['accept_probs'].mean():.4f}, divergence rate "
          f"{kr['divergences'].mean():.5f}; theta pooled means "
          f"{np.round(theta_mean, 4).tolist()} (truth "
          f"{TRUE_THETAS.tolist()}), rhat_max {summ['rhat_max']:.4f}, ESS_min "
          f"{summ['ess_min']:.1f}, ESS/s {summ['ess_per_sec_min']:.2f}")
    print(f"SEIR forecast on (4, 5] ({int(future.sum())} grid points): "
          f"posterior-mean RMSE by component "
          + ", ".join(np.format_float_scientific(v, 3) for v in rmse)
          + "; 95% band covers the "
          f"true trajectory at {np.round(covered, 3).tolist()} "
          f"(all {covered.mean():.3f})")
    print(f"SEIR forecast launch counts: {counts}; CUDA graphs {graphs}")
    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("SEIR forecast: non-finite draws")
    check_launched(counts, mf.KERNELS + ("nuts_leaf",), "SEIR forecast")
    if not summ["rhat_max"] <= 1.05:
        raise AssertionError(f"SEIR forecast: rhat_max {summ['rhat_max']:.4f}"
                             " > 1.05")
    rel = np.abs(theta_mean - TRUE_THETAS) / TRUE_THETAS
    if not np.all(rel <= 0.15):
        raise AssertionError(f"SEIR forecast: theta means {theta_mean} off "
                             f"truth by {rel}")
    return counts


def _same_results(a, b, what):
    keys = ("X_samps", "thetas_samps", "sigma_sqs_samps")
    same = all(np.array_equal(a[k], b[k]) for k in keys) and all(
        (v is None and b["kernel_results"][k] is None)
        or np.array_equal(v, b["kernel_results"][k])
        for k, v in a["kernel_results"].items())
    if not same:
        raise AssertionError(f"{what}: the resumed run's draws or stats "
                             "differ from the uninterrupted run's")


def resume_check(model):
    """Checkpoint/resume on the card: the NUTS recipe on the forecast model,
    RESUME_CHAINS chains x RESUME_STEPS + RESUME_STEPS, blocks of
    RESUME_BLOCK transitions: once uninterrupted with profile_timings
    (its timings printed), once crashed after the second sampling block's
    draws and resumed, once crashed after the second warmup block and
    resumed. Fails unless both resumed runs equal the uninterrupted one
    bit for bit."""
    import tempfile

    import magi_v2_tpu_torch.sampler.run as run_mod

    kw = dict(num_chains=RESUME_CHAINS, seed=5,
              dispatch_block_steps=RESUME_BLOCK)
    ref, wall, _, _ = seir_nuts_predict(model, RESUME_STEPS,
                                        profile_timings=True, **kw)
    t = ref["timings"]
    print(f"resume check: uninterrupted predict {wall:.2f} s, timings "
          + ", ".join(f"{k} {np.round(v, 4).tolist()}" for k, v in t.items()))
    save_draws, save_state = run_mod._ckpt_save_draws, run_mod._ckpt_save_state
    calls = {"draws": 0}

    def crash_sampling(dirpath, start, s_blk, info):
        calls["draws"] += 1
        if calls["draws"] > 2:
            raise RuntimeError("injected crash after two sampling blocks")
        save_draws(dirpath, start, s_blk, info)

    def crash_warmup(dirpath, phase, nxt, carry, fp):
        save_state(dirpath, phase, nxt, carry, fp)
        if phase == "warmup" and nxt >= 2 * RESUME_BLOCK:
            raise RuntimeError("injected crash after two warmup blocks")

    for what, name, crash in (("mid-sampling", "_ckpt_save_draws",
                               crash_sampling),
                              ("mid-warmup", "_ckpt_save_state",
                               crash_warmup)):
        with tempfile.TemporaryDirectory() as ck:
            setattr(run_mod, name, crash)
            try:
                t0 = time.perf_counter()
                try:
                    seir_nuts_predict(model, RESUME_STEPS, checkpoint_path=ck,
                                      **kw)
                except RuntimeError as e:
                    if "injected crash" not in str(e):
                        raise
                else:
                    raise AssertionError(f"resume check {what}: the crash "
                                         "was not injected")
                crashed_s = time.perf_counter() - t0
            finally:
                run_mod._ckpt_save_draws = save_draws
                run_mod._ckpt_save_state = save_state
            files = sorted(os.listdir(ck))
            out, resumed_s, _, _ = seir_nuts_predict(
                model, RESUME_STEPS, checkpoint_path=ck, **kw)
        _same_results(ref, out, f"resume check {what}")
        print(f"resume check {what}: crashed run {crashed_s:.2f} s (left "
              f"{files}), resumed run {resumed_s:.2f} s; draws and stats "
              "equal the uninterrupted run's bit for bit")


def trace_check(model, device, steps=5):
    """One short predict of the forecast model inside
    ``utils.profiling.device_trace``: fails unless the profiler names K1's
    three kernels and the Chrome trace file holds them."""
    import tempfile

    from magi_v2_tpu_torch.utils.profiling import device_trace

    k1 = ("manifold_fwd_kernel", "manifold_energy_kernel",
          "manifold_bwd_kernel")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with device_trace(d) as prof:
            model.predict(num_results=steps, num_burnin_steps=steps,
                          num_chains=RESUME_CHAINS, seed=1, **NUTS_RECIPE)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(d, "trace.json")) as fh:
            text = fh.read()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    found = {k: sum(e.count for e in prof.key_averages()
                    if k in e.key and e.device_type
                    == torch.autograd.DeviceType.CUDA) for k in k1}
    print(f"device_trace of a {steps}+{steps} predict ({wall:.2f} s with "
          f"the profiler): {len(names)} device kernels by name, K1's "
          f"launches {found}, trace.json {len(text) / 1e6:.1f} MB")
    if not (all(found.values()) and all(k in text for k in k1)):
        raise AssertionError(f"device_trace: K1's kernels are missing from "
                             f"the trace: {found}")


# the sigma_pre and theta_pre of the SEIR states near the fit
SEIR_TAIL = (-10.5, -10.5, -10.5, 1.8, -0.5, 0.6)
# and of the Lorenz states
LORENZ_TAIL = (-1.5, -1.5, -1.5, 10.0, 28.0, 2.6)


def _nuts_setup(model, device, kr, num_chains=NUM_CHAINS, seed=2,
                reparam="precond", tail=SEIR_TAIL, sigma_sqs_fixed=None,
                start=None):
    """The float32 target of ``reparam`` in dense storage (sigma pinned at
    ``sigma_sqs_fixed`` if given), states near the fit (``tail`` their
    sigma_pre and theta_pre) or ``start`` (C, dim), and the mass and step
    size the NUTS predict adapted (``kr``, its kernel results)."""
    from magi_v2_tpu_torch.sampler.mass import mass_from_moments

    kw = ({} if sigma_sqs_fixed is None
          else {"sigma_sqs_fixed": sigma_sqs_fixed})
    mode, _, _ = model._build_sampling_setup(reparam, "dense",
                                             torch.float32, **kw)
    N, D = model.mag_I, model.D
    dim = N * D + D + model.D_thetas
    g = torch.Generator(device=device).manual_seed(seed)
    q0 = torch.cat([mode.X0.reshape(-1).float(),
                    torch.tensor(tail, dtype=torch.float32, device=device)])
    if start is None:
        qs = q0 + 0.01 * torch.randn((num_chains, dim), generator=g,
                                     device=device)
    else:
        qs = torch.as_tensor(start, dtype=torch.float32, device=device)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    mass = (t(kr["inv_mass"]) if kr["tail_inv_mass"] is None
            else mass_from_moments(t(kr["inv_mass"]),
                                   t(kr["tail_inv_mass"])))
    eps = t(kr["step_size"])
    return mode.logp_grad, qs, mass, eps, g


def nuts_graph_vs_eager(model, device, kr, transitions=20, label="SEIR NUTS",
                        beta_temp=0.15, **setup):
    """``BoundNuts`` (captured CUDA graphs, replayed) against the eager
    ``nuts_step`` on a float32 target (``_nuts_setup``'s, with ``setup``:
    by default SEIR's), ``transitions`` times from the same state with the
    same noise, at the predict's adapted step size and mass and at
    ``beta_temp``: states and every info field must agree bit for bit.
    Returns the bound transition, its last state and noise, and the step,
    mass and temperature, for a profile."""
    from magi_v2_tpu_torch.sampler.nuts import (
        BoundNuts,
        NutsConfig,
        draw_noise,
        nuts_step,
    )

    target, qs, mass, eps, g = _nuts_setup(model, device, kr, **setup)
    C, dim = qs.shape
    cfg = NutsConfig(model.config.max_tree_depth)
    bt = torch.tensor(beta_temp, device=device)
    bound = BoundNuts(target, qs, mass, cfg)
    qe = qb = qs
    same, depths = 0, []
    for _ in range(transitions):
        noise = draw_noise(g, C, dim, cfg.max_tree_depth, torch.float32,
                           device)
        qe2, ie = nuts_step(lambda q: target(q, bt), qe, eps, mass, noise,
                            cfg)
        qb2, ib = bound(qb, eps, mass, bt, noise)
        depths.append(int(ie.depth.max()))
        if torch.equal(qe2, qb2) and all(torch.equal(a, b)
                                         for a, b in zip(ie, ib)):
            same += 1
        qe, qb = qe2, qb2
    torch.cuda.synchronize()
    print(f"{label}: graph against eager, {transitions} transitions of "
          f"{C} chains (step {float(eps):.4g}, deepest trees {depths}): "
          f"{same} of {transitions} bit for bit")
    if same < transitions:
        raise AssertionError(f"{label}: the replayed transition differs "
                             "from the eager one")
    return bound, qb, noise, eps, mass, bt


def kernel_counts(run):
    """{kernel name: launches} of ``run()`` on the card, as torch.profiler
    records them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def profile_nuts(model, device, kr, replays=100, settle=10, counted=20,
                 reparam="precond", label="SEIR NUTS"):
    """Where a NUTS transition's time goes on the SEIR float32 path (in the
    coordinates of ``reparam``; ``label`` names it in the output), at the
    sampling phase's temperature, step and mass, from a state ``settle``
    transitions on from the fit: the launches a leaf holds (the leaf
    kernel once beside the evaluation's, no K2, no counter op); one leaf's
    graph replayed back to back with every chain active at leaf 0 of
    doubling 4 (restored before each replay), host us to enqueue and ms
    each until the card finished, and torch.profiler's device time by
    kernel over one leaf; over ``counted`` transitions the
    leaf replays in which no chain was still active (per doubling, 2^d less
    the most leaves a chain that ran it took); one transition's wall and
    leaves replayed; the device time by kernel and busy share over one
    transition."""
    from magi_v2_tpu_torch.sampler.nuts import (
        BoundNuts,
        NutsConfig,
        draw_noise,
    )

    target, qs, mass, eps, g = _nuts_setup(model, device, kr,
                                           reparam=reparam)
    C, dim = qs.shape
    cfg = NutsConfig(model.config.max_tree_depth)
    bt = torch.tensor(1.0 / np.log(2002.0), device=device)
    bound = BoundNuts(target, qs, mass, cfg)
    for _ in range(settle):
        noise = draw_noise(g, C, dim, cfg.max_tree_depth, torch.float32,
                           device)
        qs, _ = bound(qs, eps, mass, bt, noise)
    torch.cuda.synchronize()
    leaf = bound.graphs["nuts_leaf"]
    held = {k: n for counts in leaf.launches for k, n in counts.items()}
    ctr0 = torch.tensor([4, 0], dtype=torch.int32, device=device)

    def rearm():
        bound.ctr.copy_(ctr0)
        bound.active.fill_(True)

    def one_leaf():
        rearm()
        leaf.replay()

    in_leaf = kernel_counts(one_leaf)
    by_name = lambda part: sum(n for k, n in in_leaf.items() if part in k)
    fused, k2 = by_name("nuts_leaf_kernel"), by_name("leapfrog_kernel")
    # the counter's add, were it a PyTorch op (an int32 add)
    counter = by_name("CUDAFunctor_add<int>")
    print(f"{label}: a leaf's graph launches {held} of the port's "
          f"kernels; on the card it ran the leaf kernel {fused} time(s), "
          f"K2 {k2}, an integer add {counter}, and in all "
          f"{sum(in_leaf.values())} kernels (the evaluation's and the "
          "re-arming's with it)")
    if not (held.get("nuts_leaf") == 1 and "leapfrog_update" not in held
            and fused == 1 and k2 == 0 and counter == 0):
        raise AssertionError(f"{label}: a leaf is not its evaluation and "
                             f"one launch of the leaf kernel: {held}, "
                             f"{in_leaf}")
    for _ in range(3):
        one_leaf()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(replays):
        one_leaf()
    host_us = (time.perf_counter() - t0) / replays * 1e6
    torch.cuda.synchronize()
    leaf_ms = (time.perf_counter() - t0) / replays * 1e3
    print(f"{label}: one leaf replayed {replays} times back to back, every "
          f"chain active (re-armed before each replay): host {host_us:.2f} "
          f"us to enqueue, {leaf_ms:.4f} ms each until the card finished")
    device_profile(one_leaf, f"{label} one leaf")
    # the replays in which no chain was still active
    idle = [0, 0]

    def count(d):
        ran = ~bound.terminated
        most = int(bound.sub_n[ran].max()) if bool(ran.any()) else 0
        idle[0] += (1 << d) - most
        idle[1] += 1 << d

    for _ in range(counted):
        noise = draw_noise(g, C, dim, cfg.max_tree_depth, torch.float32,
                           device)
        qs, _ = bound(qs, eps, mass, bt, noise, on_doubling=count)
    print(f"{label}: over {counted} settled transitions {idle[0]} of "
          f"{idle[1]} leaf replays had no chain still active "
          f"({idle[0] / idle[1]:.1%}): what stopping a doubling once every "
          "chain's subtree has ended would save")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, info = bound(qs, eps, mass, bt, noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    d = int(info.depth.max())
    print(f"{label}: one transition (deepest tree {d}, "
          f"{2 ** d - 1} leaves replayed, mean leaves a chain "
          f"{float(info.num_leapfrogs.float().mean()):.2f}): ms "
          f"{[round(w, 3) for w in walls]}")
    device_profile(lambda: bound(qs, eps, mass, bt, noise),
                   f"{label} replayed")


def fitzhugh_nagumo_f_vec(t, X, thetas):
    """FitzHugh-Nagumo, X = (V, R), thetas = (a, b, c), over leading batch
    axes: an ODE field registered nowhere, so with no CUDA functor."""
    V, R = X[..., 0:1], X[..., 1:2]
    a, b, c = (thetas[..., None, i:i + 1] for i in range(3))
    return torch.cat([c * (V - V ** 3 / 3.0 + R), -(V - a + b * R) / c],
                     dim=-1)


FHN_CHAINS, FHN_GRID = 16, 81


def unregistered_field(device, steps=100, chains=FHN_CHAINS):
    """A field with no CUDA functor on the card: FitzHugh-Nagumo (41
    observations on [0, 20], noise sd 0.2) fitted on the CPU in float64,
    then its composed float64 target on the card against the CPU's, and
    predict with HMC and with NUTS on the card (float32) against the CPU
    (float64): theta means within 5 combined Monte-Carlo standard errors.
    K1 takes its given kernels for this field (PyTorch evaluates the field
    and its VJPs on the card): K1, K2 (and for NUTS the leaf kernel) must
    launch.
    Returns the launch counts of the two predicts together."""
    from magi_v2_tpu_torch import MAGI_v2, MagiConfig
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays
    from magi_v2_tpu_torch.utils.data import simulate_ode
    from magi_v2_tpu_torch.utils.diagnostics import effective_sample_size

    f = fitzhugh_nagumo_f_vec
    ts, X, _ = simulate_ode(f, x0=np.array([-1.0, 1.0]),
                            thetas=np.array([0.2, 0.2, 3.0]), t_max=20.0,
                            n_obs=41, noise_sd=0.2)
    # trees up to depth 6: the CPU run's leaves are eager PyTorch calls
    cpu = MAGI_v2(3, ts, X, None, f, MagiConfig(device="cpu",
                                                 hparam_num_iters=300,
                                                 init_num_iters=2000,
                                                 max_tree_depth=6))
    cpu.initial_fit(1)
    if cpu.mag_I != FHN_GRID:
        raise AssertionError(f"FitzHugh-Nagumo's grid has {cpu.mag_I} points"
                             f", the kernel checks took {FHN_GRID}")
    arrays = {k: getattr(cpu, k) for k in FIT_FIELDS}
    card = from_fit_arrays(arrays, f, 3, config=cpu.config.replace(
        device=str(device), dtype=torch.float32))
    tail = tuple([-3.0, -3.0] + np.log(np.expm1(cpu.thetas_init)).tolist())
    check_composed(card, device, tail=tail)
    total = {}
    for algorithm in ("hmc", "nuts"):
        kw = dict(num_results=steps, num_burnin_steps=steps,
                  num_chains=chains, seed=0, init_jitter=0.01,
                  algorithm=algorithm, hmc_num_leapfrogs=16,
                  mass_matrix="diag")
        reset_launch_counts()
        rc = card.predict(**kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        r64 = cpu.predict(**kw)
        means = []
        for p in range(3):
            a, b = rc["thetas_samps"][..., p], r64["thetas_samps"][..., p]
            se = np.hypot(a.std() / np.sqrt(effective_sample_size(a)),
                          b.std() / np.sqrt(effective_sample_size(b)))
            means.append((a.mean(), b.mean(), se))
        print(f"unregistered field (FitzHugh-Nagumo) {algorithm}: theta "
              "means card / CPU / combined MC se "
              + "; ".join(f"{a:.4f} / {b:.4f} / {se:.4f}"
                          for a, b, se in means)
              + f"; launch counts on the card {counts}")
        if not np.all(np.isfinite(rc["thetas_samps"])):
            raise AssertionError(f"unregistered field {algorithm}: "
                                 "non-finite draws on the card")
        need = [*mf.KERNELS, "leapfrog_update"] + (
            ["nuts_leaf"] if algorithm == "nuts" else [])
        check_launched(counts, need, f"unregistered field {algorithm}")
        if not all(abs(a - b) <= 5.0 * se for a, b, se in means):
            raise AssertionError(f"unregistered field {algorithm}: the card's "
                                 "theta means disagree with the CPU's")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


# The Hes1 recipe of examples/hes1.py: P and M observed on the log scale
# with noise sd 0.15, H never; 33 observations on [0, 240] simulated from
# x0 at the registry's true theta; discretization 2 (N_I = 129, a flat
# state of 397); beta = 1, sigma pinned at 0.15^2, centered coordinates,
# no annealing, NUTS with a diagonal metric.
HES1_X0 = np.array([1.439, 2.037, 17.904])
# 150 + 150 transitions since the refresh, staging and sharding phases
# joined the smoke (300 + 300 from the SEIR L-BFGS and forecast block on,
# 500 + 500 from the Laplace-start phase on, 1000 + 1000 before), to keep
# the smoke's wall inside its limit; the Laplace-start and PT runs take
# the same depth, so their H coverages compare
HES1_CHAINS, HES1_STEPS, HES1_GRID = 64, 150, 129
HES1_SIGMA = 0.15 ** 2
# the JAX package's converged recovery (results/hes1_long2.json: 16 chains
# x 3000 + 8000 NUTS transitions, centered, float64 on a CPU): theta's
# posterior mean and sd
HES1_REF_MEAN = np.array([0.0151, 0.3787, 0.0343, 0.0293, 0.5841, 27.1933,
                          0.1715])
HES1_REF_SD = np.array([0.0048, 0.0429, 0.0055, 0.0020, 0.0657, 13.1686,
                        0.0303])
# a chain whose mean f (theta[5]) is at most 8 has left the truth basin for
# the decoupled-H mode (scripts/hes1_long.py)
HES1_BASIN_F = 8.0
# K2's NUTS form and the leaf kernel at the Hes1 path's metric: a diagonal
# over the 397-wide state
HES1_NUTS_CASES = (("diag397", 397, 0),)
# the Laplace-start recipe (scripts/hes1_long.py --init laplace, its draws'
# seed 101), cut from 16 chains x 3000 + 8000 transitions
HES1_LAPLACE_STEPS = HES1_STEPS
# the JAX package's run from Laplace starts (results/hes1_laplace_r4.json:
# 16 chains x 3000 + 8000 NUTS transitions, centered, float32): theta's
# posterior mean and sd
HES1_LAPLACE_MEAN = np.array([0.0154, 0.3787, 0.0344, 0.0293, 0.5834,
                              26.5378, 0.1705])
HES1_LAPLACE_SD = np.array([0.005, 0.0437, 0.0055, 0.002, 0.0641, 12.6025,
                            0.0307])
# the most negative smallest-over-largest Hessian eigenvalue taken for
# positive: float64 roundoff of the eigendecomposition (the JAX package's
# Hessian at its Hes1 MAP has a smallest eigenvalue of 2.4e-16 of its
# largest)
HES1_SPD_ROUNDOFF = 1e-12


def h_coverage(res, logH_true):
    """The share of grid points where the true log H lies in the pooled
    95% band of the draws (scripts/hes1_long.py's H_coverage_95)."""
    H = np.asarray(res["X_samps"])[..., 2].reshape(-1, logH_true.size)
    lo, hi = np.quantile(H, [0.025, 0.975], axis=0)
    return float(((logH_true >= lo) & (logH_true <= hi)).mean())


def hes1_fit(device):
    """The Hes1 data and ``initial_fit(2)`` on the card at the config's
    full iteration counts (the partially observed branch: hyperparameters
    of P and M, gradient matching of (H, theta), H's hyperparameters on the
    grid), float32 sampling; then beta = 1. Returns the model and the
    true log H on the grid (for the band's coverage)."""
    from magi_v2_tpu_torch import MAGI_v2, MagiConfig
    from magi_v2_tpu_torch.models import MODEL_REGISTRY, hes1_log_f_vec
    from magi_v2_tpu_torch.utils.data import simulate_ode

    reg = MODEL_REGISTRY["hes1"]
    ts, _, X_true = simulate_ode(reg.f_vec, x0=HES1_X0,
                                 thetas=np.array(reg.true_thetas),
                                 t_max=240.0, n_obs=33, noise_sd=0.0,
                                 substeps=200)
    X = np.log(X_true) + 0.15 * np.random.default_rng(0).standard_normal(
        X_true.shape)
    X[:, 2] = np.nan
    model = MAGI_v2(7, ts, X, None, hes1_log_f_vec,
                    MagiConfig(dtype=torch.float32, device=str(device)))
    t0 = time.perf_counter()
    model.initial_fit(discretization=2)
    torch.cuda.synchronize()
    print(f"Hes1 setup (initial_fit, discretization 2): "
          f"{time.perf_counter() - t0:.2f} s {model.fit_timings}; N_I "
          f"{model.mag_I}, thetas_init "
          f"{np.round(model.thetas_init, 4).tolist()}, phi1s "
          f"{np.round(model.phi1s, 4).tolist()}, phi2s "
          f"{np.round(model.phi2s, 4).tolist()}")
    if model.mag_I != HES1_GRID or model.unobserved_components.tolist() != [2]:
        raise AssertionError("Hes1: the fit's grid or its unobserved "
                             "component is not the recipe's")
    model.beta = 1.0
    logH_true = np.interp(np.linspace(0, 240, model.mag_I),
                          np.linspace(0, 240, len(X_true)),
                          np.log(X_true[:, 2]))
    return model, logH_true


def hes1_path(model, device, logH_true, num_steps=HES1_STEPS):
    """The Hes1 recipe's predict on the card: 64 chains, ``num_steps`` +
    ``num_steps`` NUTS transitions in centered coordinates, float32. Fails
    on non-finite draws, K1 launched through its given kernels or not
    through the Hes1-log functor's, K2's NUTS form or the leaf kernel not
    launched, a transition that replayed no leaf, a chain outside the
    truth basin, or a pooled theta mean more than 3 posterior sd from the
    JAX package's recovery; rhat, ESS, depth, leaves and H's 95% band
    coverage of the true H are printed (the centered chains mix slowly).
    Returns the launch counts, the kernel results, the chains' last states
    and the coverage."""
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(num_chains=HES1_CHAINS, num_results=num_steps,
                        num_burnin_steps=num_steps, init_jitter=0.02, seed=0,
                        reparam="centered", use_annealing=False,
                        sigma_sqs_fixed=HES1_SIGMA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()

    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    transitions = 2 * num_steps
    depths, leaves = kr["depths"], kr["num_leapfrogs"]
    replayed = 2.0 ** depths.max(axis=1) - 1.0
    theta_mean = thetas.reshape(-1, 7).mean(axis=0)
    z = (theta_mean - HES1_REF_MEAN) / HES1_REF_SD
    f_chain = thetas[..., 5].mean(axis=0)
    print(f"Hes1 predict wall: {wall:.2f} s ({num_steps}+{num_steps} "
          f"transitions, {HES1_CHAINS} chains, centered, max tree depth "
          f"{model.config.max_tree_depth}); {predict_phases(model, wall)}")
    print(f"Hes1 sampling phase: mean depth {depths.mean():.3f} (max "
          f"{depths.max()}), mean leaves a chain and transition "
          f"{leaves.mean():.2f}, leaves replayed a transition "
          f"{replayed.mean():.2f} (so "
          f"{1 - leaves.mean() / replayed.mean():.1%} of the replayed leaf "
          f"work is masked), divergence rate {kr['divergences'].mean():.5f}"
          f", mean acceptance {kr['accept_probs'].mean():.4f}, step size "
          f"{float(kr['step_size']):.5f}")
    print(f"Hes1 over the predict: {graphs.get('nuts_leaf', 0)} leaves "
          f"replayed ({graphs.get('nuts_leaf', 0) / transitions:.2f} a "
          f"transition), {graphs.get('nuts_prologue', 0)} doublings")
    print(f"Hes1: theta pooled means {np.round(theta_mean, 4).tolist()} "
          f"(JAX recovery {HES1_REF_MEAN.tolist()}, in its sd "
          f"{np.round(z, 2).tolist()}); per-chain mean f from "
          f"{f_chain.min():.2f} to {f_chain.max():.2f}; ESS_min "
          f"{summ['ess_min']:.1f}, rhat_max {summ['rhat_max']:.4f}, ESS/s "
          f"{summ['ess_per_sec_min']:.2f}")
    print(f"Hes1 launch counts: {counts}; CUDA graphs {graphs}")
    coverage = h_coverage(res, logH_true)
    print(f"Hes1 (heuristic starts): H's 95% band covers the true H at "
          f"{coverage:.3f} of the grid")

    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("Hes1: non-finite draws")
    check_launched(counts, [f"{k}_hes1_log" for k in mf.KERNELS]
                   + ["leapfrog_update", "nuts_leaf"], "Hes1")
    given = {k: counts[f"{k}_given"] for k in mf.KERNELS}
    if any(given.values()):
        raise AssertionError(f"Hes1: K1 launched its given kernels {given}")
    if not (graphs.get("nuts_start", 0) == transitions
            and graphs.get("nuts_leaf", 0) >= transitions):
        raise AssertionError(f"Hes1: not every one of {transitions} "
                             f"transitions replayed its leaves: {graphs}")
    if not np.all(f_chain > HES1_BASIN_F):
        raise AssertionError(f"Hes1: chains {np.flatnonzero(f_chain <= 8)} "
                             "left the truth basin (mean f <= 8)")
    if not np.all(np.abs(z) <= 3.0):
        raise AssertionError(f"Hes1: theta means {theta_mean} are more than"
                             f" 3 posterior sd from the JAX recovery: {z}")
    return counts, kr, res["sample_results"][-1], coverage


def time_map_unwhitening(model, device, reps=200):
    """The per-evaluation unwhitening of map_estimate's "gn" objective on
    the card, float64, one chain at the Hes1 grid: x - mu = U^{-1} w and
    its gradient, by a dense solve_triangular and by K4 (the block-banded
    solve under autograd, its adjoint the backward); the two must agree.
    Prints ms per value-and-gradient of each (map_laplace takes the dense
    solve, the faster on the card)."""
    from magi_v2_tpu_torch.map_laplace import _dense_upper
    from magi_v2_tpu_torch.ops.banded import (
        banded_diag_tile_inverses,
        banded_to_blocks_upper,
        block_banded_triangular_solve_upper,
    )
    from magi_v2_tpu_torch.ops.linalg import sym_sqrt
    from magi_v2_tpu_torch.sampler.precond import build_gn_cholesky_banded

    f64 = lambda a: torch.tensor(np.asarray(a, np.float64),
                                 dtype=torch.float64, device=device)
    U_band, _ = build_gn_cholesky_banded(
        model, sigma_sqs_init=np.full(model.D, HES1_SIGMA),
        C_inv_sqrts=sym_sqrt(f64(model.C_d_invs)),
        K_inv_sqrts=sym_sqrt(f64(model.K_d_invs)))
    U = f64(_dense_upper(U_band))
    blocks = banded_to_blocks_upper(f64(U_band))
    dinv = banded_diag_tile_inverses(blocks, U.shape[0])
    g = torch.Generator(device="cpu").manual_seed(3)
    w0, c = (torch.randn(U.shape[0], generator=g, dtype=torch.float64).to(
        device) for _ in range(2))
    solves = {
        "dense solve_triangular": lambda w: torch.linalg.solve_triangular(
            U, w[:, None], upper=True)[:, 0],
        "K4": lambda w: block_banded_triangular_solve_upper(blocks, w,
                                                            diag_inv=dinv),
    }

    def value_and_grad(solve):
        w = w0.clone().requires_grad_(True)
        v = torch.sum(solve(w) * c)
        (gw,) = torch.autograd.grad(v, w)
        return v.detach(), gw

    (v0, g0), (v1, g1) = (value_and_grad(f) for f in solves.values())
    e = max(_relerr(v0[None], v1[None])[1], _relerr(g0, g1)[1])
    ms = {k: _time_ms(lambda f=f: value_and_grad(f), reps)
          for k, f in solves.items()}
    print(f"map_estimate 'gn' unwhitening at N*D = {U.shape[0]}, float64, "
          "one value and gradient: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in ms.items())
          + f" (the two agree to {e:.1e})")
    if not e <= 1e-12:
        raise AssertionError("the dense and K4 unwhitenings disagree")
    return ms


def hes1_laplace(model, device, logH_true, heuristic_coverage,
                 num_steps=HES1_LAPLACE_STEPS):
    """The Laplace-start recipe on the Hes1 fit:
    ``map_estimate(sigma_sqs_fixed=0.15^2, laplace_draws=64)`` (float64 on
    the card, L-BFGS-B on the host), then a 64-chain centered NUTS
    predict from its joint draws (``init_states``: X and theta),
    ``num_steps`` + ``num_steps`` transitions, no annealing, sigma pinned,
    diagonal mass, init_jitter 0.02, float32. Fails on a Laplace Hessian
    with an eigenvalue below -1e-12 of its largest (not SPD beyond
    roundoff), a MAP outside the truth basin (f <= 8), non-finite
    draws, a chain whose mean f is at most 8, or a pooled theta more than 3
    posterior sd from the JAX package's Laplace-start run; prints the MAP's
    wall, L-BFGS iterations and whether it met its convergence criterion
    (not gated: the JAX package's does not on this fit), H's band coverage
    beside the heuristic starts', rhat and ESS."""
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    time_map_unwhitening(model, device)
    t0 = time.perf_counter()
    r = model.map_estimate(sigma_sqs_fixed=HES1_SIGMA,
                           laplace_draws=HES1_CHAINS, draws_seed=101)
    torch.cuda.synchronize()
    map_wall = time.perf_counter() - t0
    print(f"Hes1 map_estimate: {map_wall:.2f} s in all ({r['wall_s']:.2f} s "
          f"to the MAP), {r['lbfgs_iters']} L-BFGS-B iterations, converged "
          f"{r['converged']} (projected gradient {r['grad_norm']:.3g}, "
          f"{r['lbfgs_message']}), -log p {r['neg_logpost']:.3f}, theta_map "
          f"{np.round(r['theta_map'], 4).tolist()}, theta_sd "
          f"{np.round(r['theta_sd'], 4).tolist()}, Hessian SPD "
          f"{r['hessian_spd']} (min/max eigenvalue "
          f"{r['hessian_min_eig_rel']:.3e}); draws' f from "
          f"{r['theta_draws'][:, 5].min():.2f} to "
          f"{r['theta_draws'][:, 5].max():.2f}")
    # Not gated on ``converged``: on this fit the JAX package's own
    # map_estimate ends its four L-BFGS-B passes (51,179 iterations) with a
    # projected gradient of 8.7, far above its criterion 1e-3 (1 + |F|) at
    # F = -5.6, the posterior's f/g ridge being flat; and its Hessian's
    # smallest eigenvalue there is 2.4e-16 of the largest, zero to float64
    # roundoff, so "SPD" is held to that roundoff. What the starts need is
    # a point in the truth basin with a Laplace Hessian that is positive
    # but for roundoff, and the chains' own gates below.
    if not (r["hessian_min_eig_rel"] >= -HES1_SPD_ROUNDOFF
            and np.all(np.isfinite(r["X_draws"]))):
        raise AssertionError("Hes1 map_estimate: its Laplace Hessian is not "
                             "SPD beyond roundoff or its draws are not "
                             "finite")
    if not r["theta_map"][5] > HES1_BASIN_F:
        raise AssertionError(f"Hes1 map_estimate: theta_map "
                             f"{r['theta_map']} is outside the truth basin")

    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(num_chains=HES1_CHAINS, num_results=num_steps,
                        num_burnin_steps=num_steps, init_jitter=0.02, seed=0,
                        reparam="centered", use_annealing=False,
                        sigma_sqs_fixed=HES1_SIGMA,
                        init_states={"X": r["X_draws"],
                                     "thetas": r["theta_draws"]})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()
    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    theta_mean = thetas.reshape(-1, 7).mean(axis=0)
    z = (theta_mean - HES1_LAPLACE_MEAN) / HES1_LAPLACE_SD
    f_chain = thetas[..., 5].mean(axis=0)
    coverage = h_coverage(res, logH_true)
    print(f"Hes1 Laplace-start predict wall: {wall:.2f} s ({num_steps}+"
          f"{num_steps} transitions, {HES1_CHAINS} chains, centered); "
          f"{predict_phases(model, wall)}; mean depth "
          f"{kr['depths'].mean():.3f}, {graphs.get('nuts_leaf', 0)} leaves "
          f"replayed, step size {float(kr['step_size']):.5f}")
    print(f"Hes1 Laplace starts: theta pooled means "
          f"{np.round(theta_mean, 4).tolist()} (the JAX package's "
          f"Laplace-start run {HES1_LAPLACE_MEAN.tolist()}, in its sd "
          f"{np.round(z, 2).tolist()}); per-chain mean f from "
          f"{f_chain.min():.2f} to {f_chain.max():.2f}; ESS_min "
          f"{summ['ess_min']:.1f}, rhat_max {summ['rhat_max']:.4f}")
    print(f"Hes1: H's 95% band covers the true H at {coverage:.3f} of the "
          f"grid from Laplace starts, {heuristic_coverage:.3f} from the "
          "heuristic starts (the JAX package: 0.597 and 0.256 at 16 x 3000 "
          "+ 8000)")
    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("Hes1 Laplace starts: non-finite draws")
    check_launched(counts, [f"{k}_hes1_log" for k in ("manifold_fwd",
                                                      "manifold_energy",
                                                      "manifold_bwd")]
                   + ["leapfrog_update", "nuts_leaf"], "Hes1 Laplace")
    if not np.all(f_chain > HES1_BASIN_F):
        raise AssertionError(f"Hes1 Laplace starts: chains "
                             f"{np.flatnonzero(f_chain <= HES1_BASIN_F)} left "
                             "the truth basin (mean f <= 8)")
    if not np.all(np.abs(z) <= 3.0):
        raise AssertionError(f"Hes1 Laplace starts: theta means {theta_mean} "
                             "are more than 3 posterior sd from the JAX "
                             f"package's Laplace-start run: {z}")
    return counts, coverage


# The Hes1 PT recipe (scripts/hes1_pt.py): the ladder, 16 replicas a rung
# (80 chains), centered, no annealing, sigma pinned, heuristic starts,
# default NUTS, float32; the Hes1 path's depth (the JAX script's 3000 +
# 8000 cut; N_I and the chains not)
HES1_PT_LADDER = (1.0, 0.6, 0.36, 0.22, 0.13)
HES1_PT_STEPS = HES1_STEPS


def hes1_pt(model, device, logH_true, coverages, num_steps=HES1_PT_STEPS):
    """The Hes1 PT predict on the card. Fails on non-finite draws, K1 not
    launched with a temperature per chain through the Hes1-log functor
    ("manifold_*_hes1_log_pt"), any launch of K1's given kernels, K6 not
    launched, the swap graph not replayed exactly once a sampling
    transition, or a returned chain axis other than 16. Prints, without
    gating (the decoupled-H mode is part of this posterior, and the ladder
    is expected to swap rarely at this dimension): the swap acceptance per
    pair, the beta = 1 rung's draws by mode (f = theta[5] > 8), the chains
    that changed mode, theta in each mode, H's band coverage beside the
    heuristic and Laplace starts' (``coverages``), rhat, ESS, depth,
    leaves and wall. Returns the launch counts, the kernel results and the
    last draws of the 16 chains."""
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    M = HES1_PT_CHAINS // len(HES1_PT_LADDER)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(num_chains=HES1_PT_CHAINS, num_results=num_steps,
                        num_burnin_steps=num_steps, init_jitter=0.02, seed=0,
                        reparam="centered", use_annealing=False,
                        sigma_sqs_fixed=HES1_SIGMA, pt_betas=HES1_PT_LADDER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()
    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    acc = kr["pt_swap_accept"]
    in_basin = thetas[..., 5] > HES1_BASIN_F               # (T, 16)
    hopped = np.flatnonzero(in_basin.any(axis=0) & ~in_basin.all(axis=0))
    by_mode = {name: np.round(thetas[sel].mean(axis=0), 4).tolist()
               for name, sel in (("truth basin", in_basin),
                                 ("decoupled", ~in_basin)) if sel.any()}
    summ = summarize_chains(thetas, wall)
    depths, leaves = kr["depths"], kr["num_leapfrogs"]
    coverage = h_coverage(res, logH_true)
    print(f"Hes1 PT predict wall: {wall:.2f} s ({num_steps}+{num_steps} "
          f"transitions, {len(HES1_PT_LADDER)} rungs x {M} replicas, ladder "
          f"{list(HES1_PT_LADDER)}, centered); {predict_phases(model, wall)}")
    print(f"Hes1 PT: swap acceptance per adjacent pair "
          f"{np.round(acc, 4).tolist()}; beta = 1 rung: "
          f"{in_basin.mean():.4f} of its draws in the truth basin (f > 8), "
          f"chains that changed mode {hopped.tolist()}, theta by mode "
          f"{by_mode}; ESS_min {summ['ess_min']:.1f}, rhat_max "
          f"{summ['rhat_max']:.4f}; mean depth {depths.mean():.3f} (max "
          f"{depths.max()}), mean leaves a chain {leaves.mean():.2f}, "
          f"{graphs.get('nuts_leaf', 0)} leaves replayed, step size "
          f"{float(kr['step_size']):.5f}")
    print(f"Hes1: H's 95% band covers the true H at {coverage:.3f} of the "
          f"grid with PT, {coverages[0]:.3f} from the heuristic starts, "
          f"{coverages[1]:.3f} from the Laplace starts")
    print(f"Hes1 PT launch counts: "
          f"{ {k: n for k, n in counts.items() if n} }; CUDA graphs {graphs}")
    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError("Hes1 PT: non-finite draws")
    check_launched(counts, [f"{k}_hes1_log_pt" for k in mf.KERNELS]
                   + ["leapfrog_update", "nuts_leaf", "pt_swap"], "Hes1 PT")
    given = {k: counts[k] for k in counts if "_given" in k and counts[k]}
    if given:
        raise AssertionError(f"Hes1 PT: K1 launched its given kernels {given}")
    if graphs.get("pt_swap", 0) != num_steps:
        raise AssertionError(f"Hes1 PT: the swap graph replayed "
                             f"{graphs.get('pt_swap', 0)} times in "
                             f"{num_steps} sampling transitions")
    if thetas.shape[1] != M:
        raise AssertionError(f"Hes1 PT: predict returned {thetas.shape[1]} "
                             f"chains, not the beta = 1 rung's {M}")
    return counts, kr, res["sample_results"][-1]


def hes1_pt_after(model, device, kr, last):
    """After the Hes1 PT predict: its composed float64 centered target with
    a temperature per chain, card against CPU; 20 PT NUTS transitions with
    swaps by replayed graphs and by eager (bit for bit), from the beta = 1
    rung's last states on every rung; the device time of one transition
    with its swap round, by kernel, and the swap round's graph replayed
    back to back (CUDA events)."""
    pre_fix = model._sigma_bounds(None, HES1_SIGMA)[2]
    tail = tuple(pre_fix.tolist()
                 + np.log(np.expm1(model.thetas_init)).tolist())
    check_composed(model, device, tail=tail, reparam="centered",
                   betas=np.linspace(1.0, 0.13, 8))
    R = len(HES1_PT_LADDER)
    target, qs, mass, eps, _ = _nuts_setup(
        model, device, kr, num_chains=HES1_PT_CHAINS, reparam="centered",
        tail=tail, sigma_sqs_fixed=HES1_SIGMA, start=np.tile(last, (R, 1)))
    bound, swap, q, noise, u, beta, eps_c = pt_graph_vs_eager(
        target, qs, mass, eps, HES1_PT_LADDER, "Hes1 NUTS",
        max_depth=model.config.max_tree_depth)
    device_profile(lambda: swap(bound(q, eps_c, mass, beta, noise)[0], u, 0),
                   "Hes1 PT transition and swap round")
    swap_ms = _time_ms(swap.graph.replay)
    print(f"Hes1 PT: a swap round's graph (the value-only evaluation at beta "
          f"1 and K6) replayed back to back: {swap_ms * 1e3:.2f} us a round")


def hes1_after(model, device, kr, last):
    """After the Hes1 predict: its composed float64 centered target on the
    card against the CPU; 20 NUTS transitions of its float32 target (beta
    1, sigma pinned) by replayed graphs and by eager, bit for bit, from the
    predict's last states ``last`` (C, dim; at the fit's state, far from
    the posterior's mass, the first leapfrog diverges); and the device time
    by kernel and busy share of one replayed transition."""
    pre_fix = model._sigma_bounds(None, HES1_SIGMA)[2]
    tail = tuple(pre_fix.tolist()
                 + np.log(np.expm1(model.thetas_init)).tolist())
    check_composed(model, device, tail=tail, reparam="centered")
    bound, q, noise, eps, mass, bt = nuts_graph_vs_eager(
        model, device, kr, label="Hes1 NUTS", beta_temp=1.0,
        num_chains=HES1_CHAINS, reparam="centered", tail=tail,
        sigma_sqs_fixed=HES1_SIGMA, start=last)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, info = bound(q, eps, mass, bt, noise)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    d = int(info.depth.max())
    print(f"Hes1 NUTS: one transition (deepest tree {d}, {2 ** d - 1} leaves "
          f"replayed, mean leaves a chain "
          f"{float(info.num_leapfrogs.float().mean()):.2f}): ms "
          f"{[round(w, 3) for w in walls]}")
    device_profile(lambda: bound(q, eps, mass, bt, noise),
                   "Hes1 NUTS replayed")


def predict_phases(model, wall):
    """The last predict's phases on the host's clock, the device waited
    for at each end (``predict_timings``): building the target and its
    whitening (for banded storage the Gauss-Newton precision and its
    Cholesky on the host), the sampler's loop, unwhitening the draws; the
    rest is the draws' copy to the host and the conversion of the
    results."""
    t = model.predict_timings
    rest = wall - sum(t.values())
    return ("phases (s): " + ", ".join(f"{k} {v:.2f}" for k, v in t.items())
            + f", rest {rest:.2f}")


def check_launched(counts, kernels, path):
    idle = [k for k in kernels if counts[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the {path} path: "
                             f"{idle}")


def check_composed(model, device, storage="dense", tail=SEIR_TAIL,
                   reparam="precond", betas=None, rebuild_at=None,
                   tol=COMPOSED_TOL):
    """The float64 target of ``reparam`` and ``storage`` on the card
    against the same target, moved to the CPU (plain versions), at 8
    states near the fit (``tail`` the sigma_pre and theta_pre of the
    states), at the temperature 0.37 or, with ``betas`` (8,), one per
    state; with ``rebuild_at`` (X, theta), the banded mode rebuilt at that
    anchor (``SamplingMode.rebuild``), as the refresh rebuilds it."""
    m64 = as_float64(model, hybrid=storage == "hybrid")
    mode, _, _ = m64._build_sampling_setup(reparam, storage, torch.float64)
    if rebuild_at is not None:
        mode = mode.rebuild(*rebuild_at)
    target = mode.logp_grad
    cpu_target = target.to("cpu")
    rng = np.random.default_rng(1)
    q0 = np.concatenate([mode.X0.cpu().numpy().ravel(), tail])
    q = q0 + 0.1 * rng.standard_normal((8, q0.size))
    bt = torch.tensor(0.37 if betas is None else betas, dtype=torch.float64)
    lp_c, g_c = cpu_target(torch.as_tensor(q), bt)
    lp_d, g_d = target(torch.as_tensor(q, device=device), bt.to(device))
    torch.cuda.synchronize()
    e_lp = _relerr(lp_c, lp_d.cpu())[1]
    e_g = _relerr(g_c, g_d.cpu())[1]
    print(f"composed float64 {reparam} {storage} target"
          + ("" if betas is None else ", a temperature per chain")
          + ("" if rebuild_at is None else ", rebuilt at the refresh's anchor")
          + ", card vs CPU: lp rel "
          f"{e_lp:.3e}, grad rel {e_g:.3e} (tol {tol:.0e})")
    if not (e_lp <= tol and e_g <= tol):
        raise AssertionError(f"composed {storage} target disagrees between "
                             "card and CPU")


@contextlib.contextmanager
def plain_kernels():
    """The plain versions in place of the kernels on CUDA tensors, which
    the package itself never does: whatever is bound or called inside
    takes the plain versions of K1 (in a target's plan), K2, K3 and K4. A
    target or leapfrog bound outside keeps its launches,
    so take a fresh copy (``target.to(device)``) inside. The baseline of
    the kernel checks and of the leapfrog timings below."""
    from magi_v2_tpu_torch.ops import banded as bd
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.ops import nuts as nu
    from magi_v2_tpu_torch.sampler import hmc

    always = lambda device: True
    swaps = [(bd, "_takes_plain", always), (mf, "_takes_plain", always),
             (hmc, "_takes_plain", always), (nu, "_takes_plain", always)]
    saved = [(mod, k, getattr(mod, k)) for mod, k, _ in swaps]
    for mod, k, fn in swaps:
        setattr(mod, k, fn)
    try:
        yield
    finally:
        for mod, k, fn in saved:
            setattr(mod, k, fn)


OWN_KERNELS = ("manifold_fwd_kernel", "manifold_energy_kernel",
               "manifold_bwd_kernel", "leapfrog_kernel",
               "banded_matvec_kernel", "banded_solve_kernel",
               "nuts_leaf_kernel", "pt_swap_kernel")


def device_profile(run, label):
    """torch.profiler's device time of ``run()`` (one transition) by
    kernel: prints the top kernels, the device time per launch of the
    port's own kernels and the device busy share of the unprofiled wall.
    Returns ({kernel: us per launch}, busy share or None)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    gemm = sum(e.self_device_time_total for e in kernels
               if "gemm" in e.key.lower())
    print(f"{label}: device time of one run, by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total:10.1f} us {e.count:5d} calls  "
              f"{e.key[:90]}")
    per_launch = {}
    for e in kernels:
        if any(k in e.key for k in OWN_KERNELS):
            per_launch[e.key] = e.self_device_time_total / max(e.count, 1)
            print(f"  {per_launch[e.key]:.2f} us of device time per launch "
                  f"({e.count} launches): {e.key[:90]}")
    if busy == 0:
        print(f"{label}: torch.profiler recorded no device time; the split "
              "above is not measured")
        return per_launch, None
    print(f"{label}: device busy {busy:.1f} us ({gemm / busy:.1%} in GEMMs)"
          f" of {profiled_us:.1f} us profiled wall and {wall_us:.1f} us "
          f"unprofiled wall; device busy {busy / wall_us:.1%}, idle "
          f"{1 - busy / wall_us:.1%} of the unprofiled wall")
    return per_launch, busy / wall_us


def profile_leapfrog(model, device, storage="dense", tail=(-10.5, -10.5,
                                                           -10.5, 1.8, -0.5,
                                                           0.6),
                     step_size=0.2, beta_temp=0.15, dense_mass=True,
                     num_chains=NUM_CHAINS, num_leapfrogs=100, reps=5,
                     host_calls=True):
    """Where a leapfrog's time goes, at a path's float32 shapes: the wall
    per leapfrog of the sampler's bound transition (replayed CUDA graphs),
    of the eager transition with the kernels and with their plain versions
    (in turns), one target evaluation alone, the host time of one graph
    replay and of each bound call of the target's workspace (K1's three
    launches and the stages around them), and torch.profiler's device time
    over one 50-leapfrog transition, replayed and eager. Returns the
    device us per launch of each of the port's kernels in the replayed
    transition, by the profiler's name (empty if it recorded no device
    time)."""
    from magi_v2_tpu_torch.sampler.hmc import BoundTransition, hmc_step
    from magi_v2_tpu_torch.sampler.mass import identity_mass

    mode, _, _ = model._build_sampling_setup("precond", storage,
                                             torch.float32)
    target = mode.logp_grad
    with plain_kernels():
        plain_target = target.to(device)
    N, D = model.mag_I, model.D
    dim = N * D + D + model.D_thetas
    g = torch.Generator(device=device).manual_seed(0)
    q0 = torch.cat([mode.X0.reshape(-1).float(),
                    torch.tensor(tail, dtype=torch.float32, device=device)])
    qs = q0 + 0.01 * torch.randn((num_chains, dim), generator=g,
                                 device=device)
    normals = torch.randn((num_chains, dim), generator=g, device=device)
    unif = torch.rand((num_chains,), generator=g, device=device)
    inv_mass = identity_mass(dim, dim if dense_mass else 0, torch.float32,
                             device)
    eps = torch.tensor(step_size, device=device)
    bt = torch.tensor(beta_temp, device=device)
    bound = BoundTransition(target, qs, inv_mass)

    def transition(L, tgt=target):
        if tgt is None:
            return bound(qs, eps, inv_mass, bt, L, normals, unif)
        return hmc_step(lambda q: tgt(q, bt), qs, eps, inv_mass, L,
                        normals, unif)

    def ms_per_leapfrog(tgt):
        transition(num_leapfrogs, tgt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            transition(num_leapfrogs, tgt)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (reps * num_leapfrogs) * 1e3

    walls = {"graph": [], "kernels": [], "plain": []}
    for order in [("graph", "kernels", "plain"),
                  ("plain", "kernels", "graph")]:
        for name in order:
            if name == "plain":
                # bound at its first call, so inside the context
                with plain_kernels():
                    walls[name].append(ms_per_leapfrog(plain_target))
            else:
                walls[name].append(ms_per_leapfrog(
                    None if name == "graph" else target))
    print(f"{storage}: ms per leapfrog ({num_chains} chains, float32): "
          f"replayed graphs {walls['graph']}, eager with the kernels "
          f"{walls['kernels']}, eager with the plain versions "
          f"{walls['plain']}")
    print(f"{storage}: ms per target evaluation alone: "
          f"{_time_ms(lambda: target(qs, bt))}")

    # one captured leapfrog replayed back to back: host us per replay (the
    # enqueue), and device ms per leapfrog when the host keeps ahead
    step = bound.graphs["next"]
    step.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        step.replay()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    per_replay_ms = (time.perf_counter() - t0) / 200 * 1e3
    print(f"{storage}: one replay of the captured leapfrog, 200 back to "
          f"back: host {host_us:.2f} us to enqueue, {per_replay_ms:.4f} ms "
          "each until the card finished")

    if host_calls:
        # host time of each bound call of the target's workspace, back to
        # back (the eager path pays these per leapfrog; the graph once)
        ws = getattr(target, "logp_grad", target)._workspaces[num_chains]
        stream = torch.cuda.current_stream(device).cuda_stream
        lp = torch.empty((num_chains,), dtype=torch.float32, device=device)
        grad = torch.empty_like(qs)
        calls = {
            "whitening.forward": lambda: ws.whitening.forward(stream),
            "operators.rm": lambda: ws.operators.rm(stream),
            "manifold_fwd": lambda: ws.k1.fwd(qs, bt, stream),
            "operators.s": lambda: ws.operators.s(stream),
            "manifold_energy": lambda: ws.k1.energy(qs, bt, lp, stream),
            "operators.s_adjoint": lambda: ws.operators.s_adjoint(stream),
            "manifold_bwd": lambda: ws.k1.bwd(qs, bt, grad, stream),
            "operators.rm_adjoint": lambda: ws.operators.rm_adjoint(stream),
            "whitening.backward": lambda: ws.whitening.backward(grad,
                                                                stream),
        }
        host = {}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host[name] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        print(f"{storage}: host us per bound call, 200 back to back: "
              + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
              + f"; sum {sum(host.values()):.1f}")

    per_launch, _ = device_profile(lambda: transition(50, None),
                                   f"{storage} replayed")
    device_profile(lambda: transition(50), f"{storage} eager")
    return per_launch


def graph_vs_eager(model, device, storage, num_chains, max_leapfrogs, tail,
                   step_size, beta_temp, dense_mass, sigma_fixed=None,
                   transitions=20, reparam="precond"):
    """The sampler's two transitions on one path's float32 target: the
    bound transition (captured CUDA graphs, replayed) and the eager
    ``hmc_step``, each run ``transitions`` times from the same state with
    the same normals, uniforms and trajectory lengths (the step halved
    first until an eager transition accepts 30% of its proposals, so that
    the states move). The states and acceptance probabilities are
    compared. Where a state differs, the bound transition is also run from the eager state, so
    that one transition's gap is told apart from its growth over many.
    Fails unless every transition agrees bit for bit or the one-transition
    gap is within K2's float32 tolerance. Returns (bit-identical
    transitions, largest one-transition relative gap)."""
    from magi_v2_tpu_torch.sampler.hmc import BoundTransition, hmc_step
    from magi_v2_tpu_torch.sampler.mass import mass_from_moments

    kw = {} if sigma_fixed is None else {"sigma_sqs_fixed": sigma_fixed}
    mode, _, _ = model._build_sampling_setup(reparam, storage,
                                             torch.float32, **kw)
    target = mode.logp_grad
    N, D = model.mag_I, model.D
    dim = N * D + D + model.D_thetas
    g = torch.Generator(device=device).manual_seed(1)
    q0 = torch.cat([mode.X0.reshape(-1).float(),
                    torch.tensor(tail, dtype=torch.float32, device=device)])
    qs = q0 + 0.01 * torch.randn((num_chains, dim), generator=g,
                                 device=device)
    var = 1.0 + 0.2 * torch.rand((dim,), generator=g, device=device)
    if dense_mass:
        a = torch.randn((dim, dim), generator=g, device=device)
        mass = mass_from_moments(var, torch.diag(var) + 0.05 * a @ a.T / dim)
    else:
        mass = var
    eps = torch.tensor(step_size, device=device)
    bt = torch.tensor(beta_temp, device=device)
    host = np.random.default_rng(1)
    lengths = [max(1, int(np.ceil(host.random() * max_leapfrogs)))
               for _ in range(transitions)]
    noise = [(torch.randn((num_chains, dim), generator=g, device=device),
              torch.rand((num_chains,), generator=g, device=device))
             for _ in range(transitions)]
    # halve the step until the first transition accepts some proposals,
    # so that the comparison sees states that move
    for _ in range(10):
        _, info = hmc_step(lambda q: target(q, bt), qs, eps, mass,
                           lengths[0], *noise[0])
        if float(info.accept_prob.mean()) >= 0.3:
            break
        eps = 0.5 * eps
    bound = BoundTransition(target, qs, mass)
    qe = qb = qs
    same, gap, accepts = 0, 0.0, []
    for L, (normals, uniforms) in zip(lengths, noise):
        qe2, info = hmc_step(lambda q: target(q, bt), qe, eps, mass, L,
                             normals, uniforms)
        qb2, info_b = bound(qb, eps, mass, bt, L, normals, uniforms)
        accepts.append(float(info.accept_prob.mean()))
        if torch.equal(qe2, qb2) and torch.equal(info.accept_prob,
                                                 info_b.accept_prob):
            same += 1
        else:
            qb1, _ = bound(qe, eps, mass, bt, L, normals, uniforms)
            gap = max(gap, _relerr(qe2, qb1)[1])
        qe, qb = qe2, qb2
    torch.cuda.synchronize()
    print(f"{reparam} {storage}: graph against eager, {transitions} "
          "transitions of "
          f"{num_chains} chains (L {min(lengths)}..{max(lengths)}, step "
          f"{float(eps):.4g}, mean "
          f"acceptance {np.mean(accepts):.3f}): {same} of {transitions} bit "
          f"for bit; largest one-transition relative gap {gap:.3e} (tol "
          f"{TOL[torch.float32]:.0e})")
    if same < transitions and not gap <= TOL[torch.float32]:
        raise AssertionError(f"{storage}: the replayed transition differs "
                             "from the eager one beyond K2's tolerance")
    return same, gap


# Parallel tempering on the SEIR fit's HMC: 4 rungs x 64 replicas
SEIR_PT_LADDER = (1.0, 0.6, 0.36, 0.22)


def pt_graph_vs_eager(target, qs, mass, eps, ladder, label, transitions=20,
                      algorithm="nuts", max_depth=10, max_leapfrogs=64,
                      seed=5):
    """PT transitions (each chain at its rung's beta and step eps
    beta^(-1/2)) each followed by a swap round, ``transitions`` times from
    ``qs``: by the bound transition and swap (captured CUDA graphs,
    replayed) and by their eager forms (the target wrapped in a lambda, so
    that nothing binds), with the same noise, uniforms and parities. The
    states, every info field and the swap counters must agree bit for bit.
    Returns the bound transition and swap, the last state and noise, and
    the per-chain betas and steps, for a profile."""
    from magi_v2_tpu_torch.sampler.hmc import BoundTransition, hmc_step
    from magi_v2_tpu_torch.sampler.nuts import BoundNuts, NutsConfig, \
        draw_noise
    from magi_v2_tpu_torch.sampler.pt import BoundSwap, rung_temperatures

    C, dim = qs.shape
    R, device = len(ladder), qs.device
    beta, scale = rung_temperatures(ladder, C, qs.dtype, device)
    eps_c = eps * scale
    eager = lambda q, b: target(q, b)
    g = torch.Generator(device=device).manual_seed(seed)
    host = np.random.default_rng(seed)
    if algorithm == "nuts":
        cfg = NutsConfig(max_depth)
        bound = BoundNuts(target, qs, mass, cfg, per_chain=True)
        slow = BoundNuts(eager, qs, mass, cfg, per_chain=True)
    else:
        bound = BoundTransition(target, qs, mass, per_chain=True)
    swap, swap_e = BoundSwap(target, qs, ladder), BoundSwap(eager, qs, ladder)
    qe = qb = qs
    same = 0
    for t in range(transitions):
        if algorithm == "nuts":
            noise = draw_noise(g, C, dim, max_depth, qs.dtype, device)
            qe2, ie = slow(qe, eps_c, mass, beta, noise)
            qb2, ib = bound(qb, eps_c, mass, beta, noise)
        else:
            L = max(1, int(np.ceil(host.random() * max_leapfrogs)))
            noise = (L, torch.randn((C, dim), generator=g, device=device),
                     torch.rand((C,), generator=g, device=device))
            qe2, ie = hmc_step(lambda q: target(q, beta), qe, eps_c, mass,
                               *noise)
            qb2, ib = bound(qb, eps_c, mass, beta, *noise)
        u = torch.rand((R - 1, C // R), generator=g, device=device)
        qe2, qb2 = swap_e(qe2, u, t % 2), swap(qb2, u, t % 2)
        fields = [(a, c) for a, c in zip(ie, ib)
                  if isinstance(a, torch.Tensor)]
        if torch.equal(qe2, qb2) and all(torch.equal(a, c)
                                         for a, c in fields):
            same += 1
        qe, qb = qe2, qb2
    torch.cuda.synchronize()
    counters = (torch.equal(swap.prop, swap_e.prop)
                and torch.equal(swap.accs, swap_e.accs))
    print(f"{label}: PT graph against eager, {transitions} transitions of "
          f"{C} chains ({R} rungs, {algorithm}, step {float(eps):.4g} at "
          f"beta 1), each with a swap round: {same} of {transitions} bit for "
          f"bit; swaps accepted {swap.accs.tolist()} of "
          f"{swap.prop.tolist()} proposed, counters equal {counters}")
    if same < transitions or not counters:
        raise AssertionError(f"{label}: the replayed PT transitions and "
                             "swaps differ from the eager ones")
    return bound, swap, qb, noise, u, beta, eps_c


def seir_pt_graph_vs_eager(model, device):
    """20 PT HMC transitions with swaps on the SEIR fit's float32 target
    (precond, dense), 4 rungs x 64 replicas, from states near the fit, a
    dense random metric, the step halved from 0.05 until the beta = 1
    chains accept 30% of their proposals: BoundTransition's (C,) path and
    the swap graph against their eager forms, bit for bit."""
    from magi_v2_tpu_torch.sampler.hmc import hmc_step
    from magi_v2_tpu_torch.sampler.mass import mass_from_moments

    mode, _, _ = model._build_sampling_setup("precond", "dense",
                                             torch.float32)
    target = mode.logp_grad
    dim = model.mag_I * model.D + model.D + model.D_thetas
    g = torch.Generator(device=device).manual_seed(1)
    q0 = torch.cat([mode.X0.reshape(-1).float(),
                    torch.tensor(SEIR_TAIL, dtype=torch.float32,
                                 device=device)])
    qs = q0 + 0.01 * torch.randn((NUM_CHAINS, dim), generator=g,
                                 device=device)
    var = 1.0 + 0.2 * torch.rand((dim,), generator=g, device=device)
    a = torch.randn((dim, dim), generator=g, device=device)
    mass = mass_from_moments(var, torch.diag(var) + 0.05 * a @ a.T / dim)
    one = torch.ones((), device=device)
    eps = torch.tensor(0.05, device=device)
    for _ in range(10):
        _, info = hmc_step(lambda q: target(q, one), qs, eps, mass, 16,
                           torch.randn((NUM_CHAINS, dim), generator=g,
                                       device=device),
                           torch.rand((NUM_CHAINS,), generator=g,
                                      device=device))
        if float(info.accept_prob.mean()) >= 0.3:
            break
        eps = 0.5 * eps
    reset_launch_counts()
    pt_graph_vs_eager(target, qs, mass, eps, SEIR_PT_LADDER, "SEIR HMC",
                      algorithm="hmc")
    counts = launch_counts()
    print(f"SEIR PT HMC: launch counts "
          f"{ {k: n for k, n in counts.items() if n} }")
    check_launched(counts, [f"{k}_seir_pt" for k in
                            ("manifold_fwd", "manifold_energy",
                             "manifold_bwd")] + ["pt_swap",
                                                 "leapfrog_update"],
                   "SEIR PT HMC")


# the bimodal target of tests/test_pt.py: modes at +-3 with sd 0.35 in
# coordinate 0 (a ~37-nat barrier at beta = 1), N(0, 1) in coordinate 1
BIMODAL_MODE, BIMODAL_SD = 3.0, 0.35
BIMODAL_LADDER = (1.0, 0.3, 0.1, 0.03)


def bimodal_target(weight_right=0.5):
    """(q (C, 2), beta 0-dim or (C,)) -> (lp (C,), grad (C, 2)) of the
    mixture weight_right N(3, 0.35^2) + (1 - weight_right) N(-3, 0.35^2)
    in coordinate 0 and N(0, 1) in coordinate 1, tempered by beta."""
    mode, sd = BIMODAL_MODE, BIMODAL_SD
    la0, lb0 = float(np.log1p(-weight_right)), float(np.log(weight_right))

    def lp(q, beta_temp):
        z = q[:, 0]
        la = la0 - 0.5 * ((z + mode) / sd) ** 2
        lb = lb0 - 0.5 * ((z - mode) / sd) ** 2
        m = torch.logaddexp(la, lb)
        g0 = (torch.exp(la - m) * (-(z + mode) / sd ** 2)
              + torch.exp(lb - m) * (-(z - mode) / sd ** 2))
        grad = torch.stack([g0, -q[:, 1]], dim=1)
        b = beta_temp
        return (b * (m - 0.5 * q[:, 1] ** 2),
                (b[:, None] if b.dim() else b) * grad)

    return lp


def bimodal_pt(device, steps=3000, burnin=600, seed=3):
    """tests/test_pt.py's harness on the card: the bimodal target at
    weight 0.8, 4 rungs x 8 replicas on BIMODAL_LADDER, every chain started
    in the left mode, HMC (L <= 24, no mass adaptation, no annealing), 600
    + 3000 transitions, float32: the beta = 1 rung's right-mode share must
    lie in (0.6, 0.95) and every pair's swap acceptance exceed 0.05 (the
    gate that the kernel accepts correctly); K6 must launch once a
    sampling transition."""
    from magi_v2_tpu_torch.sampler.run import SamplerConfig, run_chains

    R, M = len(BIMODAL_LADDER), 8
    cfg = SamplerConfig(num_results=steps, num_burnin_steps=burnin,
                        use_annealing=False, algorithm="hmc",
                        hmc_num_leapfrogs=24, adapt_mass_matrix=False,
                        pt_betas=BIMODAL_LADDER)
    q0 = torch.zeros((R * M, 2), device=device)
    q0[:, 0] = -BIMODAL_MODE
    reset_launch_counts()
    t0 = time.perf_counter()
    samples, stats = run_chains(bimodal_target(0.8), q0, seed, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    share = float((samples[:, :M, 0] > 0).float().mean())
    acc = stats.pt_swap_accept.cpu().numpy()
    print(f"bimodal PT on the card (weight 0.8, {R} x {M} chains, "
          f"{burnin}+{steps} HMC transitions, {wall:.2f} s): beta = 1 "
          f"rung's right-mode share {share:.4f} (gate (0.6, 0.95)), swap "
          f"acceptance per pair {np.round(acc, 4).tolist()} (gate > 0.05), "
          f"K6 launches {counts['pt_swap']}, K2 launches "
          f"{counts['leapfrog_update']}")
    if not (0.6 < share < 0.95 and np.all(acc > 0.05)
            and counts["pt_swap"] == steps):
        raise AssertionError("bimodal PT: the beta = 1 rung's weights or the "
                             "swap acceptance are wrong, or K6 did not run "
                             "once a transition")


def check_replays(counts, transitions, path):
    """Every transition of a predict replays its captured steps: the
    evaluation at the start and the first leapfrog once each (every
    trajectory has at least one leapfrog), from three captures."""
    print(f"{path}: CUDA graphs {counts}")
    if not (counts["captures"] == 3 and counts.get("start", 0) == transitions
            and counts.get("first", 0) == transitions):
        raise AssertionError(f"{path}: not every one of {transitions} "
                             f"transitions replayed its captured leapfrog: "
                             f"{counts}")


def report_solve(timing, per_launch):
    """K4's float32 ms per launch at the hybrid run's chains, back to back
    (phase 8) and in the hybrid leapfrog (phase 12's profile), beside its
    bound and one solve_triangular."""
    in_leapfrog = {}
    for key, us in per_launch.items():
        if "banded_solve_kernel" in key:
            side = "adjoint" if "true>" in key else "forward"
            in_leapfrog[side] = f"{us / 1e3:.4f}"
    parts = []
    for side, k in (("forward", "banded_solve"),
                    ("adjoint", "banded_solve_adjoint")):
        t = timing[k]
        parts.append(f"{side} {t['ms']:.4f} back to back, "
                     f"{in_leapfrog.get(side, 'not measured')} in the hybrid "
                     f"leapfrog, bound {t['bound_ms']:.4f} "
                     f"({t['bound_by']}), solve_triangular "
                     f"{t['library_ms']:.4f}")
    print(f"K4 float32 at {LORENZ_CHAINS} chains, ms per launch: "
          + "; ".join(parts))


def lorenz_fit(device, n_obs=257):
    """The dense-grid Lorenz configuration, fitted in float32 on the card:
    N_I = 1025 from 257 observations at discretization 2, bandsize 100.

    Theta starts from the same data's discretization-1 fit (N_I = 513),
    passed as ``initial_fit(2, thetas_init=...)``, the README's recipe. At
    N_I = 1025 the derivative operator K = K'' - K' C^{-1} K'^T is a
    cancellation below float64's resolution (its eigenvalues come out
    between about -1 and +1 where they are positive and small), so the
    theta that initial_fit fits through K^{-1} depends on the LAPACK that
    computed it: the JAX package on a CPU and the port on the card and on
    a CPU all put rho near 1e-4, and the banded run anchored there collapsed
    its step size to 1.2e-7. At N_I = 513 the fit is well posed. That fit
    only starts theta, so its hyperparameters are fitted by L-BFGS
    (``hparam_optimizer="lbfgs"``, far quicker than Adam-1000, which keeps
    the smoke's wall inside its limit); N_I = 1025's by Adam as before."""
    from magi_v2_tpu_torch import MAGI_v2, MagiConfig
    from magi_v2_tpu_torch.models import lorenz_f_vec
    from magi_v2_tpu_torch.utils.data import simulate_ode

    ts, X_obs, _ = simulate_ode(lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]),
                                thetas=LORENZ_THETAS, t_max=2.0, n_obs=n_obs,
                                noise_sd=0.5, substeps=50)
    cfg = MagiConfig(dtype=torch.float32, device=str(device),
                     anneal_min_temp=0.3)
    thetas_init = None
    for disc in (1, 2):
        model = MAGI_v2(D_thetas=3, ts_obs=ts, X_obs=X_obs, bandsize=100,
                        f_vec=lorenz_f_vec,
                        config=(cfg.replace(hparam_optimizer="lbfgs")
                                if disc == 1 else cfg))
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            model.initial_fit(discretization=disc, thetas_init=thetas_init)
        torch.cuda.synchronize()
        print(f"Lorenz setup (initial_fit, discretization {disc}): "
              f"{time.perf_counter() - t0:.2f} s {model.fit_timings}; N_I "
              f"{model.mag_I}, thetas_init "
              f"{np.round(model.thetas_init, 4).tolist()}, band truncation "
              f"{model.band_truncation}")
        for w in caught:
            print(f"  warning: {str(w.message)[:160]}")
        thetas_init = model.thetas_init
    return model


def check_banded_kernels(model, device):
    """K3 and K4 (and adjoints) against their plain versions on the Lorenz
    fit's operators: the band-truncated R, m, S of storage="banded" and
    its banded Gauss-Newton factor U, float64 and float32, at the banded
    run's and the hybrid run's chain counts, and K4 as the unwhitening of
    the hybrid run's draws calls it; returns the float32 numbers (K3 timed
    at the banded run's chains, K4 at the hybrid run's)."""
    mode, data, _ = model._build_sampling_setup("precond", "banded",
                                                torch.float64)
    results = check_banded_ops(
        {"R": data.C_sqrt_blocks, "m": data.m_blocks, "S": data.K_sqrt_blocks},
        mode.factor, model.mag_I, model.D,
        (BANDED_CHAINS, LORENZ_CHAINS, RAGGED_CHAINS),
        device, timed={"banded_matvec": BANDED_CHAINS,
                       "banded_matvec_adjoint": BANDED_CHAINS,
                       "banded_matvec_pair": BANDED_CHAINS,
                       "banded_matvec_adjoint_pair": BANDED_CHAINS,
                       "banded_solve": LORENZ_CHAINS,
                       "banded_solve_adjoint": LORENZ_CHAINS},
        library_at=(BANDED_CHAINS, LORENZ_CHAINS, RAGGED_CHAINS))
    solve_repeatability(mode.factor, model.mag_I, model.D, RAGGED_CHAINS,
                        device)
    check_unwhiten(mode.factor, model.mag_I, model.D, UNWHITEN_DRAWS,
                   LORENZ_CHAINS, device)
    return results


def dense_banded(tiles, hw_lo, hw_hi, N):
    """The dense (*B, N, N) matrices of block-banded tiles (*B, nb, nw, T,
    T), by the plain matvec on the tiles' device: the yardsticks' operand."""
    from magi_v2_tpu_torch.ops import banded as bd

    B = tuple(tiles.shape[:-4])
    eye = torch.eye(N, dtype=tiles.dtype, device=tiles.device)
    x = eye.reshape((N,) + (1,) * len(B) + (N,)).expand((N,) + B + (N,))
    # cols[e, b, i] = A_b[i, e]
    cols = bd.block_banded_matvec_plain(tiles, x, hw_lo, hw_hi)
    return cols.movedim(0, -1).contiguous()


def banded_yardsticks(ops, wh, C, dtype, device, kernels):
    """For each of ``kernels``: its bound at C chains (the band's nonzeros, read
    once, and two operations per nonzero and chain; the vectors in and
    out) and the time of one PyTorch call that computes the same function
    on the densified operator: torch.bmm for K3 (S dr and S' g_Ds; for the
    pairs [R; m] delta and gpart + [R' | -m'] gcat the faster of two such
    calls and one call on the stacked operators),
    torch.linalg.solve_triangular for K4 with the right-hand sides in
    natural order."""
    size = torch.finfo(dtype).bits // 8
    N, D = wh.N, wh.D
    g = torch.Generator(device="cpu").manual_seed(5)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64).to(
        device=device, dtype=dtype)
    nonzeros = lambda op: int(torch.count_nonzero(op.tiles))
    dense = lambda op: dense_banded(op.tiles, op.hw_lo, op.hw_hi, N)
    vec = D * C * N
    out = {}
    if any(k in ("banded_matvec", "banded_matvec_adjoint") for k in kernels):
        nnz = nonzeros(ops.S)
        S_dense = dense(ops.S)
        v = r(D, C, N)
        for k, fn in (("banded_matvec", lambda: torch.bmm(v, S_dense.mT)),
                      ("banded_matvec_adjoint",
                       lambda: torch.bmm(v, S_dense))):
            out[k] = dict(bound((nnz + 2 * vec) * size, 2 * C * nnz, dtype),
                          library_ms=_time_ms(fn), band_nonzeros=nnz)
    if any(k.endswith("_pair") for k in kernels):
        nnz = nonzeros(ops.R) + nonzeros(ops.m)
        R_dense, m_dense = dense(ops.R), dense(ops.m)
        W_fwd = torch.cat([R_dense.mT, m_dense.mT], dim=2).contiguous()
        W_bwd = torch.cat([R_dense, -m_dense], dim=1).contiguous()
        v, v2, acc = r(D, C, N), r(D, C, 2 * N), r(D, C, N)

        def two_forward():
            return torch.bmm(v, R_dense.mT), torch.bmm(v, m_dense.mT)

        def two_adjoint():
            return torch.baddbmm(
                torch.baddbmm(acc, v2[..., :N], R_dense), v2[..., N:],
                m_dense, alpha=-1.0)

        for k, fns, nvec in (
            ("banded_matvec_pair",
             (two_forward, lambda: torch.bmm(v, W_fwd)), 3),
            ("banded_matvec_adjoint_pair",
             (two_adjoint, lambda: torch.baddbmm(acc, v2, W_bwd)), 4),
        ):
            two_ms, stacked_ms = (_time_ms(fn) for fn in fns)
            out[k] = dict(bound((nnz + nvec * vec) * size, 2 * C * nnz,
                                dtype),
                          library_ms=min(two_ms, stacked_ms),
                          band_nonzeros=nnz, two_calls_ms=two_ms,
                          stacked_ms=stacked_ms)
    if any(k.startswith("banded_solve") for k in kernels):
        U = wh.factor.tiles
        nnz = int(torch.count_nonzero(U))
        U_dense = dense_banded(U, 0, U.shape[1] - 1, N * D)
        rhs = r(N * D, C)
        for k, fn in (
            ("banded_solve", lambda: torch.linalg.solve_triangular(
                U_dense, rhs, upper=True)),
            ("banded_solve_adjoint", lambda: torch.linalg.solve_triangular(
                U_dense.mT, rhs, upper=False)),
        ):
            out[k] = dict(bound((nnz + 2 * C * N * D) * size, 2 * C * nnz,
                                dtype), library_ms=_time_ms(fn, reps=20),
                          band_nonzeros=nnz)
    return {k: out[k] for k in kernels}


def bind_stages(ops, wh, x, stream):
    """The banded target's stages bound to buffers of their own, as
    ``GNTarget._bind`` binds them, on the inputs ``x`` (dz (C, ND); delta
    (C, D, N); dr, gDs, gpart, g_delta (D, C, N); gcat (D, C, 2N)). Returns
    {kernel: {part: (prepare, run)}}: ``prepare`` restores what the launch
    reads from a buffer that another launch writes, ``run`` launches once
    and returns the tensor written. The first part of each kernel is the
    one the sampler runs."""
    from magi_v2_tpu_torch.ops import banded as bd

    C, D, N = x["delta"].shape
    ND = N * D
    new = lambda *shape: torch.empty(shape, dtype=x["dz"].dtype,
                                     device=x["dz"].device)
    b = dict(dz=x["dz"], dr=x["dr"], gDs=x["gDs"], gcat=x["gcat"],
             delta=new(C, D, N), RmD=new(D, C, 2 * N), grad0=new(C, ND + D + 3),
             **{k: new(D, C, N) for k in ("Ds", "gdr", "gpart")})
    bo, bw = ops.bind(b), wh.bind(b)

    def to(buffer, launch):
        def run():
            launch(stream)
            return b[buffer]
        return run

    def whiten_adjoint():
        # into the leading ND columns of a new (C, ND + D + P) gradient,
        # P = 3 theta, as the target passes it: the launch is rebound
        grad = new(C, ND + D + 3)
        bw.backward(grad, stream)
        return grad[:, :ND]

    def scaled_into_half():
        out = torch.ones((D, C, 2 * N), dtype=x["dz"].dtype,
                         device=x["dz"].device)
        bd.banded_matvec(ops.R, x["delta"], out[..., N:].transpose(0, 1),
                         alpha=-2.0, accumulate=True)
        return out

    nothing = lambda: None
    return {
        "banded_matvec": {"s": (nothing, to("Ds", bo.s)),
                          "r_half": (nothing, scaled_into_half)},
        "banded_matvec_pair": {
            "rm": (lambda: b["delta"].copy_(x["delta"]), to("RmD", bo.rm))},
        "banded_matvec_adjoint": {
            "s_adjoint": (nothing, to("gdr", bo.s_adjoint))},
        # both read gpart, which the operator stage accumulates into and
        # the whitening stage takes as g_delta
        "banded_matvec_adjoint_pair": {
            "rm_adjoint": (lambda: b["gpart"].copy_(x["gpart"]),
                           to("gpart", bo.rm_adjoint))},
        "banded_solve": {"x": (nothing, to("delta", bw.forward))},
        "banded_solve_adjoint": {
            "gy": (lambda: b["gpart"].copy_(x["g_delta"]), whiten_adjoint)},
    }


def check_banded_ops(blocks, factor64, N, D, chains, device, timed=None,
                     library_at=()):
    """K3 and K4 against their plain versions as the sampler launches
    them: each stage of the banded target bound to fixed buffers
    (``bind_stages``), so on its strided views. K3 through
    ``BandedOperators`` (the pair [R; m] delta into the halves of the
    (D, C, 2N) RmD, S dr, S' g_Ds and the accumulating pair [R' | -m'] gcat
    on (D, C, N) <-> (C, D, N) transposes, and one unbound launch with
    alpha and accumulate into a half of RmD) on ``blocks`` ({"R", "m",
    "S"}: float64 (D, nb, nw, T, T) tiles), K4 through ``BandedWhitening``
    (the interleaved <-> component-major permutation; the adjoint rebound
    to a new gradient each call) on the float64 ``factor64``. The plain
    side is the same stages bound with the plain versions swapped in; each
    launch runs twice and must give the same bits. Float64 and float32,
    for each chain count of ``chains``. Every kernel is timed at every
    chain count; ``timed`` maps a kernel to the chain count whose times are
    reported (default the first), and K3's yardsticks are also timed and
    printed at the chain counts of ``library_at``."""
    from magi_v2_tpu_torch.ops import banded as bd
    from magi_v2_tpu_torch.sampler.precond import (
        BandedOperators,
        BandedWhitening,
    )

    timed = timed or {}
    nwu = factor64.tiles.shape[1]
    ND = N * D
    results = {}
    yard = {}
    stream = torch.cuda.current_stream(device).cuda_stream

    def run_parts(stages):
        out = {}
        for k, parts in stages.items():
            for p, (prepare, run) in parts.items():
                prepare()
                out[k, p] = run().clone()
        return out

    for dtype in (torch.float64, torch.float32):
        ops = BandedOperators(*(blocks[k].to(dtype) for k in ("R", "m", "S")))
        wh = BandedWhitening(factor64.to(dtype), N, D)
        errs = {k: {} for k in bd.KERNELS}
        times, extra = {}, {k: "" for k in bd.KERNELS}
        for C in chains:
            g = torch.Generator(device="cpu").manual_seed(4)
            r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64).to(
                device=device, dtype=dtype)
            x = dict(delta=1e-2 * r(C, D, N), dr=r(D, C, N), gDs=r(D, C, N),
                     gpart=r(D, C, N), gcat=r(D, C, 2 * N), dz=r(C, ND),
                     g_delta=r(D, C, N))
            fast = bind_stages(ops, wh, x, stream)
            got, again = run_parts(fast), run_parts(fast)
            with plain_kernels():
                slow = bind_stages(ops, wh, x, stream)
                ref = run_parts(slow)
            for (k, p), t in got.items():
                errs[k][f"{p}_C{C}"] = _relerr(ref[k, p], t)
                if not torch.equal(t, again[k, p]):
                    raise AssertionError(
                        f"{k} ({p}, {C} chains, {dtype}): two runs of the "
                        "same launch differ")

            # the solves' residuals against the float64 factor
            x_nat = got["banded_solve", "x"].permute(0, 2, 1).reshape(
                C, ND).double()
            Ux = bd.block_banded_matvec_plain(factor64.tiles, x_nat, 0,
                                              nwu - 1)
            res = float(torch.linalg.norm(Ux - x["dz"].double())
                        / torch.linalg.norm(x["dz"].double()))
            extra["banded_solve"] += (f", C{C} residual ||Ux - y||/||y|| "
                                      f"{res:.2e}")
            g_nat = x["g_delta"].permute(1, 2, 0).reshape(C, ND).double()
            Utg = bd.block_banded_matvec_adjoint_plain(
                factor64.tiles, got["banded_solve_adjoint", "gy"].double(), 0,
                nwu - 1)
            res = float(torch.linalg.norm(Utg - g_nat)
                        / torch.linalg.norm(g_nat))
            extra["banded_solve_adjoint"] += (f", C{C} residual "
                                              f"||U'gy - g||/||g|| {res:.2e}")

            # times of one launch of each kernel's first part, back to back
            first = lambda stages, k: next(iter(stages[k].values()))[1]
            for k in bd.KERNELS:
                ms = _time_ms(first(fast, k))
                if C == timed.get(k, chains[0]):
                    with plain_kernels():
                        plain_ms = _time_ms(first(slow, k),
                                            reps=20 if "solve" in k else 200)
                    times[k] = (ms, plain_ms)
                    extra[k] += f" (ms at C{C})"
                else:
                    extra[k] += f", {ms:.4f} ms at C{C}"
            here = [k for k in bd.KERNELS
                    if timed.get(k, chains[0]) == C
                    or (C in library_at and "matvec" in k)]
            for k, more in banded_yardsticks(ops, wh, C, dtype, device,
                                             here).items():
                if timed.get(k, chains[0]) == C:
                    yard[k] = more
                extra[k] += (f", C{C}: bound {more['bound_ms']:.4f} ms "
                             f"({more['bound_by']}, {more['band_nonzeros']} "
                             f"band nonzeros), one PyTorch call "
                             f"{more['library_ms']:.4f} ms")
                if "stacked_ms" in more:
                    extra[k] += (f" (two calls {more['two_calls_ms']:.4f}, "
                                 f"stacked {more['stacked_ms']:.4f})")
        torch.cuda.synchronize()
        for k in bd.KERNELS:
            tol = SOLVE_TOL if k.startswith("banded_solve") else MATVEC_TOL
            more = {key: v for key, v in (yard.get(k) or {}).items()
                    if key not in ("two_calls_ms", "stacked_ms")}
            report(k, dtype, errs[k], *times[k], tol[dtype], results,
                   extra=extra[k], more=more or None)
    return results


def solve_repeatability(factor64, N, D, chains, device, runs=300):
    """K4 launched ``runs`` times on one input, through the whitening stage
    bound as the sampler binds it, each result held bit for bit against
    the first; raises if any differs. Two runs of a launch are not enough
    here: before the slab ring's release was fenced against the copy
    engine (csrc/banded.cu: fence_proxy_async), one float64 adjoint launch
    in some 500 at 257 chains read a slab half refilled and came out wrong
    by 1e-3 of max|x|. Returns {(dtype, direction): differing runs}, all
    0."""
    from magi_v2_tpu_torch.sampler.precond import BandedWhitening

    ND = N * D
    out = {}
    stream = torch.cuda.current_stream(device).cuda_stream
    for dtype in (torch.float64, torch.float32):
        wh = BandedWhitening(factor64.to(dtype), N, D)
        g = torch.Generator(device="cpu").manual_seed(4)
        r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64).to(
            device=device, dtype=dtype)
        new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
        b = dict(dz=r(chains, ND), g_delta=r(D, chains, N),
                 delta=new(chains, D, N), grad0=new(chains, ND + D + 3))
        bw = wh.bind(b)

        def forward():
            bw.forward(stream)
            return b["delta"].reshape(chains, -1)

        def adjoint():
            grad = new(chains, ND + D + 3)
            bw.backward(grad, stream)
            return grad[:, :ND]

        for side, fn in (("forward", forward), ("adjoint", adjoint)):
            first = fn().clone()
            differing, worst, where = 0, 0.0, None
            for _ in range(runs):
                diff = (fn() - first).abs()
                top = float(diff.max())
                if top > 0.0:
                    differing += 1
                    if top > worst:
                        worst = top
                        where = divmod(int(diff.argmax()), diff.shape[1])
            name = str(dtype).replace("torch.", "")
            print(f"banded_solve {side} {name}, {chains} chains: {differing} "
                  f"of {runs} launches differ from the first; largest "
                  f"difference {worst:.3e} of max|x| "
                  f"{float(first.abs().max()):.3e}"
                  + (f" at (chain, entry) {where}" if where else ""))
            out[(dtype, side)] = differing
    if any(out.values()):
        raise AssertionError("banded_solve is not repeatable: launches on "
                             "one input differ")
    return out


def check_unwhiten(factor64, N, D, draws, chains, device, max_bytes=1 << 30):
    """K4 as ``unwhiten_draws`` calls it on a large-grid run's draws:
    (C, 1, N*D) contiguous right-hand sides, C = draws x chains of one
    chunk of at most ``max_bytes`` of output, so many waves of clusters
    (the hybrid run's 500 x 256 float32 draws go in chunks of 341 and 159
    draws: 87,296 and 40,704 right-hand sides). On the card against the
    same call with the plain version swapped in, float64 and float32, on
    the float64 ``factor64``; returns {dtype: [relative error per
    chunk]}."""
    from types import SimpleNamespace

    from magi_v2_tpu_torch.sampler.modes import unwhiten_draws

    out = {}
    for dtype in (torch.float64, torch.float32):
        mode = SimpleNamespace(factor=factor64.to(dtype))
        g = torch.Generator(device=device).manual_seed(7)
        Z = torch.randn((draws, chains, N, D), generator=g, dtype=dtype,
                        device=device)
        mu = torch.zeros(D, dtype=dtype, device=device)
        t0 = time.perf_counter()
        got = unwhiten_draws(mode, Z, mu, max_bytes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with plain_kernels():
            ref = unwhiten_draws(mode, Z, mu, max_bytes)
        chunk = max(1, max_bytes // (Z[0].numel() * Z.element_size()))
        errs = [_relerr(ref[i: i + chunk], got[i: i + chunk])[1]
                for i in range(0, draws, chunk)]
        del Z, got, ref
        name = str(dtype).replace("torch.", "")
        tol = SOLVE_TOL[dtype]
        print(f"banded_solve {name} in unwhiten_draws: {draws} x {chains} "
              f"draws in chunks of {chunk * chains} right-hand sides, "
              f"relative error per chunk "
              + ", ".join(f"{e:.1e}" for e in errs)
              + f" (tol {tol:.0e}); {wall:.3f} s")
        if not max(errs) <= tol:
            raise AssertionError(f"banded_solve {name} in unwhiten_draws "
                                 "disagrees with its plain version")
        out[dtype] = errs
    return out


LORENZ_PATH_KERNELS = {
    "hybrid": ("manifold_fwd", "manifold_energy", "manifold_bwd",
               "leapfrog_update", "banded_solve", "banded_solve_adjoint"),
    "banded": ("manifold_fwd", "manifold_energy", "manifold_bwd",
               "leapfrog_update", "banded_solve", "banded_solve_adjoint",
               "banded_matvec", "banded_matvec_adjoint",
               "banded_matvec_pair", "banded_matvec_adjoint_pair"),
}


def lorenz_path(model, device, storage, num_chains, num_steps, gate_theta):
    """predict(storage=...) on the Lorenz fit with the dense-grid recipe
    (sigma pinned, reference annealing at the config's 0.3 floor, diagonal
    mass), gated on finite draws, kernel launches, step size, acceptance
    and (``gate_theta``) the theta means."""
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(
        num_results=num_steps, num_burnin_steps=num_steps,
        num_chains=num_chains, seed=0, init_jitter=0.05, algorithm="hmc",
        hmc_num_leapfrogs=LORENZ_LEAPFROGS, storage=storage,
        anneal_mode="reference", sigma_sqs_fixed=0.25, mass_matrix="diag",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()

    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    mean_L = float(kr["num_leapfrogs"].mean())
    evals = 2 * num_steps * mean_L * num_chains / wall
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    rel = (theta_mean - LORENZ_THETAS) / LORENZ_THETAS
    step = float(kr["step_size"])
    accept = float(kr["accept_probs"].mean())
    print(f"Lorenz {storage} predict wall: {wall:.2f} s ({num_steps}+"
          f"{num_steps} steps, {num_chains} chains, L<={LORENZ_LEAPFROGS}); "
          f"{predict_phases(model, wall)}")
    print(f"Lorenz {storage}: mean acceptance {accept:.4f}, divergence rate "
          f"{kr['divergences'].mean():.5f}, step size {step:.5f}")
    print(f"Lorenz {storage}: theta pooled means "
          f"{np.round(theta_mean, 4).tolist()} (truth "
          f"{np.round(LORENZ_THETAS, 4).tolist()}, relative "
          f"{np.round(rel, 4).tolist()})")
    print(f"Lorenz {storage}: ESS_min {summ['ess_min']:.1f}, rhat_max "
          f"{summ['rhat_max']:.4f}, ESS/s {summ['ess_per_sec_min']:.2f}, "
          f"fused evals/s (sampler-derived) {evals:.4g}")
    print(f"Lorenz {storage}: launch counts {counts}")

    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(thetas))):
        raise AssertionError(f"Lorenz {storage}: non-finite draws")
    check_launched(counts, LORENZ_PATH_KERNELS[storage], f"Lorenz {storage}")
    check_replays(graphs, 2 * num_steps, f"Lorenz {storage}")
    if storage == "banded":
        # K3 per target evaluation: S dr, [R; m] delta, S' g_Ds and
        # [R' | -m'] gcat, one launch each
        evals = counts["manifold_fwd"]
        k3 = {k: counts[k] for k in counts if k.startswith("banded_matvec")}
        print(f"Lorenz banded: {evals} target evaluations, K3 launches {k3}: "
              f"{sum(k3.values()) / evals:.4f} per evaluation")
        # (and the whitening of the start, one banded_matvec at setup)
        if any(not evals <= n <= evals + 1 for n in k3.values()):
            raise AssertionError("the banded path must launch each of K3's "
                                 "four entries once per evaluation")
    if not step >= MIN_STEP_SIZE:
        raise AssertionError(f"Lorenz {storage}: step size {step:.3e} < "
                             f"{MIN_STEP_SIZE:.0e}")
    if not accept >= MIN_ACCEPT:
        raise AssertionError(f"Lorenz {storage}: mean acceptance "
                             f"{accept:.3f} < {MIN_ACCEPT}")
    if gate_theta and not np.all(np.abs(rel) <= 0.15):
        raise AssertionError(f"Lorenz {storage}: theta means {theta_mean} "
                             f"off truth by {rel}")
    return counts


# the centered banded path: centered coordinates at N_I = 1025 are ~1e8
# stiff (the GP prior's curvature), so the run is short and its step and
# theta are printed only
CENTERED_BANDED_STEPS = 100
CENTERED_BANDED_KERNELS = ("manifold_fwd", "manifold_energy", "manifold_bwd",
                           "leapfrog_update", "banded_matvec",
                           "banded_matvec_adjoint", "banded_matvec_pair",
                           "banded_matvec_adjoint_pair")


def centered_banded_path(model, device, num_steps=CENTERED_BANDED_STEPS):
    """``predict(reparam="centered", storage="banded")`` on the Lorenz fit:
    64 chains, ``num_steps`` + ``num_steps`` HMC steps (L <= 64), sigma
    pinned at 0.25, reference annealing, diagonal mass, float32. Fails on
    non-finite draws, K1, K2 or one of K3's four entries never launched,
    K3 not once per evaluation, or K4 launched (centered coordinates have
    no factor to solve with). Returns the kernel results."""
    reset_launch_counts()
    t0 = time.perf_counter()
    res = model.predict(
        num_results=num_steps, num_burnin_steps=num_steps,
        num_chains=BANDED_CHAINS, seed=0, algorithm="hmc",
        hmc_num_leapfrogs=LORENZ_LEAPFROGS, storage="banded",
        reparam="centered", anneal_mode="reference", sigma_sqs_fixed=0.25,
        mass_matrix="diag")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, graphs = launch_counts(), graph_counts()
    kr = res["kernel_results"]
    theta_mean = res["thetas_samps"].reshape(-1, 3).mean(axis=0)
    evals = counts["manifold_fwd"]
    k3 = {k: counts[k] for k in CENTERED_BANDED_KERNELS
          if k.startswith("banded_matvec")}
    print(f"Lorenz centered banded predict wall: {wall:.2f} s ({num_steps}+"
          f"{num_steps} steps, {BANDED_CHAINS} chains, L<="
          f"{LORENZ_LEAPFROGS}); {predict_phases(model, wall)}; step size "
          f"{float(kr['step_size']):.3e}, mean acceptance "
          f"{kr['accept_probs'].mean():.4f}, theta pooled means "
          f"{np.round(theta_mean, 4).tolist()}; {evals} target evaluations, "
          f"K3 launches {k3}, K4 {counts['banded_solve']}")
    if not (np.all(np.isfinite(res["X_samps"]))
            and np.all(np.isfinite(res["thetas_samps"]))):
        raise AssertionError("Lorenz centered banded: non-finite draws")
    check_launched(counts, CENTERED_BANDED_KERNELS, "Lorenz centered banded")
    check_replays(graphs, 2 * num_steps, "Lorenz centered banded")
    if any(n != evals for n in k3.values()) or counts["banded_solve"]:
        raise AssertionError("the centered banded path must launch each of "
                             "K3's four entries once per evaluation and K4 "
                             f"never: {counts}")
    return kr


# --- chain sharding, hmc_jitter, the mid-warmup refresh,
# host staging and the row-blocked pairwise build ---------------------------

# sharded SEIR: float64 at 64 chains, 20 + 20, against the one-shard run;
# float32 at 256 chains, 100 + 100, theta gated, walls printed
SHARD_CHECK_CHAINS, SHARD_CHECK_STEPS = 64, 20
SHARD_CHAINS, SHARD_STEPS = 256, 100
SHARD_TOL = 1e-10
# hmc_jitter=False on the SEIR recipe
NO_JITTER_CHAINS, NO_JITTER_STEPS = 64, 10
# the refresh on the Lorenz banded path: stage A, then 100 + 100
REFRESH_STEPS = 100
REBUILT_TOL = 1e-10
# host staging on the Lorenz hybrid path, blocks of 50 transitions
STAGING_STEPS, STAGING_BLOCK = 200, 50
# the row-blocked pairwise build on a non-uniform float64 grid
ROWBLOCK_POINTS, ROWBLOCK_TOL = 1100, 1e-12
SEIR_RECIPE = dict(init_jitter=0.01, algorithm="hmc",
                   hmc_num_leapfrogs=NUM_LEAPFROGS, mass_matrix="dense",
                   anneal_mode="reference", dense_shrinkage=0.2,
                   mass_window=(0.25, 0.45), mass_window2=(0.50, 0.72),
                   mass_window1_diag=True)


@contextlib.contextmanager
def sampler_hook(mesh=None, before=None, after=None, **changes):
    """predict's sampler call (``api.run_chains``) run over ``mesh`` with
    ``parallel.run_chains_sharded``, and/or with the SamplerConfig fields
    ``changes`` that predict has no argument for (``hmc_jitter``);
    ``before()`` and ``after()``, where given, are called when the sampler
    starts and returns. The package is not changed: the hook is undone on
    exit."""
    import magi_v2_tpu_torch.api as api
    from magi_v2_tpu_torch.parallel import run_chains_sharded
    from magi_v2_tpu_torch.utils.profiling import untimed

    real = api.run_chains

    def hooked(logp_grad, q0, seed, config, timer=untimed):
        config = config._replace(**changes)
        if before is not None:
            before()
        out = (real(logp_grad, q0, seed, config, timer=timer)
               if mesh is None
               else run_chains_sharded(logp_grad, q0, seed, config,
                                       mesh=mesh, timer=timer))
        if after is not None:
            after()
        return out

    api.run_chains = hooked
    try:
        yield
    finally:
        api.run_chains = real


def as_float64(model, hybrid=False):
    """A float64 copy of a fitted model on its device (the fit's arrays)."""
    from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

    arrays = {f: getattr(model, f) for f in FIT_FIELDS}
    m64 = from_fit_arrays(
        arrays, model.f_vec, model.D_thetas, bandsize=model.BANDSIZE,
        config=model.config.replace(dtype=torch.float64),
        exact_operators=model._exact_operators() if hybrid else None,
    )
    m64.beta = model.beta
    return m64


def sharded_seir(model, device):
    """Chain sharding on the SEIR HMC recipe over two shards of the card
    (``chain_mesh([cuda:0, cuda:0])``: each shard its own target copy,
    workspaces and CUDA graphs, the noise and the pooled statistics on the
    gathered chains). Float64, 64 chains: the 20 + 20 predict's draws
    against the one-shard run's (printed: cuBLAS rounds a product of 32
    rows otherwise than one of 64, and the run's adaptation and
    trajectories grow that), then one transition from that run's last
    states (no warmup, identity mass, the same noise) by both, which must
    agree to SHARD_TOL of their scale. Float32, 256 chains, 100 + 100: K1
    and K2 launched, finite draws, theta within 15% of truth; both walls
    printed. Returns the float32 sharded run's launch counts."""
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.parallel import chain_mesh, run_chains_sharded
    from magi_v2_tpu_torch.sampler.run import SamplerConfig, run_chains
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    mesh = chain_mesh([device, device])
    m64 = as_float64(model)
    kw = dict(num_results=SHARD_CHECK_STEPS,
              num_burnin_steps=SHARD_CHECK_STEPS,
              num_chains=SHARD_CHECK_CHAINS, seed=3, **SEIR_RECIPE)
    ref = m64.predict(**kw)
    with sampler_hook(mesh=mesh):
        sh = m64.predict(**kw)
    a, b = ref["sample_results"], sh["sample_results"]
    run_err = float(np.abs(a - b).max() / np.abs(a).max())
    mode = m64._build_sampling_setup("precond", "dense", torch.float64)[0]
    q = torch.as_tensor(a[-1], device=device)
    cfg = SamplerConfig(num_results=1, num_burnin_steps=0,
                        use_annealing=False, algorithm="hmc",
                        hmc_num_leapfrogs=NUM_LEAPFROGS,
                        dense_tail_size=q.shape[1])
    one, st = run_chains(mode.logp_grad, q, 7, cfg)
    two, _ = run_chains_sharded(mode.logp_grad, q, 7, cfg, mesh=mesh)
    step_err = float((one - two).abs().max() / one.abs().max())
    print(f"sharded SEIR float64 ({SHARD_CHECK_CHAINS} chains, 2 shards of "
          f"one card) vs one shard: the {SHARD_CHECK_STEPS}+"
          f"{SHARD_CHECK_STEPS} predict's draws max relative difference "
          f"{run_err:.3e} (bit for bit: {bool(np.all(a == b))}); one "
          f"transition from its last states ({int(st.num_leapfrogs[0, 0])} "
          f"leapfrogs, acceptance {float(st.accept_probs.mean()):.3f}) "
          f"{step_err:.3e} (bit for bit: {bool(torch.equal(one, two))}; tol "
          f"{SHARD_TOL:.0e})")
    if not step_err <= SHARD_TOL:
        raise AssertionError("a sharded float64 SEIR transition differs from "
                             f"the one-shard transition by {step_err:.3e}")

    kw = dict(num_results=SHARD_STEPS, num_burnin_steps=SHARD_STEPS,
              num_chains=SHARD_CHAINS, seed=0, **SEIR_RECIPE)
    walls = {}
    for label in ("one shard", "two shards"):
        reset_launch_counts()
        t0 = time.perf_counter()
        with sampler_hook(mesh=None if label == "one shard" else mesh):
            res = model.predict(**kw)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        counts = launch_counts()
    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, walls["two shards"])
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    rel = np.abs(theta_mean - TRUE_THETAS) / TRUE_THETAS
    print(f"sharded SEIR float32 ({SHARD_CHAINS} chains, {SHARD_STEPS}+"
          f"{SHARD_STEPS}, L<={NUM_LEAPFROGS}): predict wall "
          f"{walls['two shards']:.2f} s over 2 shards, "
          f"{walls['one shard']:.2f} s over one; {predict_phases(model, walls['two shards'])}; "
          f"step {float(kr['step_size']):.5f}, acceptance "
          f"{kr['accept_probs'].mean():.4f}, theta "
          f"{np.round(theta_mean, 4).tolist()} (relative "
          f"{np.round(rel, 4).tolist()}), rhat_max {summ['rhat_max']:.4f}; "
          f"launch counts {counts}")
    if not (np.all(np.isfinite(res["X_samps"])) and np.all(np.isfinite(thetas))):
        raise AssertionError("sharded SEIR: non-finite draws")
    check_launched(counts, mf.KERNELS + ("leapfrog_update",), "sharded SEIR")
    if not np.all(rel <= 0.15):
        raise AssertionError(f"sharded SEIR: theta means {theta_mean} off "
                             f"truth by {rel}")
    return counts


def no_jitter_check(model):
    """``hmc_jitter=False`` (a SamplerConfig field, which predict passes
    at its default: set through the sampler hook) on the SEIR recipe: every
    transition takes exactly hmc_num_leapfrogs."""
    reset_launch_counts()
    t0 = time.perf_counter()
    with sampler_hook(hmc_jitter=False):
        res = model.predict(num_results=NO_JITTER_STEPS,
                            num_burnin_steps=NO_JITTER_STEPS,
                            num_chains=NO_JITTER_CHAINS, seed=1,
                            **SEIR_RECIPE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    L = res["kernel_results"]["num_leapfrogs"]
    graphs = graph_counts()
    print(f"SEIR hmc_jitter=False ({NO_JITTER_CHAINS} chains, "
          f"{NO_JITTER_STEPS}+{NO_JITTER_STEPS}): {wall:.2f} s, leapfrogs a "
          f"transition {sorted(set(np.asarray(L).ravel().tolist()))}, graph "
          f"replays {graphs}")
    if not (np.all(L == NUM_LEAPFROGS) and np.all(np.isfinite(
            res["thetas_samps"]))):
        raise AssertionError("hmc_jitter=False: a transition took another "
                             f"length than {NUM_LEAPFROGS}, or non-finite "
                             "draws")


def refresh_path(model, device, restart):
    """``predict(storage="banded", precond_refresh_steps=100,
    precond_refresh_restart=restart)`` on the Lorenz fit, 64 chains, the
    banded run's recipe otherwise (sigma pinned at 0.25, reference
    annealing, diagonal mass, HMC L <= 64), 100 + 100 after the 100 steps
    of stage A. Fails on non-finite draws, or K1, K2, K3 or K4 not launched
    after the rebuild (stage B's own target); then the rebuilt float64
    target at the new anchor on the card against the same target on the
    CPU. Step, acceptance, divergences, rhat and the walls are printed, not
    gated: the JAX package measured the refresh harmful at this scale."""
    import magi_v2_tpu_torch.sampler.modes as modes_mod
    from magi_v2_tpu_torch.utils.diagnostics import summarize_chains

    anchors, after = [], {}
    build_parts, reanchor = modes_mod._build_banded_gn_parts, \
        modes_mod.reanchor

    def recording_build(*args, **kw):
        anchors.append((args[5], args[6]))
        return build_parts(*args, **kw)

    def marking_reanchor(*args, **kw):
        out = reanchor(*args, **kw)
        torch.cuda.synchronize()
        after.update(launch_counts())
        return out

    modes_mod._build_banded_gn_parts = recording_build
    modes_mod.reanchor = marking_reanchor
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = model.predict(
                num_results=REFRESH_STEPS, num_burnin_steps=REFRESH_STEPS,
                num_chains=BANDED_CHAINS, seed=0, init_jitter=0.05,
                algorithm="hmc", hmc_num_leapfrogs=LORENZ_LEAPFROGS,
                storage="banded", anneal_mode="reference",
                sigma_sqs_fixed=0.25, mass_matrix="diag",
                precond_refresh_steps=REFRESH_STEPS,
                precond_refresh_restart=restart)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        modes_mod._build_banded_gn_parts = build_parts
        modes_mod.reanchor = reanchor
    counts = launch_counts()
    stage_b = {k: counts[k] - after.get(k, 0) for k in counts}
    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    t = model.predict_timings
    warned = any("HARMFUL" in str(w.message) for w in caught)
    print(f"Lorenz banded refresh ({restart}): predict {wall:.2f} s (stage A "
          f"{t['refresh_stage_a']:.2f} s, rebuild and restart "
          f"{t['refresh_rebuild']:.2f} s, stage B {t['sampling']:.2f} s; "
          f"{predict_phases(model, wall)}); step "
          f"{float(kr['step_size']):.3e}, acceptance "
          f"{kr['accept_probs'].mean():.4f}, divergences "
          f"{kr['divergences'].mean():.4f}, rhat_max {summ['rhat_max']:.3f}, "
          f"theta {np.round(theta_mean, 4).tolist()}; new anchor's theta "
          f"{np.round(anchors[-1][1], 4).tolist()}; warned: {warned}")
    print(f"Lorenz banded refresh ({restart}): launches after the rebuild "
          f"{ {k: v for k, v in stage_b.items() if v} }")
    if not (np.all(np.isfinite(res["X_samps"])) and np.all(np.isfinite(thetas))):
        raise AssertionError(f"refresh ({restart}): non-finite draws")
    check_launched(stage_b, ("manifold_fwd", "manifold_energy",
                             "manifold_bwd", "leapfrog_update",
                             "banded_matvec", "banded_matvec_adjoint",
                             "banded_matvec_pair",
                             "banded_matvec_adjoint_pair", "banded_solve",
                             "banded_solve_adjoint"),
                   f"Lorenz banded refresh ({restart}) stage B")
    if not warned:
        raise AssertionError("the refresh did not warn")
    check_composed(model, device, "banded", tail=LORENZ_TAIL,
                   rebuild_at=anchors[-1], tol=REBUILT_TOL)
    return stage_b


def staging_check(model, device):
    """Host staging on the Lorenz hybrid recipe (64 chains, 100 + 200,
    blocks of 50 transitions): ``stage_above_bytes=0`` against the default
    (draws on the card): the results equal bit for bit; the peak device
    memory above the sampler's start, through the sampler and through the
    sampler and the unwhitening, printed for both, with the staged bytes
    and the host's time in the copies."""
    kw = dict(num_results=STAGING_STEPS, num_burnin_steps=STAGING_STEPS // 2,
              num_chains=BANDED_CHAINS, seed=0, init_jitter=0.05,
              algorithm="hmc", hmc_num_leapfrogs=LORENZ_LEAPFROGS,
              storage="hybrid", anneal_mode="reference",
              sigma_sqs_fixed=0.25, mass_matrix="diag",
              dispatch_block_steps=STAGING_BLOCK, profile_timings=True)
    out = {}
    for label, extra in (("on the card", {}),
                         ("staged", {"stage_above_bytes": 0})):
        # the peaks above what is allocated when each phase starts, with
        # an earlier run's garbage collected
        gc.collect()
        torch.cuda.synchronize()
        peak = {"base": torch.cuda.memory_allocated(device)}
        torch.cuda.reset_peak_memory_stats(device)

        def sampler_starts():
            peak["sampler_base"] = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)

        def sampler_ends():
            torch.cuda.synchronize()
            peak["sampler"] = (torch.cuda.max_memory_allocated(device)
                               - peak["sampler_base"])

        t0 = time.perf_counter()
        with sampler_hook(before=sampler_starts, after=sampler_ends):
            res = model.predict(**kw, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak["after"] = (torch.cuda.max_memory_allocated(device)
                         - peak["sampler_base"])
        t = res["timings"]
        print(f"Lorenz hybrid staging, draws {label}: predict {wall:.2f} s; "
              f"peak device memory above its start: "
              f"{peak['sampler'] / 2**20:.1f} MiB through the sampler, "
              f"{peak['after'] / 2**20:.1f} MiB through the sampler and the "
              f"unwhitening; staged {t['staged_bytes']} bytes, host time in "
              f"the copies {t['sample_stage_s']:.4f} s, unwhiten "
              f"{t['unwhiten_s']:.2f} s")
        out[label] = res
    a, b = out["on the card"], out["staged"]
    keys = ("X_samps", "thetas_samps", "sigma_sqs_samps", "sample_results")
    same = all(np.array_equal(a[k], b[k]) for k in keys) and all(
        np.array_equal(a["kernel_results"][k], b["kernel_results"][k])
        for k in ("accept_probs", "divergences", "num_leapfrogs"))
    if not (same and b["timings"]["staged_bytes"] > 0):
        raise AssertionError("staged draws differ from the draws kept on "
                             "the card")


def rowblocked_check(device):
    """The pairwise Matern build on a non-uniform float64 grid of 1100
    points on the card: the direct (N, N) build against the row-blocked one
    (tiles of 512 rows) that ``matern_derivative_matrices`` takes from
    1024 points up; each output within ROWBLOCK_TOL of its scale; peak
    device memory and time of each printed."""
    from magi_v2_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(4)
    s = torch.tensor(np.sort(rng.uniform(0.0, 20.0, ROWBLOCK_POINTS)),
                     dtype=torch.float64, device=device)
    builds = {"direct": lambda: K._matern_parts(*K._pairwise(s), 1.3, 0.7,
                                                2.01),
              "row-blocked": lambda: K.matern_derivative_matrices(
                  s, 1.3, 0.7, 2.01)}
    outs, line = {}, []
    for name, fn in builds.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(device) - base
        line.append(f"{name} {peak / 2**20:.1f} MiB, {ms:.1f} ms")
    errs = [float((a - b).abs().max() / a.abs().max())
            for a, b in zip(outs["direct"], outs["row-blocked"])]
    print(f"pairwise Matern build, {ROWBLOCK_POINTS} non-uniform points, "
          f"float64, peak memory above the inputs: " + "; ".join(line)
          + f"; row-blocked vs direct relative errors "
          f"{[f'{e:.2e}' for e in errs]} (tol {ROWBLOCK_TOL:.0e})")
    if not max(errs) <= ROWBLOCK_TOL:
        raise AssertionError("the row-blocked Matern build disagrees with "
                             "the direct one")


def main():
    t_start = time.perf_counter()
    smi = check_device()
    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    build()
    print(f"build phase: {time.perf_counter() - t0:.1f} s")
    timing = check_kernels(device)
    # a chain count and a grid that fill no tile of K1's or K3's
    check_kernels(device, N=333, C=37)
    # the functors of the six other fields there and at the Hes1 path's 64
    # chains and N_I = 129
    for name in NEW_FUNCTORS:
        check_kernels(device, model=name, N=333, C=37, reps=20)
        timing.update(check_kernels(device, model=name, N=HES1_GRID,
                                    C=HES1_CHAINS, reps=50))
    # K1's whitened form at the SEIR shapes, at a ragged count and grid,
    # and in the given kernels
    timing.update(check_whitened_kernels(device))
    check_whitened_kernels(device, N=333, C=37, reps=20)
    check_whitened_kernels(device, model="fhn", N=FHN_GRID, C=FHN_CHAINS,
                           reps=20)
    timing.update(check_leapfrog(device))
    check_wide_leapfrog(device)
    timing.update(check_leapfrog_nuts(device))
    timing.update(check_nuts_leaf(device))
    # K2's NUTS form and the leaf kernel on the Hes1 path's diagonal metric
    timing.update(check_leapfrog_nuts(
        device, chains=(HES1_CHAINS,), cases=HES1_NUTS_CASES,
        record=("diag397", HES1_CHAINS, "leapfrog_update_nuts_hes1")))
    timing.update(check_nuts_leaf(
        device, chains=(HES1_CHAINS,), cases=HES1_NUTS_CASES,
        record=("diag397", HES1_CHAINS, "nuts_leaf_hes1")))
    # K1 with a temperature per chain, and K6, the swap kernel
    for model, N, C in K1_PT_CASES:
        recorded = check_k1_per_chain(device, model, N, C,
                                      reps=200 if C == NUM_CHAINS else 20)
        if model != "fhn" and C != 37:
            timing.update(recorded)
    timing.update(check_pt_swap(device))
    rowblocked_check(device)
    print(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")
    model, counts_seir = main_path(device)
    print(f"SEIR HMC path done at {time.perf_counter() - t_start:.1f} s")
    check_composed(model, device)
    profile_leapfrog(model, device)
    graph_vs_eager(model, device, "dense", NUM_CHAINS, NUM_LEAPFROGS,
                   (-10.5, -10.5, -10.5, 1.8, -0.5, 0.6), step_size=0.05,
                   beta_temp=0.5, dense_mass=True)
    seir_pt_graph_vs_eager(model, device)
    counts_nuts, kr_nuts = nuts_path(model, device)
    nuts_graph_vs_eager(model, device, kr_nuts)
    profile_nuts(model, device, kr_nuts)
    print(f"SEIR NUTS path done at {time.perf_counter() - t_start:.1f} s")
    counts_wh, kr_wh = whitened_path(model, device)
    check_composed(model, device, reparam="whitened")
    nuts_graph_vs_eager(model, device, kr_wh, label="SEIR whitened NUTS",
                        reparam="whitened")
    profile_nuts(model, device, kr_wh, settle=2, counted=2,
                 reparam="whitened", label="SEIR whitened NUTS")
    warmstart_check(model, device)
    print(f"SEIR whitened path done at {time.perf_counter() - t_start:.1f} s")
    sharded_seir(model, device)
    no_jitter_check(model)
    print(f"SEIR sharding and hmc_jitter done at "
          f"{time.perf_counter() - t_start:.1f} s")
    fmodel = lbfgs_fit(device, model)
    start = forecast_start(fmodel)
    timing.update(forecast_kernels(device))
    counts_fc = forecast_path(fmodel, start)
    resume_check(fmodel)
    trace_check(fmodel, device)
    print(f"SEIR L-BFGS and forecast block done at "
          f"{time.perf_counter() - t_start:.1f} s")
    # K1's given kernels at the unregistered field's shapes (16 chains,
    # N_I = 81) and at a ragged count and grid of several CTAs a chain
    timing.update(check_kernels(device, model="fhn", N=FHN_GRID,
                                C=FHN_CHAINS))
    check_kernels(device, model="fhn", N=333, C=RAGGED_CHAINS)
    counts_fhn = unregistered_field(device)
    bimodal_pt(device)
    print(f"SEIR phases done at {time.perf_counter() - t_start:.1f} s")

    hmodel, logH_true = hes1_fit(device)
    counts_hes1, kr_hes1, last, coverage = hes1_path(hmodel, device,
                                                     logH_true)
    hes1_after(hmodel, device, kr_hes1, last)
    print(f"Hes1 phases done at {time.perf_counter() - t_start:.1f} s")
    _, coverage_laplace = hes1_laplace(hmodel, device, logH_true, coverage)
    print(f"Hes1 Laplace phase done at {time.perf_counter() - t_start:.1f} s")
    counts_pt, kr_pt, last_pt = hes1_pt(hmodel, device, logH_true,
                                        (coverage, coverage_laplace))
    hes1_pt_after(hmodel, device, kr_pt, last_pt)
    print(f"Hes1 PT phase done at {time.perf_counter() - t_start:.1f} s")

    lmodel = lorenz_fit(device)
    timing.update(check_kernels(device, model="lorenz", N=lmodel.mag_I))
    # K1's grid follows the chain count: the banded run's 64 chains take
    # more CTAs a chain than the hybrid run's 256, and 257 fill no wave
    timing.update(check_kernels(device, model="lorenz", N=lmodel.mag_I,
                                C=BANDED_CHAINS, tag=f"_c{BANDED_CHAINS}"))
    check_kernels(device, model="lorenz", N=lmodel.mag_I, C=RAGGED_CHAINS)
    timing.update(check_banded_kernels(lmodel, device))
    counts_h = lorenz_path(lmodel, device, "hybrid", LORENZ_CHAINS,
                           LORENZ_STEPS, gate_theta=True)
    counts_b = lorenz_path(lmodel, device, "banded", BANDED_CHAINS,
                           BANDED_STEPS, gate_theta=False)
    print(f"Lorenz paths done at {time.perf_counter() - t_start:.1f} s")
    for storage in ("hybrid", "banded"):
        check_composed(lmodel, device, storage, tail=LORENZ_TAIL)
    per_launch = profile_leapfrog(
        lmodel, device, "hybrid", tail=LORENZ_TAIL, step_size=0.05,
        beta_temp=0.3, dense_mass=False, num_leapfrogs=64, reps=3)
    report_solve(timing, per_launch)
    profile_leapfrog(
        lmodel, device, "banded", tail=LORENZ_TAIL, step_size=0.03,
        beta_temp=0.3, dense_mass=False, num_chains=BANDED_CHAINS,
        num_leapfrogs=64, reps=3)
    for storage, chains, eps in (("hybrid", LORENZ_CHAINS, 0.05),
                                 ("banded", BANDED_CHAINS, 0.03)):
        graph_vs_eager(lmodel, device, storage, chains, LORENZ_LEAPFROGS,
                       LORENZ_TAIL, step_size=eps, beta_temp=0.3,
                       dense_mass=False, sigma_fixed=0.25)
    check_composed(lmodel, device, "banded", tail=LORENZ_TAIL,
                   reparam="centered")
    kr_cb = centered_banded_path(lmodel, device)
    graph_vs_eager(lmodel, device, "banded", BANDED_CHAINS, LORENZ_LEAPFROGS,
                   LORENZ_TAIL, step_size=float(kr_cb["step_size"]),
                   beta_temp=0.3, dense_mass=False, sigma_fixed=0.25,
                   reparam="centered")
    print(f"Lorenz centered banded done at "
          f"{time.perf_counter() - t_start:.1f} s")
    for restart in ("remap", "laplace"):
        refresh_path(lmodel, device, restart)
    staging_check(lmodel, device)
    print(f"Lorenz refresh and staging done at "
          f"{time.perf_counter() - t_start:.1f} s")

    def entry(name, kernel, source, path, counts):
        return dict(name=name, route="cuda", source=SOURCES[source],
                    replaces=REPLACES[kernel], path=path,
                    launches=counts[kernel], **timing[name])

    kernels = [entry(k, k, "manifold", "seir_dense", counts_seir)
               for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")]
    kernels.append(dict(
        name="manifold_fwd_whitened", route="cuda",
        source=SOURCES["manifold"], replaces=REPLACES["manifold_fwd_whitened"],
        path="seir_whitened", launches=counts_wh["manifold_fwd_whitened_seir"],
        **timing["manifold_fwd_whitened"]))
    kernels += [entry(f"{k}_fhn", k, "manifold", "fhn_unregistered",
                      counts_fhn)
                for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")]
    kernels += [dict(name=f"{k}_hes1_log", route="cuda",
                     source=SOURCES["manifold"],
                     replaces=REPLACES["hes1_centered"], path="hes1_centered",
                     launches=counts_hes1[f"{k}_hes1_log"],
                     **timing[f"{k}_hes1_log"])
                for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")]
    kernels += [entry(f"{k}_lorenz", k, "manifold", "lorenz_hybrid",
                      counts_h)
                for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")]
    kernels += [entry(f"{k}_lorenz_c{BANDED_CHAINS}", k, "manifold",
                      "lorenz_banded", counts_b)
                for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")]
    paths = {"leapfrog_update_seir": ("seir_dense", counts_seir),
             "leapfrog_update": ("lorenz_hybrid", counts_h),
             f"leapfrog_update_c{BANDED_CHAINS}": ("lorenz_banded",
                                                   counts_b)}
    kernels += [entry(name, "leapfrog_update", "leapfrog", *paths[name])
                for name, _, _ in K2_ENTRIES]
    kernels.append(dict(
        name="leapfrog_update_nuts", route="cuda", source=SOURCES["leapfrog"],
        replaces=REPLACES["leapfrog_update_nuts"], path="seir_nuts",
        launches=counts_nuts["leapfrog_update"],
        **timing["leapfrog_update_nuts"]))
    kernels.append(entry("nuts_leaf", "nuts_leaf", "nuts", "seir_nuts",
                         counts_nuts))
    kernels += [entry(f"{k}_seir_forecast", k, "manifold", "seir_forecast",
                      counts_fc)
                for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")]
    kernels.append(dict(
        name="leapfrog_update_nuts_seir_forecast", route="cuda",
        source=SOURCES["leapfrog"], replaces=REPLACES["leapfrog_update_nuts"],
        path="seir_forecast", launches=counts_fc["leapfrog_update"],
        **timing["leapfrog_update_nuts_seir_forecast"]))
    kernels.append(entry("nuts_leaf_seir_forecast", "nuts_leaf", "nuts",
                         "seir_forecast", counts_fc))
    kernels.append(dict(
        name="leapfrog_update_nuts_hes1", route="cuda",
        source=SOURCES["leapfrog"], replaces=REPLACES["leapfrog_update_nuts"],
        path="hes1_centered", launches=counts_hes1["leapfrog_update"],
        **timing["leapfrog_update_nuts_hes1"]))
    kernels.append(entry("nuts_leaf_hes1", "nuts_leaf", "nuts",
                         "hes1_centered", counts_hes1))
    kernels += [dict(name=f"{k}_pt_hes1_log", route="cuda",
                     source=SOURCES["manifold"],
                     replaces=REPLACES["k1_per_chain"], path="hes1_pt",
                     launches=counts_pt[f"{k}_hes1_log_pt"],
                     **timing[f"{k}_pt_hes1_log"])
                for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")]
    kernels.append(entry("pt_swap", "pt_swap", "pt", "hes1_pt", counts_pt))
    kernels += [entry(k, k, "banded", "lorenz_hybrid", counts_h)
                for k in ("banded_solve", "banded_solve_adjoint")]
    kernels += [entry(k, k, "banded", "lorenz_banded", counts_b)
                for k in ("banded_matvec", "banded_matvec_adjoint",
                          "banded_matvec_pair",
                          "banded_matvec_adjoint_pair")]
    print(f"smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

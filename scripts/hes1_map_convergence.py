"""Does map_estimate meet its own convergence criterion on the Hes1 recipe?

Runs the JAX package's ``MAGI_v2.map_estimate(sigma_sqs_fixed=0.15**2,
laplace_draws=64, draws_seed=101)`` (the Laplace-start recipe of
``scripts/hes1_long.py --init laplace``) on the Hes1 data of
examples/hes1.py (P and M observed on the log scale, H never;
discretization 2, beta = 1), the fit at the config's full iteration
counts, in float64 on the CPU, and prints each L-BFGS-B pass (verbose),
the total iterations, ``converged``, the projected gradient, the MAP,
theta_map's g (theta[5]; > 8 is the truth basin), and the Hessian's
smallest over largest eigenvalue. The port's smoke (chip_smoke.py, its
Hes1 Laplace phase) reads these to decide what it can gate on. Writes
nothing; takes some 10-15 minutes on a CPU.

    python scripts/hes1_map_convergence.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from magi_v2_tpu import MAGI_v2, MagiConfig
    from magi_v2_tpu.models import MODEL_REGISTRY, hes1_log_f_vec
    from magi_v2_tpu.utils.data import simulate_ode

    reg = MODEL_REGISTRY["hes1"]
    ts, _, X_true = simulate_ode(reg.f_vec, x0=np.array([1.439, 2.037, 17.904]),
                                 thetas=np.array(reg.true_thetas),
                                 t_max=240.0, n_obs=33, noise_sd=0.0,
                                 substeps=200)
    X = np.log(X_true) + 0.15 * np.random.default_rng(0).standard_normal(
        X_true.shape)
    X[:, 2] = np.nan
    model = MAGI_v2(7, ts, X, None, hes1_log_f_vec, MagiConfig())
    t0 = time.time()
    model.initial_fit(discretization=2)
    print(f"initial_fit {time.time() - t0:.1f} s, thetas_init "
          f"{np.round(model.thetas_init, 4).tolist()}", flush=True)
    model.beta = 1.0
    t0 = time.time()
    r = model.map_estimate(sigma_sqs_fixed=0.15 ** 2, laplace_draws=64,
                           draws_seed=101, verbose=True)
    print(f"map_estimate {time.time() - t0:.1f} s: {r['lbfgs_iters']} "
          f"L-BFGS-B iterations, converged {r['converged']}, projected "
          f"gradient {r['grad_norm']:.4g} (criterion "
          f"{1e-3 * (1 + abs(r['neg_logpost'])):.4g}), F "
          f"{r['neg_logpost']:.4f}, {r['lbfgs_message']}")
    print(f"theta_map {np.round(r['theta_map'], 4).tolist()} (g "
          f"{r['theta_map'][5]:.3f}), Hessian SPD {r['hessian_spd']}, "
          f"smallest/largest eigenvalue {r['hessian_min_eig_rel']:.3e}, "
          f"draws' g {r['theta_draws'][:, 5].min():.3f} to "
          f"{r['theta_draws'][:, 5].max():.3f}")


if __name__ == "__main__":
    main()

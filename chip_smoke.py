"""Smoke run of magi_v2_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the last line below is printed
only when all of them passed):

1. Device: requires CUDA; prints the card's name and power limit as
   nvidia-smi reports them, and the torch and CUDA versions.
2. Build: compiles the hand-written kernels (csrc/*.cu, nvcc, sm_90a).
3. Kernels vs plain: each K1 kernel against its plain PyTorch version on
   the same inputs at the SEIR bench shapes (256 chains, N_I = 161, D = 3),
   in float32 and float64, timed with CUDA events.
4. Main path: SEIR data (t_max 4, 81 observations), ``initial_fit`` and a
   256-chain, L = 192, dense-metric HMC ``predict`` (1000 + 1000 steps) in
   float32 on the card. Fails on non-finite draws, a kernel that never
   launched, rhat_max > 1.05, or a theta mean more than 15% from truth.
5. The composed float64 target on the card against the same target on
   the CPU (plain versions), for 8 states near the fit.
6. Leapfrog profile: ms per leapfrog with the kernels and with their plain
   versions swapped into the target, host time per wrapper call, and
   torch.profiler's device time by kernel over one transition.

The last two lines are a JSON object with each kernel's launch count,
error and times, and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# kernel-vs-plain tolerances, relative to the largest |value| of each
# logical output (output_parts): float64 sums differ only in order;
# float32 sums of ~500 terms in another order differ by a few ulps of the
# total
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# composed float64 target, card vs CPU, relative to max |value|
COMPOSED_TOL = 1e-9
TRUE_THETAS = np.array([6.0, 0.6, 1.8])
NUM_CHAINS, NUM_LEAPFROGS, NUM_STEPS = 256, 192, 1000
REPLACES = {
    "manifold_fwd": "magi_v2_tpu/sampler/precond.py:540",
    "manifold_energy": "magi_v2_tpu/posterior.py:288",
    "manifold_bwd": "magi_v2_tpu/sampler/precond.py:549",
}


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
    print(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    return lib


def kernel_inputs(dtype, device, C=256, N=161, D=3, P=3, seed=0):
    """Inputs of the three kernels at realistic magnitudes."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s, scale=1.0: (scale * torch.randn(s, generator=g,
                                                   dtype=torch.float64))
    dim = N * D + D + P
    q = r(C, dim)
    q[:, N * D: N * D + D] = -10.5 + r(C, D, scale=0.1)
    q[:, N * D + D:] = torch.tensor([1.8, -0.3, 1.5]) + r(C, P, scale=0.1)
    x0T = 0.5 * torch.rand((D, N), generator=g, dtype=torch.float64)
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


def _time_ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(device):
    """Each kernel against its plain version, float32 and float64; returns
    {name: {max_abs_err, ms, plain_ms}} for float32 (the sampling dtype)."""
    from magi_v2_tpu_torch.models import seir_f_vec as f
    from magi_v2_tpu_torch.ops import manifold as mf

    results = {}
    for dtype in (torch.float64, torch.float32):
        x = kernel_inputs(dtype, device)
        D, N = x["x0T"].shape
        I = torch.zeros((N, 1), dtype=dtype, device=device)
        fwd_args = (f, I, x["delta"], x["RmD"], x["q"], x["x0T"], x["a0"],
                    x["f0"], x["mask"], x["y"], x["sigma_lb"],
                    x["beta_temp"], x["beta"])
        dr, gcat, t14 = mf.manifold_fwd(*fwd_args)
        pdr, pgcat, pt14 = mf.manifold_fwd_plain(*fwd_args)
        # manifold_fwd writes only the first half of gcat
        fwd_err = part_errors([("dr", pdr, dr), ("t14", pt14, t14),
                               ("g_Rd", pgcat[..., :N], gcat[..., :N])], N, D)

        en_args = (f, x["Ds"], x["s0"], pt14, x["q"], x["sigma_lb"],
                   x["n_ds"], x["beta_temp"], x["beta"])
        lp, gDs = mf.manifold_energy(*en_args)
        plp, pgDs = mf.manifold_energy_plain(*en_args)
        en_err = part_errors([("lp", plp, lp), ("gDs", pgDs, gDs)], N, D)

        def bwd(fn, gc, gr):
            return fn(f, I, x["gdr"], x["delta"], x["q"], x["x0T"],
                      x["mask"], x["y"], x["sigma_lb"], x["n_ds"],
                      x["beta_temp"], gc, gr)

        gc_k, gr_k = pgcat.clone(), torch.zeros_like(x["q"])
        gc_p, gr_p = pgcat.clone(), torch.zeros_like(x["q"])
        gp_k = bwd(mf.manifold_bwd, gc_k, gr_k)
        gp_p = bwd(mf.manifold_bwd_plain, gc_p, gr_p)
        bwd_err = part_errors([("gpart", gp_p, gp_k), ("gcat", gc_p, gc_k),
                               ("grad", gr_p, gr_k)], N, D)
        torch.cuda.synchronize()

        name = str(dtype).replace("torch.", "")
        for kname, errs, fk, fp in (
            ("manifold_fwd", fwd_err,
             lambda: mf.manifold_fwd(*fwd_args),
             lambda: mf.manifold_fwd_plain(*fwd_args)),
            ("manifold_energy", en_err,
             lambda: mf.manifold_energy(*en_args),
             lambda: mf.manifold_energy_plain(*en_args)),
            ("manifold_bwd", bwd_err,
             lambda: bwd(mf.manifold_bwd, gc_k, gr_k),
             lambda: bwd(mf.manifold_bwd_plain, gc_p, gr_p)),
        ):
            worst_part = max(errs, key=lambda p: errs[p][1])
            worst_rel = errs[worst_part][1]
            worst_abs = max(e[0] for e in errs.values())
            ms, plain_ms = _time_ms(fk), _time_ms(fp)
            print(f"{kname} {name}: max_abs_err {worst_abs:.3e}, relative "
                  f"per output "
                  + ", ".join(f"{p} {e[1]:.1e}" for p, e in errs.items())
                  + f" (tol {TOL[dtype]:.0e}); kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms")
            if not worst_rel <= TOL[dtype]:
                raise AssertionError(
                    f"{kname} {name} disagrees with its plain version: "
                    f"{worst_part} relative error {worst_rel:.3e} > "
                    f"{TOL[dtype]:.0e}"
                )
            if dtype == torch.float32:
                results[kname] = dict(max_abs_err=worst_abs, ms=ms,
                                      plain_ms=plain_ms)
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

    mf.reset_launch_counts()
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
    counts = mf.launch_counts()

    kr = res["kernel_results"]
    thetas = res["thetas_samps"]
    summ = summarize_chains(thetas, wall)
    mean_L = float(kr["num_leapfrogs"].mean())
    evals = 2 * num_steps * mean_L * NUM_CHAINS / wall
    theta_mean = thetas.reshape(-1, 3).mean(axis=0)
    print(f"predict wall: {wall:.2f} s ({num_steps}+{num_steps} steps, "
          f"{NUM_CHAINS} chains, L<={NUM_LEAPFROGS})")
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
    idle = [k for k, n in counts.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    if not summ["rhat_max"] <= 1.05:
        raise AssertionError(f"rhat_max {summ['rhat_max']:.4f} > 1.05")
    rel = np.abs(theta_mean - TRUE_THETAS) / TRUE_THETAS
    if not np.all(rel <= 0.15):
        raise AssertionError(f"theta means {theta_mean} off truth by {rel}")
    return model, counts


def check_composed(model, device):
    """The float64 K1 target on the card against the same target, moved to
    the CPU (plain versions), at 8 states near the fit."""
    from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

    arrays = {f: getattr(model, f) for f in FIT_FIELDS}
    m64 = from_fit_arrays(arrays, model.f_vec, model.D_thetas,
                          bandsize=model.BANDSIZE,
                          config=model.config.replace(dtype=torch.float64))
    mode, _, _ = m64._build_sampling_setup("precond", "dense", torch.float64)
    target = mode.logp_grad
    cpu_target = target.to("cpu")
    rng = np.random.default_rng(1)
    N, D = m64.mag_I, m64.D
    q0 = np.concatenate([mode.X0.cpu().numpy().ravel(), [-10.5] * D,
                         [1.8, -0.5, 0.6]])
    q = q0 + 0.1 * rng.standard_normal((8, q0.size))
    bt = torch.tensor(0.37, dtype=torch.float64)
    lp_c, g_c = cpu_target(torch.as_tensor(q), bt)
    lp_d, g_d = target(torch.as_tensor(q, device=device), bt.to(device))
    torch.cuda.synchronize()
    e_lp = _relerr(lp_c, lp_d.cpu())[1]
    e_g = _relerr(g_c, g_d.cpu())[1]
    print(f"composed float64 target, card vs CPU: lp rel {e_lp:.3e}, grad "
          f"rel {e_g:.3e} (tol {COMPOSED_TOL:.0e})")
    if not (e_lp <= COMPOSED_TOL and e_g <= COMPOSED_TOL):
        raise AssertionError("composed target disagrees between card and CPU")


@contextlib.contextmanager
def plain_k1():
    """The plain versions swapped into the sampler's K1 target, which the
    wrappers never take on a CUDA tensor: the baseline of the leapfrog
    timings below."""
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.sampler import precond

    saved = {k: getattr(precond, k) for k in mf.KERNELS}
    for k in mf.KERNELS:
        setattr(precond, k, getattr(mf, f"{k}_plain"))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(precond, k, fn)


def profile_leapfrog(model, device, num_leapfrogs=100, reps=5):
    """Where a leapfrog's time goes, at the main path's float32 shapes: the
    wall per leapfrog with the kernels and with their plain versions
    (alternating), one K1 evaluation alone, the host time of each wrapper
    call, and torch.profiler's device time over one 50-leapfrog
    transition."""
    from torch.profiler import ProfilerActivity, profile

    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.sampler.hmc import hmc_step
    from magi_v2_tpu_torch.sampler.mass import identity_mass

    mode, _, _ = model._build_sampling_setup("precond", "dense",
                                             torch.float32)
    target = mode.logp_grad
    N, D = model.mag_I, model.D
    dim = N * D + D + model.D_thetas
    g = torch.Generator(device=device).manual_seed(0)
    q0 = torch.cat([mode.X0.reshape(-1).float(),
                    torch.tensor([-10.5] * D + [1.8, -0.5, 0.6],
                                 device=device)])
    qs = q0 + 0.01 * torch.randn((NUM_CHAINS, dim), generator=g,
                                 device=device)
    normals = torch.randn((NUM_CHAINS, dim), generator=g, device=device)
    unif = torch.rand((NUM_CHAINS,), generator=g, device=device)
    inv_mass = identity_mass(dim, dim, torch.float32, device)
    eps = torch.tensor(0.2, device=device)
    bt = torch.tensor(0.15, device=device)

    def transition(L):
        return hmc_step(lambda q: target(q, bt), qs, eps, inv_mass, L,
                        normals, unif)

    def ms_per_leapfrog():
        transition(num_leapfrogs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            transition(num_leapfrogs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (reps * num_leapfrogs) * 1e3

    walls = {"kernels": [], "plain": []}
    for order in [("kernels", "plain"), ("plain", "kernels")] * 2:
        for name in order:
            if name == "plain":
                with plain_k1():
                    walls[name].append(ms_per_leapfrog())
            else:
                walls[name].append(ms_per_leapfrog())
    print(f"ms per leapfrog ({NUM_CHAINS} chains, float32), with the kernels "
          f"{walls['kernels']}, with the plain versions {walls['plain']}")
    print(f"ms per K1 evaluation alone: {_time_ms(lambda: target(qs, bt))}")

    # host time of each wrapper (the kernels are a few us on the card, so
    # back-to-back calls are bound by the host)
    x = kernel_inputs(torch.float32, device, C=NUM_CHAINS, N=N, D=D)
    I = torch.zeros((N, 1), dtype=torch.float32, device=device)
    gc, gr = torch.zeros_like(x["RmD"]), torch.zeros_like(x["q"])
    t14 = torch.zeros((NUM_CHAINS, 2), dtype=torch.float32, device=device)
    calls = {
        "manifold_fwd": lambda: mf.manifold_fwd(
            model.f_vec, I, x["delta"], x["RmD"], x["q"], x["x0T"], x["a0"],
            x["f0"], x["mask"], x["y"], x["sigma_lb"], x["beta_temp"],
            x["beta"]),
        "manifold_energy": lambda: mf.manifold_energy(
            model.f_vec, x["Ds"], x["s0"], t14,
            x["q"], x["sigma_lb"], x["n_ds"], x["beta_temp"], x["beta"]),
        "manifold_bwd": lambda: mf.manifold_bwd(
            model.f_vec, I, x["gdr"], x["delta"], x["q"], x["x0T"],
            x["mask"], x["y"], x["sigma_lb"], x["n_ds"], x["beta_temp"],
            gc, gr),
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        host_us = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
        print(f"{name} wrapper: {host_us:.2f} us of host time per call")

    transition(50)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transition(50)
        torch.cuda.synchronize()
        profiled_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    transition(50)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    gemm = sum(e.self_device_time_total for e in kernels
               if "gemm" in e.key.lower())
    print("device time over one 50-leapfrog transition, by kernel:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total:10.1f} us {e.count:5d} calls  "
              f"{e.key[:90]}")
    for name in mf.KERNELS:
        own = [e for e in kernels if f"{name}_kernel" in e.key]
        n = sum(e.count for e in own)
        us = sum(e.self_device_time_total for e in own)
        print(f"{name}: {us / max(n, 1):.2f} us of device time per launch "
              f"({n} launches)")
    if busy == 0:
        print("torch.profiler recorded no device time; the split above is "
              "not measured")
        return
    print(f"device busy {busy:.1f} us ({gemm / busy:.1%} in GEMMs) of "
          f"{profiled_us:.1f} us profiled wall and {wall_us:.1f} us "
          f"unprofiled wall; device idle {1 - busy / wall_us:.1%} of the "
          "unprofiled wall")


def main():
    smi = check_device()
    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    build()
    print(f"build phase: {time.perf_counter() - t0:.1f} s")
    timing = check_kernels(device)
    model, counts = main_path(device)
    check_composed(model, device)
    profile_leapfrog(model, device)
    kernels = [
        dict(name=k, route="cuda",
             source="magi_v2_tpu_torch/csrc/manifold_seir.cu",
             replaces=REPLACES[k], launches=counts[k], **timing[k])
        for k in ("manifold_fwd", "manifold_energy", "manifold_bwd")
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""One run of one cell: the configuration's observations, the fit, a warm
predict, the measured window of whole predict calls, the check of
``correct``, and the result line.

Usage (from ``port_bench/run.py``, which first requires the cards)::

    record = run_cell("seir-hmc", seed=7, seconds=30, trace=False)
"""

from __future__ import annotations

import sys
import time
import warnings

import numpy as np
import torch

from port_bench.harness import judge as judging
from port_bench.harness import manifest, tracing
from port_bench.yardstick.diagnostics import effective_sample_size
from port_bench.yardstick.simulate import simulate_ode

# the top-level modules that may not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "magi_v2_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def call_seed(seed: int, index: int) -> int:
    """The seed of the window's call ``index``: a 31-bit number made from
    the run's seed and the index."""
    return int(np.random.SeedSequence([seed % 2**63, index])
               .generate_state(1)[0] % 2**31)


class Call:
    """One predict call of the window: its phase walls, its sampler
    statistics, the port's counters' change over its sampling phase and
    what the check keeps of its draws."""

    def __init__(self, predict_timings, results, sampling_counts, kept):
        self.predict_timings = dict(predict_timings)
        self.sampling_counts = sampling_counts
        self.timings = results["timings"]
        self.num_leapfrogs = np.asarray(
            results["kernel_results"]["num_leapfrogs"])       # (T, C)
        thetas = np.asarray(results["thetas_samps"], np.float64)
        if thetas.ndim == 2:
            thetas = thetas[:, None]
        self.ess_min = min(effective_sample_size(thetas[:, :, j])
                           for j in range(thetas.shape[-1]))
        self.kept = kept


class Run:
    """What a run measured, for the metrics' readers (``metrics/*.py``)."""

    def __init__(self, cell, trace: bool):
        self.cell = cell
        self.trace = trace
        self.config, self.traffic = cell.config, cell.traffic
        self.recipe = cell.recipe()
        self.setup_s = None
        self.fit_timings = []
        self.fit_traces = []          # each fit's trace, in order
        self.calls: list[Call] = []
        self.window_s = None
        self.profile = None           # tracing.read_slice of the slice
        self.profile_call = None      # its call's index in ``calls``
        self.shapes = {}

    def timed_calls(self):
        """The calls whose walls the per-layer timings read: all but the
        profiled one, unless it is the only one."""
        rest = [c for i, c in enumerate(self.calls)
                if i != self.profile_call]
        return rest or self.calls


def observations(cfg: dict):
    """The configuration's observations: its field integrated by RK4 from
    its start, with its noise drawn from its own ``data_seed``."""
    f = manifest.field(cfg["field"])
    ts, X_obs, _ = simulate_ode(
        f, x0=np.array(cfg["x0"]), thetas=np.array(cfg["thetas"]),
        t_max=float(cfg["t_max"]), n_obs=int(cfg["n_obs"]),
        noise_sd=cfg["noise_sd"], seed=int(cfg["data_seed"]),
        substeps=int(cfg["substeps"]))
    return ts, X_obs


def fit(cfg: dict, ts, X_obs, device: str, timings: list,
        traces: list | None = None):
    """The configuration's fits in order, each starting theta from the
    previous fit where it says so; returns the last model. Each fit's
    phase walls go to ``timings`` and its trace (``fit_trace``) to
    ``traces``, where given."""
    from magi_v2_tpu_torch import MAGI_v2, MagiConfig
    from magi_v2_tpu_torch import models

    f_vec = getattr(models, cfg["port_field"])
    mc = MagiConfig(dtype=DTYPES[cfg["dtype"]], device=device,
                    **cfg.get("magi_config", {}))
    model, thetas_init = None, None
    for step in cfg["fits"]:
        model = MAGI_v2(D_thetas=int(cfg["D_thetas"]), ts_obs=ts,
                        X_obs=X_obs, bandsize=cfg.get("bandsize"),
                        f_vec=f_vec,
                        config=mc.replace(**step.get("magi_config", {})))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model.initial_fit(
                int(step["discretization"]),
                thetas_init=(thetas_init if step.get("thetas_from_previous")
                             else None))
        timings.append(dict(model.fit_timings))
        if traces is not None:
            traces.append(model.fit_trace)
        thetas_init = model.thetas_init
    return model


def fit_outputs(cfg: dict, ts, X_obs, model) -> dict:
    """The observations and the fit's outputs the reference starts from."""
    return {"ts_obs": ts, "X_obs": X_obs,
            "discretization": int(cfg["fits"][-1]["discretization"]),
            "bandsize": cfg.get("bandsize"),
            "phi1s": np.array(model.phi1s), "phi2s": np.array(model.phi2s),
            "sigma_sqs_init": np.array(model.sigma_sqs_init),
            "thetas_init": np.array(model.thetas_init),
            "Xhat_init": np.array(model.Xhat_init)}


def sync(device: str):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             bench: dict | None = None, base=manifest.BENCH):
    """One run of cell ``name``; returns (Run, numbers, limits). The
    window starts after the warm predict and closes at the first call's
    return past ``seconds``. ``judge.Capture`` copies two of its
    transitions for the check; with ``trace`` a ``tracing.Tap`` counts and
    profiles beside it."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.Cell(name, bench, base)
    run = Run(cell, trace)
    cfg, recipe = cell.config, run.recipe
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ts, X_obs = observations(cfg)
    model = fit(cfg, ts, X_obs, device, run.fit_timings, run.fit_traces)
    fit_out = fit_outputs(cfg, ts, X_obs, model)
    N, D, P = model.mag_I, model.D, model.D_thetas
    run.shapes = dict(C=int(recipe["num_chains"]), N=N, D=D, P=P,
                      dim=N * D + D + P, storage=recipe.get("storage",
                                                            "dense"),
                      algorithm=recipe.get("algorithm", "nuts"),
                      bandsize=cfg.get("bandsize"),
                      dtype=DTYPES[cfg["dtype"]])
    run.shapes["k"] = model._dense_tail_size(
        recipe.get("mass_matrix", "diag"), recipe.get("sigma_sqs_fixed"))

    warm = dict(recipe, **cell.traffic["warm"])
    model.predict(seed=call_seed(seed, 10**6), **warm)
    sync(device)
    t_window = time.perf_counter()
    run.setup_s = t_window - t_start

    burnin = int(recipe["num_burnin_steps"])
    tap = (tracing.Tap(burnin, profile_call=0,
                       **cell.traffic.get("trace_slice", {}))
           if trace else None)
    capture = judging.Capture(
        judging.picks(seed, burnin, int(recipe["num_results"])),
        observers=[tap] if tap else [])
    failed = 0
    with capture.installed():
        i = 0
        while True:
            try:
                with capture.call_of(i):
                    res = model.predict(seed=call_seed(seed, i),
                                        profile_timings=trace, **recipe)
                sync(device)
                ok = all(np.all(np.isfinite(res[key]))
                         for key in ("X_samps", "thetas_samps"))
            except Exception as exc:  # a call that raises is a failed call
                print(f"call {i} raised {type(exc).__name__}: {exc}",
                      file=sys.stderr)
                res, ok = None, False
            if ok:
                kept = judging.keep(res, N, D, capture.factors.get(i))
                run.calls.append(Call(
                    model.predict_timings, res,
                    tap.sampling_counts[-1] if tap else {}, kept))
            else:
                failed += 1
            del res
            i += 1
            if time.perf_counter() - t_window >= seconds:
                break
    run.window_s = time.perf_counter() - t_window
    run.attempted, run.failed = i, failed
    tiles = next((f for f in capture.factors.values() if f is not None),
                 None)
    if tiles is not None:
        run.shapes["factor_bw"] = judging.factor_bandwidth(tiles, N * D)
    if tap and tap.slice is not None and tap.slice.last is not None:
        run.profile = tracing.read_slice(tap.slice)
        run.profile_call = 0
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                             if torch.device(device).type == "cuda" else 0)

    del model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judging.judge(cell, fit_out, [c.kept for c in run.calls],
                            capture.taken, device)
    run.check_s = time.perf_counter() - t_check
    return run, numbers, cell.limits

"""The port's sampler checkpoint/resume (``SamplerConfig.checkpoint_path``,
``predict(checkpoint_path=, dispatch_block_steps=)``), phase timings and
the files both packages read and write: ``save_fit``/``save_results``/
``load_results``, ``load_seir_csv``, ``sampler_report``.

Mirrors tests/test_checkpoint_resume.py on the port's ``run_chains``: a
run cut at a block boundary, mid-warmup or mid-sampling, resumes bit for
bit, for NUTS, HMC and a two-rung parallel-tempering run; a finished run
loads from disk; a checkpoint of another run is refused."""

import csv
import os

import numpy as np
import pytest
import torch

import magi_v2_tpu as J
import magi_v2_tpu_torch as T
import magi_v2_tpu_torch.sampler.run as run_mod
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.utils import checkpoint as jck
from magi_v2_tpu.utils import data as jdata
from magi_v2_tpu.utils import profiling as jprof
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.sampler.run import SamplerConfig, run_chains
from magi_v2_tpu_torch.utils import checkpoint as tck
from magi_v2_tpu_torch.utils import data as tdata
from magi_v2_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

DIM, CHAINS = 3, 4
# the I/O knobs, which change no draw and are not fingerprinted
IO_FIELDS = ("progress_every", "checkpoint_path", "profile_timings",
             "stage_above_bytes")
KINDS = {
    "nuts": {},
    "hmc": {"algorithm": "hmc", "hmc_num_leapfrogs": 8,
            "dense_tail_size": 2},
    "pt": {"pt_betas": (1.0, 0.5), "pt_swap_every": 2, "thin": 2},
}


def _gaussian(q, beta_temp):
    """A standard normal at beta_temp (0-dim, or one per chain)."""
    b = beta_temp.reshape(-1, 1) if beta_temp.dim() else beta_temp
    return -0.5 * beta_temp * (q * q).sum(-1), -b * q


def _cfg(ckpt="", kind="nuts", **kw):
    base = dict(num_results=40, num_burnin_steps=30, use_annealing=False,
                max_tree_depth=5, dispatch_block_steps=10,
                checkpoint_path=ckpt, **KINDS[kind])
    base.update(kw)
    return SamplerConfig(**base)


def _run(cfg, seed=7, q0=None):
    if q0 is None:
        q0 = torch.ones((CHAINS, DIM), dtype=torch.float64)
    return run_chains(_gaussian, q0, seed, cfg)


def _assert_same_run(a, b):
    (sa, ta), (sb, tb) = a, b
    assert torch.equal(sa, sb)
    for f in ("step_size", "inv_mass", "accept_probs", "divergences"):
        assert torch.equal(getattr(ta, f), getattr(tb, f)), f
    for f in ("num_leapfrogs", "depths"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
    for f in ("tail_inv_mass", "pt_swap_accept"):
        x, y = getattr(ta, f), getattr(tb, f)
        assert (x is None and y is None) or torch.equal(x, y), f


@pytest.fixture(scope="module")
def references():
    return {kind: _run(_cfg(kind=kind)) for kind in KINDS}


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpointing_changes_nothing(tmp_path, references, kind):
    ck = str(tmp_path / "ck")
    _assert_same_run(references[kind], _run(_cfg(ck, kind)))
    files = sorted(os.listdir(ck))
    assert "state.npz" in files
    # one draws file per block of 10 transitions (a thinned draw costs 2)
    per_block = 10 // _cfg(kind=kind).thin
    assert sum(f.startswith("draws_") for f in files) == 40 // per_block
    # the block size changes no draw either
    _assert_same_run(references[kind],
                     _run(_cfg(kind=kind, dispatch_block_steps=0)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_finished_run_loads_from_disk(tmp_path, monkeypatch, references,
                                      kind):
    ck = str(tmp_path / "ck")
    _run(_cfg(ck, kind))

    def boom(*a, **k):
        raise AssertionError("a transition ran on a finished checkpoint")

    monkeypatch.setattr(run_mod, "_ckpt_save_draws", boom)
    monkeypatch.setattr(run_mod, "find_reasonable_step_size", boom)
    monkeypatch.setattr(run_mod, "BoundNuts", boom)
    monkeypatch.setattr(run_mod, "BoundTransition", boom)
    _assert_same_run(references[kind], _run(_cfg(ck, kind)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_crash_mid_sampling_resumes_bit_for_bit(tmp_path, monkeypatch,
                                                references, kind):
    ck = str(tmp_path / "ck")
    real_save = run_mod._ckpt_save_draws
    calls = {"n": 0}

    def crash_after_two(dirpath, start, s_blk, info):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("simulated crash")
        real_save(dirpath, start, s_blk, info)

    monkeypatch.setattr(run_mod, "_ckpt_save_draws", crash_after_two)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _run(_cfg(ck, kind))
    monkeypatch.setattr(run_mod, "_ckpt_save_draws", real_save)
    _assert_same_run(references[kind], _run(_cfg(ck, kind)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_crash_mid_warmup_resumes_bit_for_bit(tmp_path, monkeypatch,
                                              references, kind):
    ck = str(tmp_path / "ck")
    real_save = run_mod._ckpt_save_state

    def crash_second_warmup_block(dirpath, phase, nxt, carry, fp):
        real_save(dirpath, phase, nxt, carry, fp)
        if phase == "warmup" and nxt >= 20:
            raise RuntimeError("simulated mid-warmup crash")

    monkeypatch.setattr(run_mod, "_ckpt_save_state",
                        crash_second_warmup_block)
    with pytest.raises(RuntimeError, match="mid-warmup"):
        _run(_cfg(ck, kind))
    monkeypatch.setattr(run_mod, "_ckpt_save_state", real_save)
    _assert_same_run(references[kind], _run(_cfg(ck, kind)))


def _tensors(*names):
    """Each tensor of a carry is saved with its strides."""
    return {*names, *(f"_stride_{n}" for n in names)}


HEADER = {"_fingerprint", "_next", "_phase", "host_rng"}
WARMUP_KEYS = HEADER | {"da_count", "wf_count", "reseats"} | _tensors(
    "qs", "da_log_step", "da_log_step_avg", "da_h_bar", "da_mu", "wf_mean",
    "wf_m2", "mass_diag", "gen", "reseat_accept_sum")
SAMPLE_KEYS = HEADER | _tensors("qs", "eps", "mass_diag", "gen")
TAIL_MASS = _tensors("mass_tail_inv", "mass_tail_msqrt")
DRAW_KEYS = {"samples", "info_accept", "info_diverging",
             "info_num_leapfrogs"}
# kind -> (warmup's keys, sampling's keys, a draws file's keys)
FILE_KEYS = {
    "nuts": (WARMUP_KEYS, SAMPLE_KEYS, DRAW_KEYS | {"info_depths"}),
    "hmc": (WARMUP_KEYS | TAIL_MASS | {"wf_tail_count"}
            | _tensors("wf_tail_mean", "wf_tail_m2"),
            SAMPLE_KEYS | TAIL_MASS, DRAW_KEYS),
    "pt": (WARMUP_KEYS, SAMPLE_KEYS | _tensors("swap_prop", "swap_accs"),
           DRAW_KEYS | {"info_depths"}),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoint_files_keep_their_keys(tmp_path, monkeypatch, kind):
    """The on-disk format: the arrays of state.npz at a warmup boundary and
    at a sampling one, and of a draws file, by name (a checkpoint written
    by an earlier version resumes only if they stay)."""
    ck = str(tmp_path / "ck")
    real_save = run_mod._ckpt_save_state

    def crash(dirpath, phase, nxt, carry, fp):
        real_save(dirpath, phase, nxt, carry, fp)
        if phase == "warmup" and nxt >= 20:
            raise RuntimeError("simulated mid-warmup crash")

    def keys(name):
        with np.load(os.path.join(ck, name)) as z:
            return set(z.files), str(z["_phase"]) if "_phase" in z else None

    monkeypatch.setattr(run_mod, "_ckpt_save_state", crash)
    with pytest.raises(RuntimeError, match="mid-warmup"):
        _run(_cfg(ck, kind))
    warmup, sample, draws = FILE_KEYS[kind]
    assert keys("state.npz") == (warmup, "warmup")
    monkeypatch.setattr(run_mod, "_ckpt_save_state", real_save)
    _run(_cfg(ck, kind))
    assert keys("state.npz") == (sample, "sample")
    assert keys("draws_000000.npz") == (draws, None)


def _trap(q, beta_temp):
    """A standard normal below 10 and, from 10 on, a well of curvature 1e6
    around 20, which a chain started at its floor cannot leave: warmup's
    re-seat rule moves it (tests/test_torch_reseat.py)."""
    b = beta_temp.reshape(-1, 1) if beta_temp.dim() else beta_temp
    inside = q >= 10.0
    f = torch.where(inside, -0.5e6 * (q - 20.0) ** 2 - 100.0, -0.5 * q * q)
    return beta_temp * f.sum(-1), b * torch.where(inside, -1e6 * (q - 20.0),
                                                 -q)


@pytest.mark.parametrize("kind", ["nuts", "hmc"])
@pytest.mark.parametrize("crash_at", [20, 30, 50])
def test_resume_across_a_reseat_boundary_is_bit_for_bit(
        tmp_path, monkeypatch, kind, crash_at):
    """Warmup's re-seat boundaries fall inside the blocks [20, 30) (step
    27, where the trapped chains move) and [40, 50) (step 48), and their
    stretches ([24, 27), [45, 48)) too: a run cut before, after and past
    them resumes with the same draws and the same re-seats as the run
    never cut."""
    q0 = 0.3 * torch.randn((8, DIM), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(1))
    q0[[2, 5], 0] = 20.0

    def traced(cfg):
        timer = tprof.PhaseTimer("cpu", trace=True)
        out = run_chains(_trap, q0, 7, cfg._replace(profile_timings=True),
                         timer=timer)
        (warmup,) = [s for s in timer.spans if s.name == "warmup"]
        return out, warmup.attrs["reseats"]

    cfg = _cfg(kind=kind, num_burnin_steps=60)
    ref, reseats = traced(cfg)
    assert reseats == [[27, 2], [48, 0]]
    ck = str(tmp_path / "ck")
    real_save = run_mod._ckpt_save_state

    def crash(dirpath, phase, nxt, carry, fp):
        real_save(dirpath, phase, nxt, carry, fp)
        if phase == "warmup" and nxt >= crash_at:
            raise RuntimeError("simulated mid-warmup crash")

    monkeypatch.setattr(run_mod, "_ckpt_save_state", crash)
    with pytest.raises(RuntimeError, match="mid-warmup"):
        traced(cfg._replace(checkpoint_path=ck))
    monkeypatch.setattr(run_mod, "_ckpt_save_state", real_save)
    out, reseats_resumed = traced(cfg._replace(checkpoint_path=ck))
    _assert_same_run(ref, out)
    assert reseats_resumed == reseats


def test_missing_draws_file_refuses(tmp_path):
    ck = str(tmp_path / "ck")
    _run(_cfg(ck))
    os.remove(os.path.join(ck, "draws_000010.npz"))
    with pytest.raises(FileNotFoundError, match="draws_000010"):
        _run(_cfg(ck))


# the fingerprint cases' base: a second mass window that begins at 0.72
# of warmup but is off (its end is 0), so that each window field changed
# alone makes a valid config
FP_BASE = {"mass_window2_begin": 0.72}


@pytest.fixture(scope="module")
def finished_ckpt(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("fp") / "ck")
    _run(_cfg(ck, **FP_BASE))
    return ck


# a changed value of every field but the I/O knobs
CHANGED = {
    "num_results": 50, "num_burnin_steps": 20, "initial_step_size": 0.2,
    "target_accept": 0.9, "adaptation_fraction": 0.5, "max_tree_depth": 4,
    "max_energy_diff": 500.0, "anneal_min_temp": 0.2, "use_annealing": True,
    "anneal_mode": "warmup_only", "adapt_mass_matrix": False,
    "mass_window_begin": 0.4, "mass_window_end": 0.75,
    "mass_window2_begin": 0.6, "mass_window2_end": 0.78,
    "mass_window1_diag": True, "dense_tail_size": 2, "dense_shrinkage": 0.2,
    "thin": 2, "algorithm": "hmc", "hmc_num_leapfrogs": 16,
    "hmc_jitter": False,
    "pt_betas": (1.0, 0.5), "pt_swap_every": 2, "dispatch_block_steps": 5,
    "reseat_accept_below": 0.2,
}


def test_every_field_is_in_the_fingerprint_cases():
    assert set(CHANGED) | set(IO_FIELDS) == set(SamplerConfig._fields)


@pytest.mark.parametrize("field", sorted(CHANGED))
def test_every_config_field_fingerprinted(finished_ckpt, field):
    with pytest.raises(ValueError, match="different .*run"):
        _run(_cfg(finished_ckpt, **{**FP_BASE, field: CHANGED[field]}))


def test_seed_and_initial_state_fingerprinted(finished_ckpt):
    with pytest.raises(ValueError, match="different .*run"):
        _run(_cfg(finished_ckpt, **FP_BASE), seed=8)
    with pytest.raises(ValueError, match="different .*run"):
        _run(_cfg(finished_ckpt, **FP_BASE),
             q0=torch.full((CHAINS, DIM), 1.5, dtype=torch.float64))


def test_io_knobs_not_fingerprinted(finished_ckpt, monkeypatch,
                                    references):
    def boom(*a, **k):
        raise AssertionError("re-ran on a complete checkpoint")

    monkeypatch.setattr(run_mod, "_ckpt_save_draws", boom)
    out = _run(_cfg(finished_ckpt, progress_every=1000,
                    profile_timings=True, **FP_BASE))
    _assert_same_run(_run(_cfg(**FP_BASE)), out)
    # a run loaded whole from disk times no warmup and no block
    t = out[1].timings
    assert "warmup_s" not in t and "block_walls_s" not in t
    assert t["staged_bytes"] == 0 and t["sample_first_dispatch_s"] is None


# --- predict on a fitted model --------------------------------------------

@pytest.fixture(scope="module")
def models():
    """A JAX SEIR fit and the port model carried across from it."""
    ts, X, _ = jdata.simulate_ode(
        jseir, x0=np.array([0.1, 0.05, 0.0]), thetas=np.array([6.0, 0.6, 1.8]),
        t_max=2.0, n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, None, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    arrays = {f: np.array(getattr(jm, f)) for f in tck.FIT_FIELDS}
    # NUTS's trees cut at depth 4 to keep the CPU predicts short
    tm = tck.from_fit_arrays(arrays, tseir, 3, config=T.MagiConfig(
        device="cpu", max_tree_depth=4))
    return jm, tm


def _predict(tm, **kw):
    kw = dict(num_results=12, num_burnin_steps=12, num_chains=3, seed=4,
              dispatch_block_steps=5, **kw)
    return tm.predict(**kw)


@pytest.mark.parametrize("algorithm", ["nuts", "hmc"])
def test_predict_resumes_bit_for_bit(models, tmp_path, monkeypatch,
                                     algorithm):
    """predict(checkpoint_path=...) through the bound transitions of a
    fitted model's target, crashed mid-sampling."""
    _, tm = models
    extra = dict(algorithm=algorithm, hmc_num_leapfrogs=8)
    ref = _predict(tm, **extra)
    assert ref["timings"] is None
    ck = str(tmp_path / "ck")
    real_save = run_mod._ckpt_save_draws

    def crash(dirpath, start, s_blk, info):
        if start >= 5:
            raise RuntimeError("simulated crash")
        real_save(dirpath, start, s_blk, info)

    monkeypatch.setattr(run_mod, "_ckpt_save_draws", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _predict(tm, checkpoint_path=ck, **extra)
    monkeypatch.setattr(run_mod, "_ckpt_save_draws", real_save)
    out = _predict(tm, checkpoint_path=ck, **extra)
    for k in ("X_samps", "thetas_samps", "sigma_sqs_samps",
              "sample_results"):
        np.testing.assert_array_equal(out[k], ref[k])
    for k, v in ref["kernel_results"].items():
        np.testing.assert_array_equal(out["kernel_results"][k], v)


def test_profile_timings_keys_match_jax(models):
    """results["timings"] of a profiled predict holds JAX's keys."""
    jm, tm = models
    kw = dict(num_results=6, num_burnin_steps=6, num_chains=2, seed=1,
              algorithm="hmc", hmc_num_leapfrogs=4, dispatch_block_steps=3,
              profile_timings=True)
    tt = tm.predict(**kw)["timings"]
    jt = jm.predict(**kw)["timings"]
    # every JAX key, and the port's trace beside them
    assert set(jt) <= set(tt) and set(tt) - set(jt) == {"trace"}
    assert len(tt["block_walls_s"]) == len(jt["block_walls_s"]) == 2
    assert len(tt["warmup_block_walls_s"]) == 2
    assert all(tt[k] >= 0 for k in jt if not k.endswith("walls_s"))


def test_sampler_report_matches_jax(models):
    _, tm = models
    res = tm.predict(num_results=20, num_burnin_steps=10, num_chains=2,
                     seed=2, algorithm="hmc", hmc_num_leapfrogs=4)
    rt = tprof.sampler_report(res, wall_seconds=2.0)
    rj = jprof.sampler_report(res, wall_seconds=2.0)
    assert rt.keys() == rj.keys()
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-12, err_msg=k)


def test_phase_timer_interfaces():
    timer = tprof.PhaseTimer()
    with timer.phase("a"):
        pass
    with timer("a"):
        pass
    with timer("b"):
        pass
    rep = timer.report()
    assert set(rep) == {"a", "b", "total_s"}
    assert "PhaseTimer(" in repr(timer)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert os.path.exists(tmp_path / "tr" / "trace.json")
    assert len(prof.key_averages()) > 0


# --- files both packages read ---------------------------------------------

def test_fit_files_cross_packages(models, tmp_path):
    jm, tm = models
    pt_path, pj_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_fit(tm, pt_path)
    jck.save_fit(jm, pj_path)
    for path in (pt_path, pj_path):
        j2 = jck.load_fit(path, jseir, config=jm.config)
        t2 = tck.load_fit(path, tseir, config=tm.config)
        for f in tck.FIT_FIELDS:
            np.testing.assert_array_equal(getattr(j2, f), getattr(jm, f),
                                          err_msg=f)
            np.testing.assert_array_equal(getattr(t2, f), getattr(tm, f),
                                          err_msg=f)
        assert t2.BANDSIZE is None and j2.BANDSIZE is None
        assert t2.mag_I == j2.mag_I and t2.beta == j2.beta
    with np.load(pt_path) as zt, np.load(pj_path) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        np.testing.assert_array_equal(zt["_meta"], zj["_meta"])


@pytest.mark.parametrize("mass_matrix", ["diag", "dense"])
def test_results_files_cross_packages(models, tmp_path, mass_matrix):
    _, tm = models
    res = tm.predict(num_results=4, num_burnin_steps=4, num_chains=2,
                     algorithm="hmc", hmc_num_leapfrogs=4,
                     mass_matrix=mass_matrix, profile_timings=True)
    path = str(tmp_path / "r.npz")
    tck.save_results(res, path)
    for loaded in (tck.load_results(path), jck.load_results(path)):
        np.testing.assert_array_equal(loaded["X_samps"], res["X_samps"])
        kr = loaded["kernel_results"]
        for k, v in res["kernel_results"].items():
            if v is None:
                assert k not in kr
            else:
                np.testing.assert_array_equal(kr[k], v)
    # the trace describes the run, not its result: it is not saved
    assert tck.load_results(path)["timings"].keys() == (
        res["timings"].keys() - {"trace"})
    jres = {k: v for k, v in res.items() if k != "timings"}
    jck.save_results(jres, path)
    back = tck.load_results(path)
    np.testing.assert_array_equal(back["thetas_samps"], res["thetas_samps"])
    assert back["kernel_results"].keys() == jck.load_results(
        path)["kernel_results"].keys()


def test_load_seir_csv_matches_jax(tmp_path):
    """A CSV in the reference's columns (t, {S,E,I,R}_obs, {S,E,I,R}_true),
    simulated on [0, 10], thinned by both packages."""
    ts, X_obs, X_true = tdata.simulate_ode(
        tseir, x0=np.array([0.1, 0.05, 0.0]), thetas=np.array([6.0, 0.6, 1.8]),
        t_max=10.0, n_obs=1001, noise_sd=0.01, substeps=2)
    path = tmp_path / "SEIR_seed=0.csv"
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["t", "S_obs", "E_obs", "I_obs", "R_obs",
                    "S_true", "E_true", "I_true", "R_true"])
        for t, xo, xt in zip(ts, X_obs, X_true):
            w.writerow([t, 1 - xo.sum(), *xo, 1 - xt.sum(), *xt])
    for kw in ({}, {"d_obs": 10, "t_max": 3.0,
                    "comp_obs": (True, False, True)}):
        tt, Xt, rt = tdata.load_seir_csv(str(path), **kw)
        tj, Xj, rj = jdata.load_seir_csv(str(path), **kw)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(Xt, Xj)
        for k in rj:
            np.testing.assert_array_equal(rt[k], rj[k])
    assert Xt.shape == (31, 3) and np.all(np.isnan(Xt[:, 1]))
    assert np.all(Xt[:, [0, 2]] >= 0.0)


def test_load_seir_csv_needs_a_path():
    with pytest.raises(ValueError, match="path"):
        tdata.load_seir_csv()

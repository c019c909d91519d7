"""The port's parallel tempering (``pt_betas``: magi_v2_tpu_torch/sampler/
pt.py, the swap kernel's plain version in ops/pt.py, the per-chain
temperature of the targets and bound transitions) against the JAX
package's (magi_v2_tpu/sampler/run.py's PT block), float64 on the CPU,
where every kernel wrapper takes its plain version: the ladder's checks
and messages, one swap round against a NumPy transcription of JAX's
``pt_swap``, the targets at a temperature per chain against JAX's at each
chain's temperature (every reparam x storage the port samples, and the
Hes1 centered target with sigma pinned), the value-only evaluation, one
NUTS transition at per-chain temperatures and steps under the noise JAX
draws, the bound transitions against the eager ones, the bimodal harness
of tests/test_pt.py, the swap cadence, and PT predicts.

The port's targets evaluate relative to a reference point, JAX's
absolutely: at temperature beta the two differ by beta times a constant,
so lp / beta is compared through its differences between states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import magi_v2_tpu as J
from magi_v2_tpu.models import MODEL_REGISTRY
from magi_v2_tpu.models import hes1_log_f_vec as jhes1
from magi_v2_tpu.sampler import SamplerConfig as JSamplerConfig
from magi_v2_tpu.sampler import run_nuts_chains
from magi_v2_tpu.sampler.nuts import NutsConfig as JNutsConfig
from magi_v2_tpu.sampler.nuts import nuts_step as jnuts_step
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import hes1_log_f_vec as thes1
from magi_v2_tpu_torch.ops.pt import pt_swap_plain
from magi_v2_tpu_torch.sampler import hmc as thmc
from magi_v2_tpu_torch.sampler import nuts as tnuts
from magi_v2_tpu_torch.sampler import pt as tpt
from magi_v2_tpu_torch.sampler import run as trun
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays
from test_torch_nuts import _assert_matches_jax, _masses, jax_noise
from test_torch_whitened import MODES, _modes, _rel, _states, fitted  # noqa: F401

torch.set_num_threads(2)

F64 = torch.float64
MODE = chip_smoke.BIMODAL_MODE
LADDER = chip_smoke.BIMODAL_LADDER
# the Hes1 recipe's ladder (scripts/hes1_pt.py)
HES1_LADDER = (1.0, 0.6, 0.36, 0.22, 0.13)
SIGMA_FIXED = 0.15 ** 2


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _per_chain(ladder, M):
    """(beta (C,), eps scale (C,)) of rung-major chains, float64 NumPy."""
    b = np.repeat(np.asarray(ladder, np.float64), M)
    return b, b ** -0.5


def _cfg(**kw):
    base = dict(num_results=1500, num_burnin_steps=600, use_annealing=False,
                algorithm="hmc", hmc_num_leapfrogs=24,
                adapt_mass_matrix=False)
    base.update(kw)
    return trun.SamplerConfig(**base)


def _run(cfg, C, seed=0, weight_right=0.5):
    q0 = torch.zeros((C, 2), dtype=F64)
    q0[:, 0] = -MODE                       # every chain in the LEFT mode
    return trun.run_chains(chip_smoke.bimodal_target(weight_right), q0, seed,
                           cfg)


# --------------------------------------------------------------------------
# the ladder
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw,C", [
    (dict(pt_betas=(0.9, 0.5)), 8),
    (dict(pt_betas=(1.0, 1.0)), 8),
    (dict(pt_betas=(1.0, 0.5, 0.7)), 8),
    (dict(pt_betas=(1.0, 0.0)), 8),
    (dict(pt_betas=(1.0, 0.5, 0.25)), 8),
    (dict(pt_betas=(1.0, 0.5), use_annealing=True,
          anneal_mode="reference"), 8),
    (dict(pt_betas=(1.0, 0.5), pt_swap_every=0), 8),
])
def test_ladder_errors_match_jax(kw, C):
    """The port refuses what JAX refuses, with JAX's message."""
    kw = dict(kw, num_results=10, num_burnin_steps=10)
    jcfg = JSamplerConfig(**dict(kw, use_annealing=kw.get("use_annealing",
                                                            False),
                                 algorithm="hmc", hmc_num_leapfrogs=4))
    q0 = jnp.zeros((C, 2))
    with pytest.raises(ValueError) as jerr:
        run_nuts_chains(lambda q, b: (b * jnp.sum(q), b * q), q0,
                        jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError) as terr:
        _run(_cfg(**kw), C)
    assert str(terr.value) == str(jerr.value)


def test_single_rung_is_a_no_op_ladder():
    """One rung disables tempering: the plain path's draws, bit for bit."""
    plain, _ = _run(_cfg(num_results=50, num_burnin_steps=50), C=4)
    one, stats = _run(_cfg(num_results=50, num_burnin_steps=50,
                           pt_betas=(1.0,)), C=4)
    assert torch.equal(plain, one) and stats.pt_swap_accept is None


def test_numpy_ladder_is_accepted():
    """A NumPy ladder is read as the tuple of its floats."""
    kw = dict(num_results=20, num_burnin_steps=20)
    as_tuple, st = _run(_cfg(pt_betas=(1.0, 0.5), **kw), C=4)
    as_array, sa = _run(_cfg(pt_betas=np.array([1.0, 0.5]), **kw), C=4)
    assert torch.equal(as_tuple, as_array)
    assert torch.equal(st.pt_swap_accept, sa.pt_swap_accept)


# --------------------------------------------------------------------------
# one swap round
# --------------------------------------------------------------------------


def jax_pt_swap(q, lp, betas, u, parity):
    """run.py:pt_swap transcribed to NumPy with the uniforms given: every
    pair evaluated, ``do`` masking the other parity's."""
    R = len(betas)
    C, dim = q.shape
    M = C // R
    qr, lpr = q.reshape(R, M, dim).copy(), lp.reshape(R, M).copy()
    prop, accs = np.zeros(R - 1, np.int64), np.zeros(R - 1, np.int64)
    for i in range(R - 1):
        do = parity == (i % 2)
        dlb = np.asarray(betas[i] - betas[i + 1], q.dtype)
        with np.errstate(invalid="ignore"):
            log_alpha = dlb * (lpr[i + 1] - lpr[i])
            acc = do & np.isfinite(log_alpha) & (np.log(u[i]) < log_alpha)
        qi, qj = qr[i].copy(), qr[i + 1].copy()
        qr[i] = np.where(acc[:, None], qj, qi)
        qr[i + 1] = np.where(acc[:, None], qi, qj)
        li, lj = lpr[i].copy(), lpr[i + 1].copy()
        lpr[i] = np.where(acc, lj, li)
        lpr[i + 1] = np.where(acc, li, lj)
        prop[i] += M if do else 0
        accs[i] += acc.sum()
    return qr.reshape(C, dim), lpr.reshape(C), prop, accs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("R,M,dim", [(2, 6, 5), (3, 5, 4), (5, 7, 9)])
def test_swap_round_matches_jax_transcription(R, M, dim, parity, dtype):
    """q, lp and the counts equal, with one lp NaN (never swapped) and lp
    spread so that pairs are accepted and refused."""
    rng = np.random.default_rng(R * 10 + parity)
    C = R * M
    betas = (1.0,) + tuple(np.geomspace(0.6, 0.05, R - 1))
    q = rng.standard_normal((C, dim)).astype(dtype)
    lp = (3.0 * rng.standard_normal(C)).astype(dtype)
    lp[M + 1] = np.nan
    u = rng.uniform(size=(R - 1, M)).astype(dtype)
    qj, lj, pj, aj = jax_pt_swap(q, lp, betas, u, parity)
    qt, lt, pt_, at = pt_swap_plain(torch.as_tensor(q), torch.as_tensor(lp),
                                    betas, torch.as_tensor(u), parity)
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(lt.numpy(), lj)
    np.testing.assert_array_equal(pt_.numpy(), pj)
    np.testing.assert_array_equal(at.numpy(), aj)
    # both outcomes occur where the round has pairs (two rungs at parity 1
    # have none)
    active = [i for i in range(R - 1) if i % 2 == parity]
    assert 0 < aj.sum() < M * len(active) or not active
    # the bound form on the CPU: in place, counters added to
    prop = torch.full((R - 1,), 3, dtype=torch.int32)
    accs = torch.zeros_like(prop)
    qb, lb = torch.as_tensor(q).clone(), torch.as_tensor(lp).clone()
    par = torch.tensor([parity], dtype=torch.int32)
    tpt.bind_pt_swap(qb, lb, betas, torch.as_tensor(u), par, prop, accs)()
    assert torch.equal(qb, qt)
    np.testing.assert_array_equal(lb.numpy(), lj)
    np.testing.assert_array_equal(prop.numpy(), pj + 3)
    np.testing.assert_array_equal(accs.numpy(), aj)


# --------------------------------------------------------------------------
# targets at a temperature per chain
# --------------------------------------------------------------------------


_JAX_TARGETS = {}


def _jax_per_chain(jmode, qs, betas):
    """JAX's target vmapped over the states and their temperatures (jitted
    once per mode)."""
    fn = _JAX_TARGETS.setdefault(id(jmode), jax.jit(jax.vmap(
        jmode.logp_grad)))
    vj, gj = fn(jnp.asarray(qs), jnp.asarray(betas))
    return np.asarray(vj), np.asarray(gj)


def _assert_target_matches(vj, gj, vt, gt, betas):
    """Gradients to 1e-9 of their scale; lp / beta through its differences
    between states, to 1e-9 of its scale."""
    assert _rel(gj, gt) < 1e-9
    rj, rt = vj / betas, vt / betas
    assert _rel(rj - rj[0], rt - rt[0]) < 1e-9


@pytest.mark.parametrize("reparam,storage", MODES)
def test_per_chain_targets_match_jax(fitted, reparam, storage):  # noqa: F811
    """Each mode's target with one temperature per chain (K1's plain
    versions broadcast it) against JAX's at each chain's temperature; the
    value-only bound evaluation writes the full evaluation's lp, bit for
    bit, and agrees with JAX's at beta = 1."""
    (jmode, *_), (tmode, *_) = _modes(fitted, reparam, storage)
    qs = _states(jmode, n=8)
    betas, _ = _per_chain(HES1_LADDER[:4], 2)
    vj, gj = _jax_per_chain(jmode, qs, betas)
    target = tmode.logp_grad
    vt, gt = target(_t(qs), _t(betas))
    _assert_target_matches(vj, gj, vt.numpy(), gt.numpy(), betas)
    # the bound evaluations at the same temperatures, and the value alone
    q, bt = _t(qs).clone(), _t(betas).clone()
    lp, grad, lpv = torch.empty(8, dtype=F64), torch.empty_like(q), \
        torch.empty(8, dtype=F64)
    target.bind(q, bt, lp, grad)()
    assert torch.equal(lp, vt) and torch.equal(grad, gt)
    one = torch.ones((), dtype=F64)
    lp1 = target(q, one)[0]
    target.bind_value(q, one, lpv)()
    assert torch.equal(lpv, lp1)
    v1, _ = _jax_per_chain(jmode, qs, np.ones_like(betas))
    assert _rel(v1 - v1[0], lpv.numpy() - lpv.numpy()[0]) < 1e-9


@pytest.fixture(scope="module")
def hes1_centered():
    """A JAX Hes1 fit (the data of examples/hes1.py at discretization 1,
    the fits cut to 60 + 150 iterations) carried into the port
    (from_fit_arrays), beta = 1; both packages' centered targets with
    sigma pinned at 0.15^2, as the recipe samples them."""
    ts, _, X_true = simulate_ode(
        MODEL_REGISTRY["hes1"].f_vec, x0=np.array([1.439, 2.037, 17.904]),
        thetas=np.array(MODEL_REGISTRY["hes1"].true_thetas), t_max=240.0,
        n_obs=33, noise_sd=0.0, substeps=200)
    X = np.log(X_true) + 0.15 * np.random.default_rng(0).standard_normal(
        X_true.shape)
    X[:, 2] = np.nan
    jm = J.MAGI_v2(7, ts, X, None, jhes1, J.MagiConfig().replace(
        hparam_num_iters=60, init_num_iters=150))
    jm.initial_fit(discretization=1)
    jm.beta = 1.0
    jmode, *_ = jm._build_sampling_setup("centered", "dense", jnp.float64,
                                         sigma_sqs_fixed=SIGMA_FIXED)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, thes1, 7, config=MagiConfig(device="cpu"))
    tm.beta = 1.0
    tmode, _, _ = tm._build_sampling_setup("centered", "dense", F64,
                                           sigma_sqs_fixed=SIGMA_FIXED)
    pre_fix = tm._sigma_bounds(None, SIGMA_FIXED)[2]
    q0 = np.concatenate([jm.Xhat_init.ravel(), pre_fix,
                         np.log(np.expm1(jm.thetas_init))])
    return jmode, tmode, q0


def test_hes1_centered_per_chain_target_matches_jax(hes1_centered):
    """The pinned centered Hes1 target (PinnedSigma around GNTarget) at
    the Hes1 ladder's temperatures, one per chain, against JAX's; its
    value-only evaluation against its full one (bit for bit) and JAX's."""
    jmode, tmode, q0 = hes1_centered
    betas, _ = _per_chain(HES1_LADDER, 2)
    qs = q0 + 0.02 * np.random.default_rng(4).standard_normal(
        (betas.size, q0.size))
    vj, gj = _jax_per_chain(jmode, qs, betas)
    vt, gt = tmode.logp_grad(_t(qs), _t(betas))
    _assert_target_matches(vj, gj, vt.numpy(), gt.numpy(), betas)
    one = torch.ones((), dtype=F64)
    q, lpv = _t(qs).clone(), torch.empty(betas.size, dtype=F64)
    tmode.logp_grad.bind_value(q, one, lpv)()
    assert torch.equal(lpv, tmode.logp_grad(q, one)[0])
    v1, _ = _jax_per_chain(jmode, qs, np.ones_like(betas))
    assert _rel(v1 - v1[0], lpv.numpy() - lpv.numpy()[0]) < 1e-9


# --------------------------------------------------------------------------
# transitions at a temperature and a step per chain
# --------------------------------------------------------------------------


def _seir_pt_setup(fitted, C=8, seed=3):  # noqa: F811
    (jmode, *_), (tmode, *_) = _modes(fitted, "precond", "dense")
    qs = _states(jmode, n=C, seed=seed, scale=0.02)
    betas, scale = _per_chain(HES1_LADDER[:4], C // 4)
    return jmode, tmode, qs, betas, scale


@pytest.mark.parametrize("step_size", [0.001, 0.004])
def test_nuts_step_at_per_chain_temperatures_matches_jax(fitted,  # noqa: F811
                                                         step_size):
    """One NUTS transition of 8 chains, each at its rung's beta and step
    eps beta^(-1/2), against JAX's vmapped nuts_step with the same
    per-chain beta and step and the noise JAX draws; the bound transition
    on the target's bound evaluation gives the eager one's bits."""
    depth = 6
    jmode, tmode, qs, betas, scale = _seir_pt_setup(fitted)
    C, dim = qs.shape
    eps = step_size * scale
    jm, tm = _masses(dim, dense=False)
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    qj, info = jax.vmap(lambda k, q, b, e: jnuts_step(
        lambda r: jmode.logp_grad(r, b), k, q, e, jm,
        JNutsConfig(max_tree_depth=depth)))(
            keys, jnp.asarray(qs), jnp.asarray(betas), jnp.asarray(eps))
    noise = jax_noise(keys, dim, depth)
    cfg = tnuts.NutsConfig(depth)
    bt, et = _t(betas), _t(eps)
    qt, tinfo = tnuts.nuts_step(lambda r: tmode.logp_grad(r, bt), _t(qs), et,
                                tm, noise, cfg)
    _assert_matches_jax((qj, info), qt, tinfo)
    assert len(set(tinfo.depth.tolist())) > 1
    bound = tnuts.BoundNuts(tmode.logp_grad, _t(qs), tm, cfg, per_chain=True)
    qb, ib = bound(_t(qs), et, tm, bt, noise)
    assert torch.equal(qb, qt)
    assert all(torch.equal(a, b) for a, b in zip(ib, tinfo))


def test_bound_nuts_with_one_temperature_keeps_its_bits(fitted):  # noqa: F811
    """A 0-dim temperature and step, copied into the (C,) buffers, give
    the bits of the object bound to one temperature and of the eager form,
    per_chain or not."""
    _, tmode, qs, _, _ = _seir_pt_setup(fitted)
    C, dim = qs.shape
    _, mass = _masses(dim, dense=True)
    cfg = tnuts.NutsConfig(5)
    g = torch.Generator().manual_seed(0)
    noise = tnuts.draw_noise(g, C, dim, 5, F64, torch.device("cpu"))
    bt, eps = torch.tensor(0.37, dtype=F64), torch.tensor(0.01, dtype=F64)
    outs = []
    for per_chain in (False, True):
        b = tnuts.BoundNuts(tmode.logp_grad, _t(qs), mass, cfg,
                            per_chain=per_chain)
        outs.append(b(_t(qs), eps, mass, bt, noise))
    outs.append(tnuts.nuts_step(lambda r: tmode.logp_grad(r, bt), _t(qs),
                                eps, mass, noise, cfg))
    # a (C,) temperature filled with the one value, per chain
    b = tnuts.BoundNuts(tmode.logp_grad, _t(qs), mass, cfg, per_chain=True)
    outs.append(b(_t(qs), eps.expand(C), mass, bt.expand(C), noise))
    for q, info in outs[1:]:
        assert torch.equal(q, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(info, outs[0][1]))
    with pytest.raises(ValueError, match="per_chain"):
        tnuts.BoundNuts(tmode.logp_grad, _t(qs), mass, cfg)(
            _t(qs), eps, mass, bt.expand(C), noise)


@pytest.mark.parametrize("per_chain_beta", [False, True])
def test_bound_transition_at_per_chain_temperatures(fitted,  # noqa: F811
                                                    per_chain_beta):
    """HMC's bound transition with (C,) buffers against the eager
    hmc_step: per-chain temperatures and steps, bit for bit; and a 0-dim
    temperature and step give the bits of the object bound to one."""
    _, tmode, qs, betas, scale = _seir_pt_setup(fitted)
    C, dim = qs.shape
    _, mass = _masses(dim, dense=True)
    rng = np.random.default_rng(5)
    normals, uniforms = _t(rng.standard_normal((C, dim))), _t(rng.uniform(
        size=C))
    target = tmode.logp_grad
    if per_chain_beta:
        bt, eps = _t(betas), _t(0.01 * scale)
    else:
        bt, eps = torch.tensor(0.37, dtype=F64), torch.tensor(0.01,
                                                              dtype=F64)
    qe, ie = thmc.hmc_step(lambda r: target(r, bt), _t(qs), eps, mass, 7,
                           normals, uniforms)
    bound = thmc.BoundTransition(target, _t(qs), mass, per_chain=True)
    qb, ib = bound(_t(qs), eps, mass, bt, 7, normals, uniforms)
    assert torch.equal(qb, qe) and torch.equal(ib.accept_prob,
                                               ie.accept_prob)
    if not per_chain_beta:
        one = thmc.BoundTransition(target, _t(qs), mass)
        q1, i1 = one(_t(qs), eps, mass, bt, 7, normals, uniforms)
        assert torch.equal(q1, qe) and torch.equal(i1.accept_prob,
                                                   ie.accept_prob)
    assert 0.0 < float(ie.accept_prob.min())


# --------------------------------------------------------------------------
# the bimodal harness of tests/test_pt.py, its sizes and tolerances
# --------------------------------------------------------------------------


def test_plain_hmc_stays_in_start_mode():
    """The negative control: beta = 1 chains never cross the barrier. In
    either package a chain may cross in warmup's first steps, while dual
    averaging tries steps up to ten times the initial one: JAX's control
    does at PRNGKey(1) and PRNGKey(4), the port's at seeds 0 and 1; seed 2
    is one where neither package's chains cross."""
    samples, _ = _run(_cfg(), C=8, seed=2)
    assert (samples[..., 0] < 0).all()


def test_pt_recovers_both_modes_with_correct_weights():
    R, M = 4, 8
    samples, stats = _run(_cfg(pt_betas=LADDER, num_results=3000), C=R * M)
    frac_right = float((samples[:, :M, 0] > 0).double().mean())
    assert 0.3 < frac_right < 0.7, frac_right
    acc = stats.pt_swap_accept.numpy()
    assert acc.shape == (R - 1,)
    assert ((acc > 0.05) & (acc <= 1.0)).all(), acc


def test_pt_respects_mixture_weights_asymmetric():
    R, M = 4, 8
    samples, _ = _run(_cfg(pt_betas=LADDER, num_results=3000), C=R * M,
                      seed=3, weight_right=0.8)
    frac_right = float((samples[:, :M, 0] > 0).double().mean())
    assert 0.6 < frac_right < 0.95, frac_right


@pytest.mark.parametrize("every", [1, 5])
def test_swap_cadence(monkeypatch, every):
    """A round after every ``every``-th sampling transition, parity
    alternating by round: each pair proposes M swaps in the rounds of its
    parity, and the acceptance is accepted over proposed."""
    rounds = []

    class Counted(tpt.BoundSwap):
        def __call__(self, q, u, parity):
            rounds.append(parity)
            return super().__call__(q, u, parity)

    made = []
    monkeypatch.setattr(trun, "BoundSwap",
                        lambda *a: made.append(Counted(*a)) or made[-1])
    R, M, T = 3, 4, 23
    _, stats = _run(_cfg(pt_betas=(1.0, 0.5, 0.25), pt_swap_every=every,
                         num_results=T, num_burnin_steps=10), C=R * M)
    n = T // every
    assert rounds == [k % 2 for k in range(n)]
    swap = made[0]
    np.testing.assert_array_equal(swap.prop.numpy(),
                                  [M * ((n + 1) // 2), M * (n // 2)])
    np.testing.assert_array_equal(
        stats.pt_swap_accept.numpy(),
        swap.accs.double().numpy() / np.maximum(swap.prop.numpy(), 1))


# --------------------------------------------------------------------------
# predict
# --------------------------------------------------------------------------


def test_pt_predict_matches_jax_results(fitted):  # noqa: F811
    """A small PT predict: the beta = 1 rung's chains with JAX's keys and
    shapes, ``pt_swap_accept`` (R - 1,) in [0, 1]."""
    jm, tm = fitted
    kw = dict(num_results=6, num_burnin_steps=6, num_chains=6, seed=0,
              init_jitter=0.01, algorithm="hmc", hmc_num_leapfrogs=4,
              use_annealing=False, pt_betas=(1.0, 0.5, 0.25))
    rj = jm.predict(**kw)
    rt = tm.predict(**kw)
    assert set(rt) == set(rj)
    assert set(rt["kernel_results"]) == set(rj["kernel_results"])
    for k in ("X_samps", "thetas_samps", "sigma_sqs_samps", "sample_results"):
        assert np.shape(rt[k]) == np.shape(rj[k]), k
    for k, v in rj["kernel_results"].items():
        if v is not None:
            assert np.shape(rt["kernel_results"][k]) == np.shape(v), k
    assert np.shape(rt["X_samps"])[:2] == (6, 2)
    acc = rt["kernel_results"]["pt_swap_accept"]
    assert acc.shape == (2,) and np.all((acc >= 0) & (acc <= 1))


@pytest.mark.parametrize("algorithm", ["hmc", "nuts"])
@pytest.mark.parametrize("reparam,storage", MODES)
def test_pt_predict_in_every_mode(fitted, reparam, storage,  # noqa: F811
                                  algorithm):
    """PT in every reparam x storage the port samples, both algorithms
    (NUTS trees cut to depth 3), with a NumPy ladder: finite draws of the
    beta = 1 rung."""
    _, tm = fitted
    tm.config = tm.config.replace(max_tree_depth=3)
    res = tm.predict(num_results=5, num_burnin_steps=5, num_chains=4, seed=1,
                     init_jitter=0.01, algorithm=algorithm,
                     hmc_num_leapfrogs=4, reparam=reparam, storage=storage,
                     anneal_mode="warmup_only", pt_betas=np.array([1.0, 0.4]),
                     pt_swap_every=2)
    assert res["X_samps"].shape == (5, 2, tm.mag_I, tm.D)
    assert np.all(np.isfinite(res["X_samps"]))
    assert res["kernel_results"]["accept_probs"].shape == (5, 2)
    acc = res["kernel_results"]["pt_swap_accept"]
    assert acc.shape == (1,) and 0.0 <= acc[0] <= 1.0

"""The port's NUTS (magi_v2_tpu_torch/sampler/nuts.py) against the JAX
package's: one transition of 8 chains on the small SEIR target with the
noise the JAX step draws, the bound transition against the eager one, the
leaf epilogue's U-turn orientation, whole runs on Gaussian targets, and
the SEIR slice's predict with the default algorithm. Float64 on the CPU,
where every kernel wrapper takes its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magi_v2_tpu as J
from magi_v2_tpu.models import seir_f_vec as jseir
from magi_v2_tpu.sampler import mass as jmass
from magi_v2_tpu.sampler.nuts import NutsConfig as JNutsConfig
from magi_v2_tpu.sampler.nuts import nuts_step as jnuts_step
from magi_v2_tpu.utils.data import simulate_ode
from magi_v2_tpu_torch import MagiConfig
from magi_v2_tpu_torch.models import seir_f_vec as tseir
from magi_v2_tpu_torch.ops import nuts as tnops
from magi_v2_tpu_torch.sampler import mass as tmass
from magi_v2_tpu_torch.sampler import nuts as tnuts
from magi_v2_tpu_torch.sampler import run as trun
from magi_v2_tpu_torch.utils.checkpoint import FIT_FIELDS, from_fit_arrays

torch.set_num_threads(2)

F64 = torch.float64
DEPTH = 6


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _spd(k, seed, cond=20.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    return (Q * np.geomspace(1.0, 1.0 / cond, k)) @ Q.T


@pytest.fixture(scope="module")
def magi_targets():
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, None, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    jmode, *_ = jm._build_sampling_setup("precond", "dense", jnp.float64)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, tseir, 3, config=MagiConfig(device="cpu"))
    tmode, _, _ = tm._build_sampling_setup("precond", "dense", F64)
    q0 = np.concatenate([np.asarray(jmode.X0).ravel(), [-10.5, -9.0, -9.5],
                         np.log(np.expm1(jm.thetas_init))])
    return jmode, tmode, q0


def jax_noise(keys, dim, depth, dtype=jnp.float64):
    """The numbers ``magi_v2_tpu.sampler.nuts.nuts_step`` draws from each
    chain's key (nuts.py: split -> momentum normals; per doubling split in
    4 -> direction, subtree key, acceptance uniform; per leaf a split of
    the subtree key -> the leaf's uniform), as the port's NutsNoise."""
    normals, go, leaf_u, acc_u = [], [], [], []
    for key in keys:
        key_mom, key = jax.random.split(key)
        normals.append(np.asarray(jax.random.normal(key_mom, (dim,), dtype)))
        g, lu, au = [], [], []
        for d in range(depth):
            key, key_dir, key_sub, key_acc = jax.random.split(key, 4)
            g.append(bool(jax.random.bernoulli(key_dir)))
            au.append(float(jax.random.uniform(key_acc, dtype=dtype)))
            for _ in range(1 << d):
                key_sub, sub = jax.random.split(key_sub)
                lu.append(float(jax.random.uniform(sub, dtype=dtype)))
        go.append(g)
        leaf_u.append(lu)
        acc_u.append(au)
    return tnuts.NutsNoise(_t(np.stack(normals)), torch.as_tensor(go),
                           _t(leaf_u), _t(acc_u))


def _masses(dim, dense, seed=1):
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 1.5, dim)
    if not dense:
        return jnp.asarray(var), _t(var)
    cov = np.diag(var) + 0.05 * _spd(dim, 2)
    return (jmass.mass_from_moments(jnp.asarray(var), jnp.asarray(cov)),
            tmass.mass_from_moments(_t(var), _t(cov)))


def _jax_and_port_steps(magi_targets, step_size, dense, C=8, seed=3):
    jmode, tmode, q0 = magi_targets
    dim = q0.size
    rng = np.random.default_rng(seed)
    qs = q0 + 0.05 * rng.standard_normal((C, dim))
    jm, tm = _masses(dim, dense)
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    one = jnp.asarray(1.0, jnp.float64)
    cfg = JNutsConfig(max_tree_depth=DEPTH)
    qj, info = jax.vmap(lambda k, q: jnuts_step(
        lambda r: jmode.logp_grad(r, one), k, q,
        jnp.asarray(step_size, jnp.float64), jm, cfg))(keys, jnp.asarray(qs))
    noise = jax_noise(keys, dim, DEPTH)
    one_t = torch.tensor(1.0, dtype=F64)
    port = dict(target=lambda r, bt: tmode.logp_grad(r, bt), qs=_t(qs),
                mass=tm, noise=noise, eps=torch.tensor(step_size, dtype=F64),
                one=one_t)
    return (qj, info), port


def _assert_matches_jax(jax_out, qt, tinfo):
    qj, info = jax_out
    np.testing.assert_array_equal(tinfo.num_leapfrogs.numpy(),
                                  np.asarray(info.num_leapfrogs))
    np.testing.assert_array_equal(tinfo.depth.numpy(), np.asarray(info.depth))
    np.testing.assert_array_equal(tinfo.diverging.numpy(),
                                  np.asarray(info.diverging))
    np.testing.assert_allclose(tinfo.accept_prob.numpy(),
                               np.asarray(info.accept_prob), rtol=1e-10)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-10)


# the two step sizes: one whose trees grow to 4-6 doublings (some to the
# maximum depth), one at which trees end after 2-3, three of the eight by
# divergence and one inside a subtree (4 leaves)
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("step_size", [0.002, 0.02])
def test_nuts_step_matches_jax_with_injected_noise(magi_targets, step_size,
                                                   dense):
    """One transition of 8 chains, eager: equal depths, leaves and
    divergences, and q and the acceptance statistic within rtol 1e-10."""
    jax_out, port = _jax_and_port_steps(magi_targets, step_size, dense)
    qt, tinfo = tnuts.nuts_step(
        lambda r: port["target"](r, port["one"]), port["qs"], port["eps"],
        port["mass"], port["noise"], tnuts.NutsConfig(max_tree_depth=DEPTH))
    _assert_matches_jax(jax_out, qt, tinfo)
    # the cases reach what they are meant to: both directions, and trees
    # of more than one depth
    go = port["noise"].go_right
    assert go[:, 0].any() and not go[:, 0].all()
    assert len(set(tinfo.depth.tolist())) > 1


@pytest.mark.parametrize("dense", [True, False])
def test_bound_nuts_matches_eager_bit_for_bit(magi_targets, dense):
    """``BoundNuts`` on the target's bound evaluation (fixed buffers; CUDA
    graphs on the card) gives the eager form's bits, transition after
    transition, and each agrees with JAX."""
    _, tmode, _ = magi_targets
    jax_out, port = _jax_and_port_steps(magi_targets, 0.02, dense)
    cfg = tnuts.NutsConfig(max_tree_depth=DEPTH)
    bound = tnuts.BoundNuts(tmode.logp_grad, port["qs"], port["mass"], cfg)
    qb, ib = bound(port["qs"], port["eps"], port["mass"], port["one"],
                   port["noise"])
    qe, ie = tnuts.nuts_step(lambda r: port["target"](r, port["one"]),
                             port["qs"], port["eps"], port["mass"],
                             port["noise"], cfg)
    assert torch.equal(qb, qe)
    for a, b in zip(ib, ie):
        assert torch.equal(a, b)
    _assert_matches_jax(jax_out, qb, ib)
    # a second transition from the new state on the same buffers
    qb2, ib2 = bound(qb, port["eps"], port["mass"], port["one"],
                     port["noise"])
    qe2, ie2 = tnuts.nuts_step(lambda r: port["target"](r, port["one"]),
                               qe, port["eps"], port["mass"], port["noise"],
                               cfg)
    assert torch.equal(qb2, qe2) and torch.equal(ib2.num_leapfrogs,
                                                 ie2.num_leapfrogs)
    assert torch.equal(qb2, qe2) and torch.equal(ib2.num_leapfrogs,
                                                 ie2.num_leapfrogs)


def _leaf_state(eps, n, q, v, ckpt_q, ckpt_v, lp=0.0):
    """The leaf's operands for one chain at leaf n of doubling 2 (depth 3
    slots): an identity mass, p = v and no force, so that the leaf closes
    at v_end = v with kinetic energy 0.5 |v|^2 = 0.5; H0 = 0.5 - lp
    (dH = 0) and uniforms of 0.5."""
    D, dim = 3, len(q)
    z = lambda *s: torch.zeros(s, dtype=F64)
    ck_q, ck_v = z(D, 1, dim), z(D, 1, dim)
    for s, (a, b) in enumerate(zip(ckpt_q, ckpt_v)):
        ck_q[s, 0], ck_v[s, 0] = _t(a), _t(b)
    ops = dict(q=_t([q]), p=_t([v]), g=z(1, dim), lp=_t([lp]),
               H0=_t([0.5 - lp]), eps=_t([eps]),
               inv_mass=torch.ones(dim, dtype=F64),
               leaf_u=torch.full((1, 7), 0.5, dtype=F64),
               ctr=torch.tensor([2, n], dtype=torch.int32), lsw=_t([0.0]),
               sum_alpha=z(1), prop_q=z(1, dim), ckpt_q=ck_q, ckpt_v=ck_v,
               active=torch.ones(1, dtype=torch.bool),
               turning=torch.zeros(1, dtype=torch.bool),
               diverging=torch.zeros(1, dtype=torch.bool),
               n_leaves=torch.zeros(1, dtype=torch.int32), vel=z(1, dim))
    return ops


def test_leaf_uturn_is_checked_in_trajectory_time_order():
    """A backward subtree on a straight line: leaf 1 (odd, checked against
    slot 0) lies one step behind the checkpoint in integration time, so
    its unflipped displacement q - q_s points against v and would read as
    a U-turn; the leaf flips it by the direction's sign and goes on. The
    same geometry forward is a U-turn, and an even leaf stores its (q, v)
    in slot popcount(n)."""
    v = [1.0, 0.0]
    for eps, q, turns in ((-0.1, [-0.1, 0.0], False),
                          (0.1, [-0.1, 0.0], True)):
        ops = _leaf_state(eps, 1, q, v, [[0.0, 0.0]], [v])
        tnops.nuts_leaf(*ops.values())
        assert bool(ops["turning"][0]) is turns
        assert bool(ops["active"][0]) is (not turns)
        assert int(ops["n_leaves"][0]) == 1
        assert int(ops["ctr"][1]) == 2
    ops = _leaf_state(0.1, 2, [0.2, 0.0], v, [[0.0, 0.0]], [v])
    tnops.nuts_leaf(*ops.values())
    assert torch.equal(ops["ckpt_q"][1, 0], _t([0.2, 0.0]))
    assert torch.equal(ops["ckpt_v"][1, 0], _t(v))
    assert torch.equal(ops["vel"][0], _t(v))
    assert not bool(ops["turning"][0])
    # the next leaf opened: q drifted by eps v (no force, so p stays v)
    assert torch.allclose(ops["q"][0], _t([0.3, 0.0]), rtol=1e-15)
    # a masked chain is left as it was
    ops = _leaf_state(0.1, 1, [-0.1, 0.0], v, [[0.0, 0.0]], [v])
    ops["active"][0] = False
    tnops.nuts_leaf(*ops.values())
    assert not bool(ops["turning"][0]) and int(ops["n_leaves"][0]) == 0
    assert torch.equal(ops["q"], _t([[-0.1, 0.0]]))
    assert torch.equal(ops["vel"], torch.zeros(1, 2, dtype=F64))


def test_leaf_divergence_and_nan_energy():
    """A non-finite energy counts as a divergence (dH = +inf): no weight,
    no proposal, the chain stops."""
    v = [1.0, 0.0]
    ops = _leaf_state(0.1, 0, [0.3, 0.0], v, [], [], lp=float("nan"))
    tnops.nuts_leaf(*ops.values())
    assert bool(ops["diverging"][0]) and not bool(ops["active"][0])
    assert float(ops["sum_alpha"][0]) == 0.0
    assert float(ops["lsw"][0]) == 0.0       # logaddexp(0, -inf)
    assert torch.equal(ops["prop_q"], torch.zeros(1, 2, dtype=F64))


def _separate_epilogue(q, v, lp, kin, H0, eps, leaf_u, ctr, lsw,
                       sum_alpha, prop_q, ckpt_q, ckpt_v, active, turning,
                       diverging, n_leaves, max_energy_diff):
    """The leaf epilogue as it was a launch of its own (kernel K5 before
    the leaf was fused), in place: the reference the fused leaf replaces."""
    d, n = (int(x) for x in ctr.tolist())
    on = active.clone()
    dH = (-lp + kin) - H0
    dH = torch.where(torch.isfinite(dH), dH, torch.full_like(dH,
                                                             float("inf")))
    div = dH > max_energy_diff
    lw = -dH
    sa = sum_alpha + torch.exp(torch.clamp(-dH, max=0.0))
    lsw_new = torch.logaddexp(lsw, lw)
    take = torch.log(leaf_u[:, (1 << d) - 1 + n]) < lw - lsw_new
    torch.where((on & take)[:, None], q, prop_q, out=prop_q)
    pc = bin(n).count("1")
    turn = torch.zeros_like(on)
    if n % 2 == 0:
        torch.where(on[:, None], q, ckpt_q[pc], out=ckpt_q[pc])
        torch.where(on[:, None], v, ckpt_v[pc], out=ckpt_v[pc])
    else:
        sign = torch.sign(eps)[:, None]
        for s in range(pc - tnops.trailing_ones(n), pc):
            dq = sign * (q - ckpt_q[s])
            turn |= ((torch.sum(dq * ckpt_v[s], dim=-1) < 0.0)
                     | (torch.sum(dq * v, dim=-1) < 0.0))
    torch.where(on, lsw_new, lsw, out=lsw)
    torch.where(on, sa, sum_alpha, out=sum_alpha)
    n_leaves += on.to(n_leaves.dtype)
    torch.where(on, turn, turning, out=turning)
    torch.where(on, div, diverging, out=diverging)
    active &= ~(turn | div)


def _leaf_case(mass_form, d, n, C=8, dim=12, D=4, seed=11):
    """The fused leaf's operands for C chains: unit-scale states, momenta,
    forces and slots; energies within a few units of H0 except chain 2
    (dH ~ 2000, a divergence); chain 3 with a NaN force (a non-finite
    energy) and chain 5 masked with a NaN force; chains 0 and 6 masked;
    chains 1, 4 and 7 with slots they do not turn against; signed steps
    of both signs; a dense, diagonal or tail-of-4 mass."""
    from magi_v2_tpu_torch.sampler.mass import TailDenseMass

    rng = np.random.default_rng(seed + 17 * n + d)
    r = lambda *s: _t(rng.standard_normal(s))
    diag = _t(rng.uniform(0.5, 1.5, dim))
    k = {"dense": dim, "diag": 0, "tail": 4}[mass_form]
    mass = (TailDenseMass(diag, _t(_spd(k, seed, cond=5.0)), None) if k
            else diag)
    g = r(C, dim)
    g[3] = float("nan")
    g[5] = float("nan")
    lp = r(C)
    H0 = 0.5 * dim - lp + r(C)
    H0[2] -= 2000.0
    active = torch.ones(C, dtype=torch.bool)
    active[[0, 5, 6]] = False
    q, p = r(C, dim), r(C, dim)
    eps = 0.05 * _t(np.where(rng.uniform(size=C) < 0.5, -1.0, 1.0))
    ckpt_q, ckpt_v = r(D, C, dim), r(D, C, dim)
    # chains 1, 4 and 7 move on along their velocity at the leaf's close
    # (no U-turn against any slot); the others' slots are random
    go_on = [1, 4, 7]
    v_end = tmass.mass_vel(mass, p + 0.5 * eps[:, None] * g)[go_on]
    ckpt_v[:, go_on] = v_end
    ckpt_q[:, go_on] = q[go_on] - 0.3 * torch.sign(eps[go_on])[:, None] * v_end
    return dict(q=q, p=p, g=g, lp=lp, H0=H0, eps=eps, inv_mass=mass,
                leaf_u=_t(rng.uniform(size=(C, (1 << D) - 1))),
                ctr=torch.tensor([d, n], dtype=torch.int32), lsw=r(C),
                sum_alpha=_t(rng.uniform(size=C)), prop_q=r(C, dim),
                ckpt_q=ckpt_q, ckpt_v=ckpt_v, active=active,
                turning=torch.zeros(C, dtype=torch.bool),
                diverging=torch.zeros(C, dtype=torch.bool),
                n_leaves=_t(rng.integers(0, 50, C)).to(torch.int32),
                vel=r(C, dim))


def _composition(ops, open_mask):
    """The leaf as the launches it replaces: K2's closing launch (one kick,
    the kinetic energy, v), K5, the counter's add and K2's opening launch
    for the chains of ``open_mask`` ("after": those still active, as the
    separate launches did; "start": those active when the leaf began, the
    fused leaf's semantics)."""
    from magi_v2_tpu_torch.sampler.hmc import leapfrog_update_plain

    o = {k: v.clone() if isinstance(v, torch.Tensor) else v
         for k, v in ops.items()}
    start = o["active"].clone()
    kin = leapfrog_update_plain(o["q"], o["p"], o["g"], o["eps"],
                                o["inv_mass"], 1, False, True, o["active"],
                                o["vel"])
    _separate_epilogue(o["q"], o["vel"], o["lp"], kin, o["H0"], o["eps"],
                       o["leaf_u"], o["ctr"], o["lsw"], o["sum_alpha"],
                       o["prop_q"], o["ckpt_q"], o["ckpt_v"], o["active"],
                       o["turning"], o["diverging"], o["n_leaves"], 1000.0)
    d, n = (int(x) for x in o["ctr"].tolist())
    o["ctr"][1:] += 1
    if n + 1 < (1 << d):
        leapfrog_update_plain(o["q"], o["p"], o["g"], o["eps"],
                              o["inv_mass"], 1, True, False,
                              start if open_mask == "start" else o["active"])
    return o


# (doubling, leaf): an even leaf (slot 1), an odd one checked against two
# slots, the doubling's last leaf (odd, no opening) and the one-leaf
# doubling's leaf (even, last)
@pytest.mark.parametrize("d,n", [(3, 4), (3, 3), (2, 3), (0, 0)])
@pytest.mark.parametrize("mass_form", ["dense", "diag", "tail"])
def test_fused_leaf_matches_the_launches_it_replaces(mass_form, d, n):
    """The fused plain leaf (close, epilogue, counter, next opening) against
    K2's plain close, the separate epilogue's (K5's) plain body and K2's
    plain open, in float64: every observable to rtol 1e-12 (the flags,
    counts and the rows copied exactly); q, p and v of the chains that stay active as the composition
    gives them; a chain that turns or diverges in the launch drifted once
    more (opened with the mask of the leaf's start); chains masked before
    the launch untouched, a NaN force included."""
    ops = _leaf_case(mass_form, d, n)
    fused = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in ops.items()}
    tnops.nuts_leaf(*fused.values())
    after, start = _composition(ops, "after"), _composition(ops, "start")
    before = ops["active"]
    stay = fused["active"]
    stopped = before & ~stay
    idle = ~before
    # the cases reach what they are meant to
    assert bool(fused["diverging"][2]) and bool(fused["diverging"][3])
    if n % 2:
        assert bool(fused["turning"].any())
    assert stay.any() and stopped.any()
    for name in ("active", "turning", "diverging", "n_leaves", "ctr",
                 "prop_q", "ckpt_q", "ckpt_v"):
        np.testing.assert_array_equal(fused[name].numpy(),
                                      after[name].numpy(), err_msg=name)
    for name in ("lsw", "sum_alpha"):
        np.testing.assert_allclose(fused[name].numpy(), after[name].numpy(),
                                   rtol=1e-12)
    for name in ("q", "p", "vel"):
        np.testing.assert_allclose(fused[name][stay].numpy(),
                                   after[name][stay].numpy(), rtol=1e-12)
        np.testing.assert_allclose(fused[name][stopped].numpy(),
                                   start[name][stopped].numpy(), rtol=1e-12)
        assert torch.equal(fused[name][idle], ops[name][idle]), name
    np.testing.assert_array_equal(fused["g"].numpy(), ops["g"].numpy())
    assert torch.isfinite(fused["q"][stay]).all()


def _gaussian_target(cov):
    prec = torch.as_tensor(np.linalg.inv(cov))

    def lp(q, beta_temp):
        g = -(q @ prec.to(q.dtype)) * beta_temp
        return 0.5 * torch.sum(q * g, dim=-1), g

    return lp


def test_nuts_standard_normal_moments():
    """tests/test_sampler.py's standard-normal check, on the port."""
    cfg = trun.SamplerConfig(num_results=1500, num_burnin_steps=500,
                             use_annealing=False, max_tree_depth=6)
    q0 = torch.zeros((8, 3), dtype=F64) + 2.0
    samples, stats = trun.run_chains(_gaussian_target(np.eye(3)), q0, 1, cfg)
    flat = samples.reshape(-1, 3).numpy()
    assert np.abs(flat.mean(axis=0)).max() < 0.1
    np.testing.assert_allclose(flat.var(axis=0), 1.0, atol=0.15)
    assert not stats.divergences.numpy().any()
    assert 0.05 < float(stats.step_size) < 5.0
    assert stats.depths.shape == (1500, 8) and stats.depths.min() >= 1
    np.testing.assert_array_less(stats.num_leapfrogs, 2 ** stats.depths)


def test_nuts_correlated_gaussian_covariance():
    """tests/test_sampler.py's correlated-Gaussian check, on the port."""
    cov = np.array([[1.0, 0.7], [0.7, 2.0]])
    cfg = trun.SamplerConfig(num_results=2500, num_burnin_steps=800,
                             use_annealing=False, max_tree_depth=6)
    q0 = torch.zeros((8, 2), dtype=F64)
    samples, _ = trun.run_chains(_gaussian_target(cov), q0, 2, cfg)
    emp = np.cov(samples.reshape(-1, 2).numpy().T)
    np.testing.assert_allclose(emp, cov, atol=0.3)


def test_unknown_algorithm_raises():
    cfg = trun.SamplerConfig(num_results=2, num_burnin_steps=2,
                             algorithm="slice")
    with pytest.raises(ValueError, match="unknown algorithm"):
        trun.run_chains(_gaussian_target(np.eye(2)),
                        torch.zeros((2, 2), dtype=F64), 0, cfg)


# ---------------------------------------------------------------------------
# the slice: predict with the default algorithm


RECIPE = dict(
    num_chains=8, seed=0, init_jitter=0.01, mass_matrix="dense",
    anneal_mode="reference", dense_shrinkage=0.2, mass_window=(0.25, 0.45),
    mass_window2=(0.50, 0.72), mass_window1_diag=True,
)
STEPS = 200


@pytest.fixture(scope="module")
def seir_runs():
    """The JAX package's and the port's predict with the default algorithm
    (NUTS) on one tiny SEIR fit."""
    ts, X, _ = simulate_ode(jseir, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005, substeps=20)
    jm = J.MAGI_v2(3, ts, X, 20, jseir, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100, max_tree_depth=6))
    jm.initial_fit(discretization=1)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, tseir, 3, bandsize=20,
                         config=MagiConfig(device="cpu", max_tree_depth=6))
    rj = jm.predict(num_results=STEPS, num_burnin_steps=STEPS, **RECIPE)
    rt = tm.predict(num_results=STEPS, num_burnin_steps=STEPS, **RECIPE)
    return rj, rt


def test_default_predict_is_nuts_and_matches_jax(seir_runs):
    """Different random streams, same posterior: the pooled theta means
    within 5 combined Monte-Carlo standard errors, as
    tests/test_torch_slice.py holds the HMC runs; the results dict has the
    JAX package's keys and shapes, with per-chain tree depths."""
    from magi_v2_tpu_torch.utils.diagnostics import effective_sample_size

    rj, rt = seir_runs
    assert set(rt) == set(rj)
    for k, v in rj["kernel_results"].items():
        assert np.shape(rt["kernel_results"][k]) == np.shape(v), k
    kr = rt["kernel_results"]
    assert kr["depths"].max() > 1 and kr["depths"].max() <= 6
    np.testing.assert_array_less(kr["num_leapfrogs"], 2 ** kr["depths"])
    for p in range(3):
        a, b = rj["thetas_samps"][..., p], rt["thetas_samps"][..., p]
        se = np.hypot(a.std() / np.sqrt(effective_sample_size(a)),
                      b.std() / np.sqrt(effective_sample_size(b)))
        assert abs(a.mean() - b.mean()) <= 5.0 * se, (p, a.mean(), b.mean(),
                                                      se)
    assert kr["accept_probs"].mean() > 0.5
    assert kr["divergences"].mean() < 0.01


def test_hybrid_nuts_transition_bound_is_eager():
    """One NUTS transition on the small Lorenz grid's storage="hybrid"
    target (K4 whitening around dense operators): bound and eager agree
    bit for bit."""
    from magi_v2_tpu_torch.models import lorenz_f_vec
    from magi_v2_tpu_torch.utils.data import simulate_ode as tsim

    import magi_v2_tpu_torch as T

    cfg = T.MagiConfig(device="cpu", dtype=F64, hparam_num_iters=30,
                       init_num_iters=50)
    ts, X, _ = tsim(lorenz_f_vec, x0=np.array([-8.0, 7.0, 27.0]),
                    thetas=np.array([10.0, 28.0, 8.0 / 3.0]), t_max=2.0,
                    n_obs=17, noise_sd=0.5, substeps=20)
    model = T.MAGI_v2(3, ts, X, 4, lorenz_f_vec, cfg)
    model.initial_fit(2, thetas_init=np.array([10.0, 28.0, 8.0 / 3.0]))
    mode, _, _ = model._build_sampling_setup("precond", "hybrid", F64,
                                             sigma_sqs_fixed=0.25)
    target = mode.logp_grad
    dim = model.mag_I * 3 + 6
    rng = np.random.default_rng(0)
    q0 = np.concatenate([mode.X0.numpy().ravel(),
                         [-1.5, -1.5, -1.5, 2.3, 3.3, 0.9]])
    qs = _t(q0 + 0.01 * rng.standard_normal((4, dim)))
    inv_mass = torch.ones(dim, dtype=F64)
    ncfg = tnuts.NutsConfig(max_tree_depth=5)
    gen = torch.Generator().manual_seed(0)
    noise = tnuts.draw_noise(gen, 4, dim, 5, F64, "cpu")
    eps, bt = torch.tensor(0.01, dtype=F64), torch.tensor(0.3, dtype=F64)
    qb, ib = tnuts.BoundNuts(target, qs, inv_mass, ncfg)(qs, eps, inv_mass,
                                                         bt, noise)
    qe, ie = tnuts.nuts_step(lambda r: target(r, bt), qs, eps, inv_mass,
                             noise, ncfg)
    assert torch.equal(qb, qe)
    for a, b in zip(ib, ie):
        assert torch.equal(a, b)
    assert ib.num_leapfrogs.min() >= 1 and torch.isfinite(qb).all()


# ---------------------------------------------------------------------------
# an ODE field with no CUDA functor


def test_unregistered_field_target_matches_jax():
    """The composed float64 target of a field with no CUDA functor (the
    smoke's FitzHugh-Nagumo, a plain PyTorch field registered nowhere) on
    the CPU against the JAX package's on the same fit, and the routing: on
    the card K1 takes its given kernels for this field, its functor's
    kernels for a registered one."""
    from chip_smoke import fitzhugh_nagumo_f_vec as fitzhugh_nagumo
    from magi_v2_tpu.models import fitzhugh_nagumo_f_vec as jfn
    from magi_v2_tpu_torch.models.odes import cuda_model_of
    from magi_v2_tpu_torch.ops import manifold as mf

    assert cuda_model_of(fitzhugh_nagumo) is None
    assert mf._given(fitzhugh_nagumo)
    assert not mf._given(tseir)
    ts, X, _ = simulate_ode(jfn, x0=np.array([-1.0, 1.0]),
                            thetas=np.array([0.2, 0.2, 3.0]), t_max=4.0,
                            n_obs=21, noise_sd=0.05, substeps=20)
    jm = J.MAGI_v2(3, ts, X, None, jfn, J.MagiConfig().replace(
        hparam_num_iters=50, init_num_iters=100))
    jm.initial_fit(discretization=1)
    jmode, *_ = jm._build_sampling_setup("precond", "dense", jnp.float64)
    arrays = {f: np.asarray(getattr(jm, f)) for f in FIT_FIELDS}
    tm = from_fit_arrays(arrays, fitzhugh_nagumo, 3,
                         config=MagiConfig(device="cpu"))
    tmode, _, _ = tm._build_sampling_setup("precond", "dense", F64)
    rng = np.random.default_rng(0)
    q0 = np.concatenate([np.asarray(jmode.X0).ravel(), [-4.0, -4.0],
                         np.log(np.expm1(jm.thetas_init))])
    qs = q0 + 0.1 * rng.standard_normal((8, q0.size))
    bt = 0.37
    vj, gj = jax.vmap(lambda q: jmode.logp_grad(q, jnp.asarray(bt)))(
        jnp.asarray(qs))
    vt, gt = tmode.logp_grad(_t(qs), torch.tensor(bt, dtype=F64))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-9)
    assert np.abs(gt.numpy() - np.asarray(gj)).max() <= 1e-9 * np.abs(
        np.asarray(gj)).max()


def test_given_kernels_launch_lists():
    """The argument lists of K1's launches, for a field with a functor and
    for one without (the given kernels): as long as the C entry points'
    signatures, with each argument the plan binds at a call where the
    plan rebinds it."""
    from magi_v2_tpu_torch.ops import manifold as mf
    from magi_v2_tpu_torch.ops._build import SIGNATURES

    names = {
        "fwd": ("delta", "RmD", "q", "x0T", "a0", "f0", "mask", "y",
                "sigma_lb", "beta_temp", "fv", "beta", "C", "N", "D", "dim",
                "dr", "gcat", "t14"),
        "energy": ("Ds", "s0", "t14", "q", "sigma_lb", "n_ds", "beta_temp",
                   "beta", "C", "N", "D", "dim", "lp", "gDs"),
        "bwd": ("gdr", "delta", "q", "x0T", "mask", "y", "sigma_lb", "n_ds",
                "beta_temp", "vjp", "C", "N", "D", "dim", "gcat", "gpart",
                "grad"),
    }
    make = {"fwd": mf._fwd_args, "energy": mf._energy_args,
            "bwd": mf._bwd_args}
    for given in (False, True):
        for kernel, fields in names.items():
            vals = {k: k for k in fields}
            vals["beta"] = 1.0
            vals["vjp"] = ("gx", "gth")
            args = make[kernel](given, *(vals[k] for k in fields),
                                ("part", "ticket"))
            family = f"manifold_{kernel}" + ("_given" if given else "")
            assert len(args) + 1 == len(SIGNATURES[family])
            assert args[-2:] == ["part", "ticket"]
            for name, i in mf._AT[given][kernel].items():
                assert args[i] == name, (given, kernel, name)
            assert ("D" in args) == given

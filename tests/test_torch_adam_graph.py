"""The Adam loop of the theta start and of gradient matching
(``init.py:adam_minimize``): its graph path's plan, its step's arithmetic
against the eager loop on the CPU, which callers ask for it, the CPU's
eager loop, and the hyperparameter Adam's positional contract that
``port_bench/harness/faults.py:unfitted`` patches. On a card, the graph
path against the eager loop; those tests skip without one. Run them with

    python -m pytest tests/test_torch_adam_graph.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from magi_v2_tpu_torch import MAGI_v2, MagiConfig
from magi_v2_tpu_torch import hparams as thp
from magi_v2_tpu_torch import init as tinit
from magi_v2_tpu_torch.models import MODEL_REGISTRY, hes1_log_f_vec, seir_f_vec
from magi_v2_tpu_torch.utils.data import simulate_ode
from magi_v2_tpu_torch.utils.profiling import PhaseTimer, untimed
from port_bench.harness import faults

K = tinit.GRAPH_CHUNK


def seir_fit():
    ts, X, _ = simulate_ode(seir_f_vec, x0=np.array([0.1, 0.05, 0.0]),
                            thetas=np.array([6.0, 0.6, 1.8]), t_max=2.0,
                            n_obs=21, noise_sd=0.005)
    m = MAGI_v2(3, ts, X, None, seir_f_vec,
                MagiConfig(device="cpu", hparam_num_iters=50,
                           init_num_iters=40))
    m.initial_fit(1)
    return m


@pytest.fixture(scope="module")
def seir():
    return seir_fit()


def theta_start(m, device, num_iters, timer=untimed):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    return tinit.fit_theta_fully_observed(
        seir_f_vec, t(m.I), t(m.X_interp_obs), t(m.mu_ds), t(m.m_ds),
        t(m.K_d_invs), 3, num_iters=num_iters, timer=timer)


def gradient_matching(device, num_iters, timer=untimed):
    """Three starts of the Hes1 gradient-matching fit (P and M observed on
    the log scale, H not), on 33 grid points."""
    hes1 = MODEL_REGISTRY["hes1"]
    ts, _, X = simulate_ode(hes1.f_vec, x0=np.array([1.439, 2.037, 17.904]),
                            thetas=np.array(hes1.true_thetas), t_max=240.0,
                            n_obs=33, noise_sd=0.0, substeps=200)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    X_obs = t(np.log(X[:, :2]))
    starts = tinit.gradient_matching_starts(3, 33, 1, 7, X_obs.cpu())
    return tinit.run_gradient_matching(
        hes1_log_f_vec, t(ts.reshape(-1, 1)), X_obs, [0, 1, 2], *starts,
        learning_rate=0.01, num_iters=num_iters, timer=timer)


def record_adam(monkeypatch, module=tinit):
    """The arguments and the result of each ``adam_minimize`` call made
    through ``module``, the call itself unchanged."""
    calls = []
    real = tinit.adam_minimize

    def spy(loss_fn, params, learning_rate, num_iters, timer=untimed, *,
            graph=False):
        out = real(loss_fn, params, learning_rate, num_iters, timer,
                   graph=graph)
        calls.append((loss_fn, params, learning_rate, num_iters, graph, out))
        return out

    monkeypatch.setattr(module, "adam_minimize", spy)
    return calls


@pytest.mark.parametrize("num_iters", [0, 1, K - 1, K, K + 1, 10_000])
def test_graph_plan_covers_every_step(num_iters):
    """Warm-up, replays of GRAPH_CHUNK steps and the eager remainder make
    exactly num_iters steps; a replay happens only after a warm-up step,
    and the remainder fills no chunk."""
    warm, replays, rest = tinit.graph_plan(num_iters)
    assert warm + replays * K + rest == num_iters
    assert warm == min(tinit.GRAPH_WARMUP, num_iters) and 0 <= rest < K
    assert warm >= 1 or replays == 0


def test_callers_ask_for_the_graph_path_and_the_cpu_loop_is_eager(
        monkeypatch):
    """The theta start asks for the graph path, the hyperparameters' Adam
    does not; on the CPU neither replays (no ``_adam_replayed`` call, no
    "adam_graph_steps" counter) and the graph keyword changes no bit."""
    def refused(*args, **kwargs):
        raise AssertionError("the graph path ran on the CPU")

    monkeypatch.setattr(tinit, "_adam_replayed", refused)
    hp_calls = record_adam(monkeypatch, thp)
    init_calls = record_adam(monkeypatch)
    m = seir_fit()
    assert [c[4] for c in init_calls] == [True]
    assert [c[4] for c in hp_calls] == [False]
    assert "adam_graph_steps" not in m.fit_trace["counts"]
    loss_fn, params, lr, n, _, _ = init_calls[0]
    p0, l0 = tinit.adam_minimize(loss_fn, params, lr, n, graph=True)
    p1, l1 = tinit.adam_minimize(loss_fn, params, lr, n)
    assert torch.equal(p0["th"], p1["th"]) and torch.equal(l0, l1)


@pytest.mark.parametrize("caller", ["theta_start", "gradient_matching"])
def test_graph_step_matches_the_eager_loop(caller, seir, monkeypatch):
    """The graph path's step (``_AdamStep``), run eagerly on the CPU,
    gives the eager loop's parameters and losses on each caller's loss:
    the update is torch.optim.Adam's (optax's, eps 1e-7) to rounding."""
    calls = record_adam(monkeypatch)
    if caller == "theta_start":
        theta_start(seir, "cpu", 300)
    else:
        gradient_matching("cpu", 300)
    ((loss_fn, params, lr, n, graph, _),) = calls
    assert graph and n == 300
    p_eager, l_eager = tinit.adam_minimize(loss_fn, params, lr, n)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    step = tinit._AdamStep(loss_fn, p, lr)
    losses = torch.stack([step() for _ in range(n)])
    assert losses.shape == l_eager.shape
    torch.testing.assert_close(losses, l_eager, rtol=1e-12, atol=0)
    for k in params:
        torch.testing.assert_close(p[k].detach(), p_eager[k], rtol=1e-12,
                                   atol=0)


def test_unfitted_patch_still_applies():
    """``faults.unfitted`` patches ``hparams.adam_minimize`` by its
    positional contract (loss_fn, params, learning_rate, num_iters,
    timer): under it the hyperparameters' Adam returns its start, with
    every step's loss; without it the fit moves."""
    ts = np.linspace(0.0, 2.0, 21)
    X = np.stack([np.sin(3 * ts), np.cos(2 * ts)], axis=1)
    kw = dict(num_iters=20, optimizer="adam", device="cpu")
    _, start = thp.make_hparam_objective(
        ts, X, thp.fourier_prior(X, t_range=2.0), 2.01, device="cpu")
    with faults.unfitted():
        held = thp.fit_kernel_hparams(ts, X, **kw)
    moved = thp.fit_kernel_hparams(ts, X, **kw)
    for key, pre in (("phi1s", "phi1_pre"), ("phi2s", "phi2_pre"),
                     ("sigma_sqs", "sigma_sq_pre")):
        np.testing.assert_array_equal(held[key],
                                      F.softplus(start[pre]).numpy())
        assert not np.allclose(moved[key], held[key])
    assert held["losses"].shape == (20,)
    np.testing.assert_array_equal(held["losses"], moved["losses"])


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path replays CUDA "
                    "graphs")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("num_iters", [1037, K - 1])
@pytest.mark.parametrize("caller", ["theta_start", "gradient_matching"])
def test_graph_path_matches_the_eager_loop_on_the_card(
        card, caller, num_iters, seir, monkeypatch):
    """On the card the graph path gives the eager loop's parameters and
    losses to 1e-8 (float64; the update's operations are ordered
    otherwise than torch.optim.Adam's), takes exactly num_iters steps,
    and replays the steps graph_plan puts in chunks."""
    calls = record_adam(monkeypatch)
    rec = PhaseTimer(card, trace=True)
    if caller == "theta_start":
        theta_start(seir, card, num_iters, rec)
    else:
        gradient_matching(card, num_iters, rec)
    ((loss_fn, params, lr, n, graph, (p_graph, l_graph)),) = calls
    assert graph and n == num_iters
    p_eager, l_eager = tinit.adam_minimize(loss_fn, params, lr, n)
    torch.testing.assert_close(l_graph, l_eager, rtol=1e-8, atol=0)
    for k in params:
        torch.testing.assert_close(p_graph[k], p_eager[k], rtol=1e-8,
                                   atol=0)
    _, replays, _ = tinit.graph_plan(num_iters)
    expected = {"adam_steps": num_iters}
    if replays:
        expected["adam_graph_steps"] = replays * K
    assert rec.counts == expected


@pytest.mark.cuda
def test_graph_path_keeps_no_memory(card):
    """Runs of the graph path keep no device memory past their return:
    neither the graph's pool nor a cuBLAS workspace of their side stream
    (PyTorch keeps one per handle and stream, and each run takes a new
    side stream)."""
    ops = torch.randn(3, 32, 32, dtype=torch.float64, device=card)
    start = {"x": torch.ones(3, 32, dtype=torch.float64, device=card)}

    def loss(p):
        return torch.einsum("dn,dnm,dm->", p["x"], ops, p["x"])

    before = torch.cuda.memory_allocated(card)
    for _ in range(3):
        out = tinit.adam_minimize(loss, start, 0.01, 2 * K + 3, graph=True)
        del out
        assert torch.cuda.memory_allocated(card) <= before

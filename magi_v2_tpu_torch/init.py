"""Initialization of theta (and unobserved trajectories) before sampling
(counterpart of magi_v2_tpu/init.py), both branches:

- fully observed: minimize the manifold-constraint term t2 over theta with
  X fixed at the interpolated trajectories;
- partially observed: point-estimate (X_unobs, theta) jointly by gradient
  matching against central differences on the uniform grid, from several
  starts, the winner chosen by the observed-manifold score.

Theta goes through softplus (theta > 0, the sampler's support); Adam with
eps=1e-7 (the JAX package's optax settings) minimizes, on a card from CUDA
graphs of whole steps (``adam_minimize``'s graph path).
"""

from __future__ import annotations

import gc
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from magi_v2_tpu_torch.utils.profiling import untimed


# Adam steps a CUDA graph of the graph path holds: its capture, and the
# steps that fill no chunk, cost about as much host time as this many eager
# steps, and a replay one launch; on the H100 the theta start's 10,000
# steps take the same time from 5 to 16 a chunk, longer from 25 up
# (PERF.md, §6)
GRAPH_CHUNK = 10
# eager steps before the capture: the first run of every launch (cuBLAS's
# workspace on the capture stream, the caching allocator's blocks)
GRAPH_WARMUP = 1


def adam_minimize(loss_fn, params: dict, learning_rate: float, num_iters: int,
                  timer=untimed, *, graph: bool = False):
    """``num_iters`` Adam steps (eps=1e-7, the update of
    ``optax.adam(lr, eps=1e-7)``) on a dict of tensors; returns
    (params, losses (num_iters, ...) tensor). ``loss_fn`` may return a
    tensor of independent losses (one per start of a batch whose starts
    share no parameter): Adam minimizes their sum, which, Adam being
    elementwise, is each start's own Adam, and each is recorded. The loop
    reads nothing back from the device. Each step taken adds one to
    ``timer``'s counter "adam_steps" (``utils.profiling.PhaseTimer``).

    With ``graph``, for a ``loss_fn`` of tensor operations alone that
    reads nothing back from the device, parameters on a card take the
    graph path (``_adam_replayed``): chunks of ``GRAPH_CHUNK`` steps
    replayed from one CUDA graph, each replayed step also counted in
    "adam_graph_steps". Elsewhere the loop is the eager one below."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    if graph and next(iter(params.values())).device.type == "cuda":
        return _adam_replayed(_AdamStep(loss_fn, params, learning_rate),
                              num_iters, timer)
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate, eps=1e-7)
    losses = None
    for i in range(num_iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.sum().backward()
        opt.step()
        timer.count("adam_steps")
        if losses is None:
            losses = loss.new_empty((num_iters,) + loss.shape)
        losses[i] = loss.detach()
    return {k: v.detach() for k, v in params.items()}, losses


class _AdamStep:
    """One step of the graph path, as tensor operations alone: the loss,
    its gradient (``torch.autograd.grad``, no ``.grad`` kept) and Adam's
    update (``torch.optim.Adam``'s, eps 1e-7) of ``params`` in place, with
    the moments and the step count held on the parameters' device. Calling
    it returns the step's loss, detached."""

    def __init__(self, loss_fn, params: dict, learning_rate: float):
        self.loss_fn, self.params, self.lr = loss_fn, params, learning_rate
        self.leaves = list(params.values())
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.t = torch.zeros((), dtype=torch.float64,
                             device=self.leaves[0].device)

    def __call__(self) -> torch.Tensor:
        b1, b2, eps = 0.9, 0.999, 1e-7
        loss = self.loss_fn(self.params)
        grads = torch.autograd.grad(loss.sum(), self.leaves)
        with torch.no_grad():
            self.t.add_(1.0)
            step = self.lr / (1.0 - torch.pow(b1, self.t))
            bc2_sqrt = torch.sqrt(1.0 - torch.pow(b2, self.t))
            for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
                m.lerp_(g, 1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v.sqrt() / bc2_sqrt).add_(eps)
                p.sub_(step * (m / denom))
        return loss.detach()


def graph_plan(num_iters: int) -> tuple[int, int, int]:
    """(warm-up steps, replays, remainder) of the graph path for
    ``num_iters`` steps: ``GRAPH_WARMUP`` eager steps (fewer if there are
    fewer steps), then replays of ``GRAPH_CHUNK`` steps, then the steps
    that fill no chunk, eager (cheaper than a second capture, whose host
    cost is that of as many eager steps)."""
    warm = min(GRAPH_WARMUP, num_iters)
    replays, rest = divmod(num_iters - warm, GRAPH_CHUNK)
    return warm, replays, rest


def _adam_replayed(step: _AdamStep, num_iters: int, timer):
    """``num_iters`` calls of ``step`` on the card, as ``graph_plan``
    divides them: the warm-up on a side stream, the capture of
    ``GRAPH_CHUNK`` steps on it (each step's loss into a static buffer,
    Python's collector held off, as ``sampler/hmc.py:capture_steps``
    does), replays on the current stream with one copy of the buffer into
    ``losses`` each, then the remainder. The graph, its memory pool and
    the cuBLAS workspaces are released before it returns."""
    warm, replays, rest = graph_plan(num_iters)
    device = step.t.device
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        first = [step() for _ in range(warm)]
    current.wait_stream(side)
    timer.count("adam_steps", warm)
    losses = None
    if first:
        losses = first[0].new_empty((num_iters,) + first[0].shape)
        losses[:warm] = torch.stack(first)
    done = warm
    if replays:
        buf = losses.new_empty((GRAPH_CHUNK,) + losses.shape[1:])
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                for j in range(GRAPH_CHUNK):
                    buf[j] = step()
        finally:
            if collecting:
                gc.enable()
        try:
            for _ in range(replays):
                graph.replay()
                losses[done:done + GRAPH_CHUNK] = buf
                done += GRAPH_CHUNK
                timer.count("adam_steps", GRAPH_CHUNK)
                timer.count("adam_graph_steps", GRAPH_CHUNK)
        finally:
            graph.reset()
    for i in range(done, done + rest):
        losses[i] = step()
        timer.count("adam_steps")
    # PyTorch keeps a cuBLAS workspace (32 MiB on the H100) for each handle
    # and stream it ran on, the side stream's included, for the process's
    # life: a new side stream each call would keep 64 MiB more each time.
    # Cleared as PyTorch's own CUDA graph trees do, after the steps: a
    # freed workspace's next user on its stream is ordered after them.
    side.wait_stream(current)
    torch._C._cuda_clearCublasWorkspaces()
    return {k: v.detach() for k, v in step.params.items()}, losses


def fit_theta_fully_observed(
    f_vec: Callable,
    I,
    Xhat_init,
    mu_ds,
    m_ds,
    K_invs,
    D_thetas: int,
    learning_rate: float = 0.01,
    num_iters: int = 10000,
    timer=untimed,
):
    """theta MAP with X fixed: minimizes
    sum_d ||f_d(I, Xhat, theta) - m_d (x_d - mu_d)||^2_{K_d^{-1}}.
    Tensor inputs (float64, on the device to run on); returns
    (thetas, losses) as host NumPy arrays like the JAX version; Adam's
    steps are counted in ``timer``."""
    X_cent = (Xhat_init - mu_ds[None, :]).T                     # (D, N)
    m_prod = torch.einsum("dnm,dm->dn", m_ds, X_cent)

    def loss(p):
        resid = f_vec(I, Xhat_init, F.softplus(p["th"])).T - m_prod
        return torch.einsum("dn,dnm,dm->", resid, K_invs, resid)

    theta0 = torch.full((D_thetas,), math.log(math.expm1(1.0)),
                        dtype=Xhat_init.dtype, device=Xhat_init.device)
    p, losses = adam_minimize(loss, {"th": theta0}, learning_rate, num_iters,
                              timer, graph=True)
    return F.softplus(p["th"]).cpu().numpy(), losses.cpu().numpy()


def gradient_matching_starts(num_starts: int, N_I: int, D_unobserved: int,
                             D_thetas: int, X_obs_smoothed, seed: int = 0):
    """The starts of ``fit_unobserved_gradient_matching``: X_unobs0
    (num_starts, N_I, D_unobserved) from the observed components' moments
    and theta_pre0 (num_starts, D_thetas), start 0 at theta = ones, the
    rest wide normals; drawn from a ``torch.Generator`` seeded by ``seed``
    on the CPU (the JAX package draws from ``PRNGKey(seed)``: the same
    distributions, other numbers)."""
    X = np.asarray(X_obs_smoothed.cpu() if isinstance(X_obs_smoothed,
                                                      torch.Tensor)
                   else X_obs_smoothed, np.float64)
    mu_init = float(X.mean())
    sd_init = float(np.sqrt((X.std(axis=0) ** 2).mean()))
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    X_unobs0 = mu_init + sd_init * torch.randn(
        (num_starts, N_I, D_unobserved), generator=g, dtype=f64)
    th_pre0 = torch.cat([
        torch.full((1, D_thetas), math.log(math.expm1(1.0)), dtype=f64),
        1.5 * torch.randn((num_starts - 1, D_thetas), generator=g, dtype=f64),
    ])
    return X_unobs0, th_pre0


def run_gradient_matching(f_vec, I, X_obs_smoothed, proper_order, X_unobs0,
                          th_pre0, learning_rate: float, num_iters: int,
                          observed_components=None, m_ds_obs=None,
                          K_invs_obs=None, mu_obs=None, timer=untimed):
    """Every start of the gradient-matching fit at once, on a leading
    axis: one Adam over the stacked (X_unobs, theta_pre) with the losses
    summed over starts. Returns (X_unobs (S, N, D_unobs), thetas (S, P),
    losses (num_iters, S), scores (S,)) as tensors; a start's score is its
    observed-manifold score sum_d ||f_d - m_d (x_d - mu_d)||^2_{K_d^{-1}}
    over the observed components when their operators are given, else its
    final gradient-matching loss. Adam's steps are counted in ``timer``."""
    dev, dt = X_obs_smoothed.device, X_obs_smoothed.dtype
    order = torch.as_tensor(np.asarray(proper_order), dtype=torch.long,
                            device=dev)
    h = I[1, 0] - I[0, 0]

    def x_full_of(X_unobs):
        X_obs = X_obs_smoothed.expand(X_unobs.shape[:1]
                                      + X_obs_smoothed.shape)
        return torch.cat([X_obs, X_unobs], dim=-1)[..., order]

    def loss(p):
        X_full = x_full_of(p["X_unobs"])
        f_vals = f_vec(I, X_full, F.softplus(p["th_pre"]))
        f_diff = (X_full[:, 2:, :] - X_full[:, :-2, :]) / (2.0 * h)
        return torch.sum((f_vals[:, 1:-1] - f_diff) ** 2, dim=(1, 2))

    start = {"X_unobs": X_unobs0.to(device=dev, dtype=dt),
             "th_pre": th_pre0.to(device=dev, dtype=dt)}
    p, losses = adam_minimize(loss, start, learning_rate, num_iters, timer,
                              graph=True)
    with torch.no_grad():
        if m_ds_obs is not None and K_invs_obs is not None \
                and mu_obs is not None and observed_components is not None:
            cols = torch.as_tensor(np.asarray(observed_components),
                                   dtype=torch.long, device=dev)
            m_prod = torch.einsum("dnm,dm->dn", m_ds_obs,
                                  (X_obs_smoothed - mu_obs[None, :]).T)
            X_full = x_full_of(p["X_unobs"])
            f_vals = f_vec(I, X_full, F.softplus(p["th_pre"]))
            resid = f_vals[..., cols].transpose(1, 2) - m_prod
            scores = torch.einsum("sdn,dnm,sdm->s", resid, K_invs_obs, resid)
        else:
            scores = loss(p)
    return p["X_unobs"], F.softplus(p["th_pre"]), losses, scores


def fit_unobserved_gradient_matching(
    f_vec: Callable,
    I,
    X_obs_smoothed,
    proper_order,
    D_unobserved: int,
    D_thetas: int,
    seed: int = 0,
    learning_rate: float = 0.01,
    num_iters: int = 10000,
    num_starts: int = 8,
    observed_components=None,
    m_ds_obs=None,
    K_invs_obs=None,
    mu_obs=None,
    starts=None,
    timer=untimed,
):
    """Joint (X_unobs, theta) gradient-matching init of a partially
    observed system (magi_v2_tpu/init.py:fit_unobserved_gradient_matching):
    ``num_starts`` Adam runs on the L2 gap between f(X_full, theta) and the
    central differences of X_full, the observed components fixed at
    ``X_obs_smoothed`` (N_I, D_observed), then the winner by the
    observed-manifold score (with ``observed_components``, ``m_ds_obs``,
    ``K_invs_obs`` (D_obs, N, N) and ``mu_obs``) or else the loss; see the
    JAX function for why. Tensor inputs (float64, on the device to run on);
    ``starts`` (X_unobs0, theta_pre0) replaces the drawn starts
    (``gradient_matching_starts``). Returns (X_unobs (N_I, D_unobserved),
    thetas, losses (num_iters,)) as host NumPy arrays, like the JAX
    version; Adam's steps are counted in ``timer``."""
    if starts is None:
        starts = gradient_matching_starts(num_starts, X_obs_smoothed.shape[0],
                                          D_unobserved, D_thetas,
                                          X_obs_smoothed, seed)
    X_unobs, thetas, losses, scores = run_gradient_matching(
        f_vec, I, X_obs_smoothed, proper_order, *starts,
        learning_rate=learning_rate, num_iters=num_iters,
        observed_components=observed_components, m_ds_obs=m_ds_obs,
        K_invs_obs=K_invs_obs, mu_obs=mu_obs, timer=timer)
    best = int(torch.argmin(scores))
    return (X_unobs[best].cpu().numpy(), thetas[best].cpu().numpy(),
            losses[:, best].cpu().numpy())

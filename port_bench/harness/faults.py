"""Faults planted in the port's timed path, for the check's own tests and
for the readings its limits are set from (``port_bench/control.py``).
Each is a context manager that patches the port at run time and restores
it on exit; nothing of the port's files changes.

- ``stuck``: every transition returns the state it was given;
- ``half``: the second half of the chains keep their state;
- ``altered``: one value of the returned trajectories is moved by 1% of
  its component's largest magnitude where ``predict`` unwhitens them;
- ``unfitted``: the hyperparameter fit's optimizer returns the state it
  was given (its start);
- ``energy``: the target's bound evaluation (the whitening and operator
  GEMMs and K1) returns twice the log-posterior and its gradient, the
  posterior at half the temperature, as a K1 energy fault would;
- ``kick``: every leapfrog update that drifts (K2, and the NUTS leaf
  kernel's close and open) leaves the momenta 1% long.

Hybrid storage only (``for_storage``), where predict evaluates the
target through the exact operators:

- ``truncated``: the operators (C^{-1}, m, K^{-1}) band-truncated at the
  model's bandsize, as dense storage holds them;
- ``truncated_k``: K^{-1} alone band-truncated, the operator whose square
  root S the check takes as the program's state.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _transitions(keep_from):
    """Both bound transitions, each returning ``q_new`` with the chains
    from ``keep_from(C)`` on replaced by their incoming state."""
    from magi_v2_tpu_torch.sampler.hmc import BoundTransition
    from magi_v2_tpu_torch.sampler.nuts import BoundNuts

    def make(orig):
        def call(obj, q, *args, **kwargs):
            q_new, info = orig(obj, q, *args, **kwargs)
            q_new = q_new.clone()
            start = keep_from(q.shape[0])
            q_new[start:] = q[start:]
            return q_new, info
        return call

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(BoundTransition, "__call__", make))
    stack.enter_context(_patched(BoundNuts, "__call__", make))
    return stack


@contextlib.contextmanager
def stuck():
    with _transitions(lambda C: 0):
        yield


@contextlib.contextmanager
def half():
    with _transitions(lambda C: C // 2):
        yield


@contextlib.contextmanager
def altered():
    from magi_v2_tpu_torch import api

    def make(orig):
        def unwhiten(mode, Z, mu_ds, *args, **kwargs):
            X = orig(mode, Z, mu_ds, *args, **kwargs)
            T = X.shape[0]
            X[T // 2, 0, X.shape[2] // 2, 0] += 0.01 * X[..., 0].abs().max()
            return X
        return unwhiten

    with _patched(api, "unwhiten_draws", make):
        yield


@contextlib.contextmanager
def unfitted():
    from magi_v2_tpu_torch import hparams

    def lbfgs(orig):
        def minimize(fun, x0, *args, **kwargs):
            res = orig(fun, x0, *args, **kwargs)
            return res._replace(params=x0)
        return minimize

    def adam(orig):
        def minimize(fun, params, *args, **kwargs):
            return params, orig(fun, params, *args, **kwargs)[1]
        return minimize

    with _patched(hparams, "lbfgs_minimize", lbfgs), \
            _patched(hparams, "adam_minimize", adam):
        yield


@contextlib.contextmanager
def energy():
    from magi_v2_tpu_torch.sampler.precond import GNTarget

    def make(orig):
        def bind(target, q, beta_temp, lp, grad):
            evaluate = orig(target, q, beta_temp, lp, grad)

            def doubled():
                evaluate()
                lp.mul_(2.0)
                grad.mul_(2.0)
            return doubled
        return bind

    with _patched(GNTarget, "bind", make):
        yield


@contextlib.contextmanager
def kick():
    from magi_v2_tpu_torch.sampler import hmc, nuts

    def long(launch, p):
        def run(stream):
            launch(stream)
            p.mul_(1.01)
        return run

    def leapfrog(orig):
        def bind(q, p, g, step_size, inv_mass, nkick, drift, *args, **kw):
            launch = orig(q, p, g, step_size, inv_mass, nkick, drift, *args,
                          **kw)
            return long(launch, p) if drift else launch
        return bind

    def leaf(orig):
        def bind(q, p, *args, **kwargs):
            return long(orig(q, p, *args, **kwargs), p)
        return bind

    with _patched(hmc, "bind_leapfrog", leapfrog), \
            _patched(nuts, "bind_leapfrog", leapfrog), \
            _patched(nuts, "bind_nuts_leaf", leaf):
        yield


def _banded_exact_operators(which):
    """``MAGI_v2._exact_operators`` with the operators ``which`` (indices
    into (C^{-1}, m, K^{-1})) zeroed beyond the model's bandsize."""
    from magi_v2_tpu_torch import MAGI_v2

    def make(orig):
        def operators(model):
            out = list(orig(model))
            i = np.arange(out[0].shape[-1])
            off = np.abs(i[:, None] - i[None, :]) > model.BANDSIZE
            for k in which:
                out[k] = np.where(off, 0.0, out[k])
            return tuple(out)
        return operators

    return _patched(MAGI_v2, "_exact_operators", make)


def truncated():
    return _banded_exact_operators((0, 1, 2))


def truncated_k():
    return _banded_exact_operators((2,))


FAULTS = {"stuck": stuck, "half": half, "altered": altered,
          "unfitted": unfitted, "energy": energy, "kick": kick}
HYBRID_FAULTS = {"truncated": truncated, "truncated_k": truncated_k}


def for_storage(storage: str) -> dict:
    """The faults a cell of that storage can have."""
    return dict(FAULTS, **(HYBRID_FAULTS if storage == "hybrid" else {}))

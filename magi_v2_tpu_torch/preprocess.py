"""Data preprocessing (a copy of magi_v2_tpu.preprocess, which cannot be
imported without jax): grid discretization, NaN bookkeeping, interpolation,
cross-validated cubic-spline smoothing.

These are one-time host-side setup steps (the reference also runs them on the
host: _discretize at magi_v2.py:475-498, _linear_interpolate at
magi_v2.py:509-527, cv_cubic_smoother at magi_v2.py:695-770). They produce the
static arrays that the device compute path consumes: the discretization
grid I, the NaN-free index bookkeeping for the observation likelihood, and
smoothed initial trajectories.

Deviation from the reference (documented in DEVIATIONS.md): the reference's
spline smoother computes the CV-optimal knot count (magi_v2.py:747) but then
accidentally fits with the *last* loop value and duplicates the fit block
verbatim (magi_v2.py:749-767). We implement the intent: fit with the
CV-optimal knot count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.interpolate import splev, splrep


def discretize(ts_obs: np.ndarray, X_obs: np.ndarray, discretization: int):
    """Insert 2^discretization - 1 evenly spaced points between consecutive
    observations.

    Returns ``(I, X_obs_discret)`` where I has shape (N_I, 1) with
    N_I = 2^disc * (N - 1) + 1, and X_obs_discret is NaN everywhere except at
    the original observation rows. Mirrors reference _discretize
    (magi_v2.py:475-498).
    """
    ts_obs = np.asarray(ts_obs).flatten()
    X_obs = np.asarray(X_obs)
    if ts_obs.shape[0] != X_obs.shape[0]:
        raise ValueError(
            "ts_obs and X_obs must have equal numbers of observations "
            f"(got {ts_obs.shape[0]} vs {X_obs.shape[0]})"
        )
    N, D = X_obs.shape
    stride = 2 ** discretization
    N_I = stride * (N - 1) + 1

    I = np.full((N_I,), np.nan)
    I[::stride] = ts_obs
    idx = np.arange(N_I)
    I = np.interp(idx, idx[~np.isnan(I)], I[~np.isnan(I)])

    X_obs_discret = np.full((N_I, D), np.nan)
    X_obs_discret[::stride] = X_obs
    return I.reshape(-1, 1), X_obs_discret


def linear_interpolate(X_partial: np.ndarray) -> np.ndarray:
    """Fill NaNs column-wise by linear interpolation over the row index.

    Columns that are entirely NaN stay entirely NaN. Mirrors reference
    _linear_interpolate (magi_v2.py:509-527).
    """
    X_partial = np.asarray(X_partial)
    X_interp = X_partial.copy()
    idx = np.arange(X_partial.shape[0])
    for d in range(X_partial.shape[1]):
        col = X_partial[:, d]
        mask = ~np.isnan(col)
        if mask.any() and not mask.all():
            X_interp[:, d] = np.interp(idx, idx[mask], col[mask])
    return X_interp


@dataclasses.dataclass(frozen=True)
class ObservationIndex:
    """Static-shape NaN bookkeeping for the observation likelihood.

    The batched log-posterior does not boolean-mask per call, so we
    precompute the flat indices of the observed (non-NaN) entries of
    X_obs_discret, their component (column) ids, and their values — the same
    trick as the reference (magi_v2.py:91-100, consumed at
    magi_v2.py:343-345).
    """

    not_nan_idxs: np.ndarray   # (M,) flat indices into X.ravel()
    not_nan_cols: np.ndarray   # (M,) component id of each entry
    y_observed: np.ndarray     # (M,) observed values
    N_ds: np.ndarray           # (D,) per-component observation counts


def build_observation_index(X_obs_discret: np.ndarray) -> ObservationIndex:
    X = np.asarray(X_obs_discret)
    D = X.shape[1]
    flat = X.ravel()
    not_nan_idxs = np.where(~np.isnan(flat))[0]
    not_nan_cols = not_nan_idxs % D
    return ObservationIndex(
        not_nan_idxs=not_nan_idxs,
        not_nan_cols=not_nan_cols,
        y_observed=flat[not_nan_idxs],
        N_ds=(~np.isnan(X)).sum(axis=0),
    )


def _kfold_indices(n: int, n_splits: int, seed: int = 1):
    """Shuffled K-fold split indices (sklearn KFold(shuffle=True) semantics,
    reference magi_v2.py:715)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    fold_sizes = np.full(n_splits, n // n_splits)
    fold_sizes[: n % n_splits] += 1
    folds = []
    start = 0
    for size in fold_sizes:
        val = perm[start : start + size]
        train = np.concatenate([perm[:start], perm[start + size :]])
        folds.append((np.sort(train), np.sort(val)))
        start += size
    return folds


def single_cv_cubic_smoother(
    I: np.ndarray,
    x: np.ndarray,
    n_splits: int = 5,
    obs_per_knot: int = 10,
    min_points: int = 10,
    seed: int = 1,
) -> np.ndarray:
    """Smooth one trajectory with a cubic spline; knot count chosen by K-fold
    CV over 0..N//obs_per_knot interior knots.

    Reference: single_cv_cubic_smoother (magi_v2.py:707-770), with the
    knot-selection bug fixed by intent (uses the CV-optimal count).
    """
    I = np.asarray(I).flatten()
    x = np.asarray(x)
    if I.shape[0] < min_points:
        return x

    knot_nums = np.arange(0, I.shape[0] // obs_per_knot + 1)

    def knots_for(num):
        if num == 0:
            return np.array([])
        return np.linspace(I[0], I[-1], num + 2)[1:-1]

    split_errs = []
    for train_idx, val_idx in _kfold_indices(I.shape[0], n_splits, seed):
        knot_errs = []
        for knot_num in knot_nums:
            try:
                tck = splrep(I[train_idx], x[train_idx], t=knots_for(knot_num), s=0)
                preds = splev(I[val_idx], tck)
                err = float(np.mean((preds - x[val_idx]) ** 2))
            except Exception:
                err = np.inf  # too many knots for this fold's training points
            knot_errs.append(err)
        split_errs.append(knot_errs)

    optimal_knot_num = knot_nums[np.asarray(split_errs).mean(axis=0).argmin()]
    tck = splrep(I, x, t=knots_for(optimal_knot_num), s=0)
    return splev(I, tck)


def cv_cubic_smoother(
    I: np.ndarray,
    X_filled: np.ndarray,
    n_splits: int = 5,
    obs_per_knot: int = 10,
    min_points: int = 10,
    seed: int = 1,
) -> np.ndarray:
    """Column-wise CV cubic-spline smoothing (reference magi_v2.py:695-703)."""
    I = np.asarray(I).flatten()
    X_filled = np.asarray(X_filled)
    if I.shape[0] < min_points:
        return X_filled
    return np.stack(
        [
            single_cv_cubic_smoother(
                I, X_filled[:, d], n_splits, obs_per_knot, min_points, seed
            )
            for d in range(X_filled.shape[1])
        ],
        axis=1,
    )

"""Fitted state and results on disk, in the JAX package's format
(counterpart of magi_v2_tpu/utils/checkpoint.py).

``save_fit`` writes, and ``load_fit`` reads, the NPZ of FIT_FIELDS plus
``_meta`` (D_thetas, bandsize or -1) that both packages read and write;
``from_fit_arrays`` builds a fitted port model from a dict of the same
arrays (e.g. taken from a fitted JAX model). Either way the port samples
the same posterior, from the same operators, as the model the arrays came
from. ``save_results``/``load_results`` keep a predict() results dict with
its nested dicts flattened to "kernel_results.<key>" (and
"timings.<key>"), None entries omitted; the trace of a profiled call
(``timings["trace"]``) describes the run, not its result, and is not
kept.
"""

from __future__ import annotations

import numpy as np

FIT_FIELDS = (
    "I",
    "X_obs_discret",
    "phi1s",
    "phi2s",
    "sigma_sqs_init",
    "Xhat_init",
    "thetas_init",
    "mu_ds",
    "C_d_invs",
    "m_ds",
    "K_d_invs",
    "X_interp_obs",
    "ts_obs",
    "X_obs",
)


def from_fit_arrays(arrays: dict, f_vec, D_thetas: int, bandsize=None,
                    config=None, exact_operators=None):
    """A fitted port MAGI_v2 from the arrays of FIT_FIELDS (host NumPy);
    ready to predict. With a bandsize, ``C_d_invs``/``m_ds``/``K_d_invs``
    are the band-truncated operators; storage="hybrid" rebuilds the exact
    ones from (I, phi1s, phi2s), or takes ``exact_operators`` (C^{-1}, m,
    K^{-1}) as given, e.g. the fitting model's own, so that both samplers
    see the same operators."""
    from magi_v2_tpu_torch import preprocess
    from magi_v2_tpu_torch.api import MAGI_v2
    from magi_v2_tpu_torch.config import DEFAULT_CONFIG

    model = MAGI_v2(
        D_thetas=D_thetas,
        ts_obs=arrays["ts_obs"],
        X_obs=arrays["X_obs"],
        bandsize=bandsize,
        f_vec=f_vec,
        config=config or DEFAULT_CONFIG,
    )
    for f in FIT_FIELDS:
        if f in arrays and f not in ("ts_obs", "X_obs"):
            setattr(model, f, np.array(arrays[f], copy=True))
    model.mag_I = model.I.shape[0]
    model.beta = (model.D * model.mag_I) / model.N_ds.sum()
    model.obs_index = preprocess.build_observation_index(model.X_obs_discret)
    if exact_operators is not None:
        key = (model.phi1s.tobytes(), model.phi2s.tobytes(),
               model.I.tobytes())
        model._exact_ops_cache = (key, tuple(
            np.array(a, np.float64, copy=True) for a in exact_operators))
    return model


def save_fit(model, path: str) -> None:
    """Persist everything initial_fit computed, plus the constructor's
    data, compressed."""
    arrays = {f: np.asarray(getattr(model, f)) for f in FIT_FIELDS
              if getattr(model, f, None) is not None}
    arrays["_meta"] = np.array(
        [model.D_thetas, -1 if model.BANDSIZE is None else model.BANDSIZE],
        dtype=np.int64,
    )
    np.savez_compressed(path, **arrays)


def load_fit(path: str, f_vec, config=None):
    """Reconstruct a fitted MAGI_v2 from a ``save_fit`` NPZ (written by
    either package's format); ready to predict."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    D_thetas, bandsize = (int(v) for v in data["_meta"])
    return from_fit_arrays(
        data, f_vec, D_thetas, bandsize=None if bandsize < 0 else bandsize,
        config=config,
    )


# the nested dicts of a results dict, flattened to "<name>.<key>"
_NESTED = ("kernel_results", "timings")


def save_results(results: dict, path: str) -> None:
    """Persist a predict() results dict, compressed; nested dicts are
    flattened and None entries (e.g. tail_inv_mass without a dense tail)
    omitted, as is the trace of a profiled call."""
    arrays = {}
    for k, v in results.items():
        if k in _NESTED and isinstance(v, dict):
            for kk, vv in v.items():
                if vv is not None and not (k == "timings"
                                           and kk == "trace"):
                    arrays[f"{k}.{kk}"] = np.asarray(vv)
        elif v is not None:
            arrays[k] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_results(path: str) -> dict:
    """A results dict from ``save_results``'s NPZ (either package's), with
    ``kernel_results`` (and ``timings`` where saved) nested again."""
    out = {"kernel_results": {}}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            name, _, key = k.partition(".")
            if name in _NESTED and key:
                out.setdefault(name, {})[key] = z[k]
            else:
                out[k] = z[k]
    return out

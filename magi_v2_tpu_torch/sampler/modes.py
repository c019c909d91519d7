"""Sampler coordinate system for MAGI_v2.predict() (counterpart of
magi_v2_tpu/sampler/modes.py, ``reparam="precond"`` with ``storage="dense"``
only): full-state Gauss-Newton whitening z = L^{-1}(x - mu) around a
float64 relative-energy zero point. The map is linear and fixed, so the
posterior over X is the same as in centered coordinates.

The other modes (centered, GP-prior whitened, banded, hybrid), sigma
pinning and user-supplied initial states are ROADMAP.md queue 1 items 9
and 10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class SamplingMode:
    """The fused target and the coordinate maps predict() needs around it.

    - ``logp_grad(q (C, dim), beta_temp) -> (logp (C,), grad (C, dim))``;
    - ``X0`` — initial X-block coordinates (N_I, D) in the sampling dtype;
    - ``factor`` — L, mapping z draws back to trajectories x = mu + L z.
    """

    reparam: str
    storage: str
    logp_grad: Callable
    X0: torch.Tensor
    factor: torch.Tensor


def build_sampling_mode(model, data, reparam: str, storage: str, dtype, R64,
                        S64) -> SamplingMode:
    """Construct the SamplingMode of a fitted port model. ``data`` is the
    PosteriorData predict() built; R64/S64 the float64 clamped square roots
    of C^{-1}/K^{-1} on the model's device."""
    if reparam != "precond" or storage != "dense":
        raise NotImplementedError(
            f"reparam={reparam!r}, storage={storage!r} is not ported; only "
            "reparam='precond' with storage='dense' is (ROADMAP.md queue 1 "
            "items 9 and 10)"
        )
    from magi_v2_tpu_torch.posterior import make_ref_point
    from magi_v2_tpu_torch.sampler.precond import (
        build_gn_whitening,
        make_tempered_logp_grad_gn,
        whiten_X_full,
    )

    dev = model.config.torch_device
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    L64, L_inv64 = build_gn_whitening(model, R64, S64)
    ref = make_ref_point(
        model.I, model.Xhat_init, model.mu_ds, model.thetas_init,
        model.f_vec, R64, S64, model.m_ds, dtype, device=dev,
    )
    z064 = whiten_X_full(f64(model.Xhat_init), f64(model.mu_ds), L_inv64)
    L = L64.to(dtype)
    logp_grad = make_tempered_logp_grad_gn(
        data, model.f_vec, L, model.mag_I, model.D, model.D_thetas,
        ref=ref, z0=z064.reshape(-1).to(dtype),
    )
    return SamplingMode(reparam=reparam, storage=storage, logp_grad=logp_grad,
                        X0=z064.to(dtype), factor=L)


def unwhiten_draws(mode: SamplingMode, Z, mu_ds, max_bytes: int = 1 << 30):
    """Trajectories X = mu + L z from z draws Z (T, C, N_I, D), as one
    batched GEMM per chunk of draws, the chunk bounded by ``max_bytes`` of
    output."""
    T = Z.shape[0]
    per_draw = max(1, Z[0].numel() * Z.element_size())
    chunk = max(1, max_bytes // per_draw)
    L = mode.factor
    out = torch.empty_like(Z)
    for i in range(0, T, chunk):
        z = Z[i: i + chunk]
        flat = z.reshape(z.shape[:2] + (-1,))
        out[i: i + chunk] = (flat @ L.T).reshape(z.shape) + mu_ds
    return out

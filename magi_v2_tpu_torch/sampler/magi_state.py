"""Flat-vector packing of the MAGI sampler state (counterpart of
magi_v2_tpu/sampler/magi_state.py): (X (N_I, D), sigma_sqs_pre (D,),
thetas_pre (D_thetas,)) in that order. Leading batch axes pass through."""

from __future__ import annotations

import torch


def flatten_state(X, sigma_sqs_pre, thetas_pre):
    lead = X.shape[:-2]
    return torch.cat([X.reshape(lead + (-1,)), sigma_sqs_pre, thetas_pre],
                     dim=-1)


def unflatten_state(q, N_I: int, D: int, D_thetas: int):
    X = q[..., : N_I * D].reshape(q.shape[:-1] + (N_I, D))
    return X, q[..., N_I * D: N_I * D + D], q[..., N_I * D + D:]


def unflatten_samples(samples, N_I: int, D: int, D_thetas: int):
    """(T, C, dim) -> (X (T,C,N_I,D), sigma_pre (T,C,D), theta_pre (T,C,Dθ))."""
    T, C = samples.shape[:2]
    X = samples[..., : N_I * D].reshape(T, C, N_I, D)
    return X, samples[..., N_I * D: N_I * D + D], samples[..., N_I * D + D:]

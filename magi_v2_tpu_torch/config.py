"""Configuration for magi_v2_tpu_torch (counterpart of magi_v2_tpu/config.py).

Same tunables and defaults as the JAX package's ``MagiConfig``, plus the
device the whole pipeline runs on. The JAX package's ``setup_on_cpu``
(scoped x64 on the host CPU backend) has no counterpart: setup runs in
float64 on ``device`` itself, sampling in ``dtype``. The sampler's own
knobs, among them the JAX package's ``hmc_jitter`` and
``stage_above_bytes``, are ``SamplerConfig``'s (sampler/run.py), as
there.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MagiConfig:
    """All tunables of the MAGI pipeline in one place.

    Defaults replicate the reference's hard-coded values; see
    magi_v2_tpu/config.py for the citation of each.
    """

    matern_nu: float = 2.01

    # --- hyperparameter MLE ---
    hparam_learning_rate: float = 0.01
    hparam_num_iters: int = 1000
    # "adam" (the reference's Adam x 1000) or "lbfgs" (ops/lbfgs.py)
    hparam_optimizer: str = "adam"
    # "obs" (raw observations at observation times) or "grid"
    hparam_fit_points: str = "obs"

    # --- theta initialization ---
    init_learning_rate: float = 0.01
    init_num_iters: int = 10000

    # --- sampler ---
    initial_step_size: float = 0.1
    target_accept: float = 0.75
    adaptation_fraction: float = 0.8
    max_tree_depth: int = 10
    anneal_min_temp: float = 0.1
    adapt_mass_matrix: bool = True

    # --- numerics and placement ---
    # Sampling dtype. Setup (hyperparameters, operators, whitening) always
    # runs in float64 on ``device``.
    dtype: torch.dtype = torch.float64
    # Device for setup and sampling: the card unless the caller asks for
    # another ("cpu", "cuda:1"). Nothing in the package probes for a card
    # or falls back to the CPU: without one, the first tensor placed on
    # "cuda" raises PyTorch's own error.
    device: str = "cuda"
    cholesky_jitter: float = 1e-6

    # --- preprocessing ---
    spline_cv_folds: int = 5
    spline_obs_per_knot: int = 10
    spline_min_points: int = 10

    sigma_sq_lb_scale: float = 0.01

    def replace(self, **kwargs) -> "MagiConfig":
        return dataclasses.replace(self, **kwargs)

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)


DEFAULT_CONFIG = MagiConfig()

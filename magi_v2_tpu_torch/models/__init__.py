"""ODE model library in PyTorch: the JAX package's eight fields."""

from magi_v2_tpu_torch.models.odes import (
    MODEL_REGISTRY,
    OdeModel,
    cuda_model_of,
    fitzhugh_nagumo_f_vec,
    hes1_f_vec,
    hes1_log_f_vec,
    lorenz_f_vec,
    lotka_volterra_f_vec,
    protein_transduction_f_vec,
    seir_f_vec,
    sirw_f_vec,
)

__all__ = [
    "MODEL_REGISTRY",
    "OdeModel",
    "cuda_model_of",
    "fitzhugh_nagumo_f_vec",
    "hes1_f_vec",
    "hes1_log_f_vec",
    "lorenz_f_vec",
    "lotka_volterra_f_vec",
    "protein_transduction_f_vec",
    "seir_f_vec",
    "sirw_f_vec",
]

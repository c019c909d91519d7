"""ODE model library in PyTorch. SEIR and Lorenz are ported so far."""

from magi_v2_tpu_torch.models.odes import (
    MODEL_REGISTRY,
    OdeModel,
    cuda_model_of,
    lorenz_f_vec,
    seir_f_vec,
)

__all__ = ["MODEL_REGISTRY", "OdeModel", "cuda_model_of", "lorenz_f_vec",
           "seir_f_vec"]

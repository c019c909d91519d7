from magi_v2_tpu_torch.utils.checkpoint import from_fit_arrays, load_fit
from magi_v2_tpu_torch.utils.data import simulate_ode
from magi_v2_tpu_torch.utils.diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
    summarize_chains,
)

__all__ = [
    "effective_sample_size",
    "from_fit_arrays",
    "load_fit",
    "potential_scale_reduction",
    "simulate_ode",
    "summarize_chains",
]

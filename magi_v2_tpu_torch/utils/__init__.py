from magi_v2_tpu_torch.utils.diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
    summarize_chains,
)
from magi_v2_tpu_torch.utils.data import load_seir_csv, simulate_ode
from magi_v2_tpu_torch.utils.profiling import (
    PhaseTimer,
    device_trace,
    sampler_report,
)
from magi_v2_tpu_torch.utils.checkpoint import (
    from_fit_arrays,
    load_fit,
    load_results,
    save_fit,
    save_results,
)

__all__ = [
    "effective_sample_size",
    "potential_scale_reduction",
    "summarize_chains",
    "load_seir_csv",
    "simulate_ode",
    "PhaseTimer",
    "device_trace",
    "sampler_report",
    "save_fit",
    "load_fit",
    "save_results",
    "load_results",
    "from_fit_arrays",
]

"""Multi-chain NUTS and HMC for MAGI: the fused GN-whitened target, the
dense mass, dual-averaging and Welford warmup, and the temperature
schedule."""

from magi_v2_tpu_torch.sampler.run import (
    SamplerConfig,
    log_temperature_schedule,
    run_chains,
)

__all__ = ["SamplerConfig", "log_temperature_schedule", "run_chains"]

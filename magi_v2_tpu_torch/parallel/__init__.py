from magi_v2_tpu_torch.parallel.mesh import (
    chain_mesh,
    run_chains_sharded,
    shard_chain_states,
)

__all__ = ["chain_mesh", "shard_chain_states", "run_chains_sharded"]

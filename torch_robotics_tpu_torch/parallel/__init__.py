from .mesh import (chomp_solve_sharded, ilqr_solve_sharded, make_mesh,
                   mpc_rollout_sharded, multihost_init, replicate,
                   sgpmp_solve_sharded, shard_batch, shard_batch_padded,
                   solve_sharded)

__all__ = ["make_mesh", "shard_batch", "shard_batch_padded", "replicate",
           "multihost_init", "solve_sharded", "mpc_rollout_sharded",
           "ilqr_solve_sharded", "sgpmp_solve_sharded",
           "chomp_solve_sharded"]

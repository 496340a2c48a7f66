from mpctsid_tpu.dist.mesh import (batched_rollout, scenario_mesh,
                                   shard_scenarios, shard_scenarios_multihost,
                                   sharded_cascade_rollout)

__all__ = ["batched_rollout", "scenario_mesh", "shard_scenarios",
           "shard_scenarios_multihost", "sharded_cascade_rollout"]

"""Multi-device rendering in one process (a mesh of torch devices), and
fault tolerance for serving and training.

    sharding — `Mesh` ((data, model) array of `torch.device`s, repeats
               allowed: `[torch.device("cuda:0")] * 4` is four virtual
               shards on one card), the logical-axis rules rendering uses
               (`resolve`), and the active-mesh stack (`use_mesh`)
    fault    — checkpoint/restart for training (`FaultConfig`,
               `FaultManager`), shard-drop recovery for tile-sharded serving
               (`render_with_shard_recovery`, `ShardDropInjector`) and the
               step-time `StragglerMonitor`

One controller drives every device, as the reference's single-controller
`shard_map` does: shard k's work is issued on its device and the gather is
`.to(primary)` followed by `torch.cat`. No process group is involved.
"""
from repro_torch.distributed.sharding import (Mesh, active_mesh, dp_axes,
                                              on_device, resolve, use_mesh)
from repro_torch.distributed.fault import (FaultConfig, FaultManager,
                                           ShardDropInjector,
                                           ShardRecoveryReport,
                                           StragglerMonitor,
                                           render_with_shard_recovery)

__all__ = [
    "Mesh", "active_mesh", "dp_axes", "on_device", "resolve", "use_mesh",
    "FaultConfig", "FaultManager", "ShardDropInjector",
    "ShardRecoveryReport", "StragglerMonitor", "render_with_shard_recovery",
]

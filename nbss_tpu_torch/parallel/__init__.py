from nbss_tpu_torch.parallel.mesh import (
    Mesh,
    Rendezvous,
    Shard,
    current_mesh,
    init_from_env,
    launch,
    make_mesh,
    rendezvous,
    replicate,
    shard_batch,
    shutdown,
)

__all__ = ["Mesh", "Rendezvous", "Shard", "current_mesh", "init_from_env", "launch",
           "make_mesh", "rendezvous", "replicate", "shard_batch", "shutdown"]

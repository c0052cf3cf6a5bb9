from foodrec_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicated,
    shard_batch,
)

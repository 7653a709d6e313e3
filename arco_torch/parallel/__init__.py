from arco_torch.parallel.mesh import (  # noqa: F401
    create_mesh, replicate, shard_batch)

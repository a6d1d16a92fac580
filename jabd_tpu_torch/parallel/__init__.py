"""Data parallelism of the port: the mesh (`mesh.py`), FSDP under the JAX
package's leaf rule (`fsdp.py`) and a process launcher (`spawn.py`)."""

from jabd_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    make_mesh_for_batch,
    process_mesh,
    replicate_tree,
    shard_batch,
)

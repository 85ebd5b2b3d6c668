"""Scale-out: device meshes, key replication, batch sharding (the
counterpart of cufhe_tpu/parallel). Keys are replicated, the ciphertext
batch is cut into row blocks, one per device, and gate evaluation needs no
collective."""
from .mesh import (DATA_AXIS, DataMesh, Replicated, data_mesh,  # noqa: F401
                   data_parallel, init_distributed, local_rows, replicate,
                   shard_batch, to_device)

"""Parallelism (counterpart of ``jointpose/parallel/``): the process mesh
with data and tensor parallelism (``mesh.py``, ``mrf_tp.py``), spatial
parallelism of the trunk's rows (``spatial.py``), the one-process device
mesh for inference and the two-stage pipelined predictor
(``pipeline.py``)."""

from jointpose_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    DeviceMesh,
    Mesh,
    init_distributed,
    make_device_mesh,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
    shard_state,
)
from jointpose_torch.parallel.spatial import (  # noqa: F401
    gather_rows,
    halo_exchange,
    spatial_image_sharding,
)

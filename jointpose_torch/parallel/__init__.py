"""Parallelism (counterpart of ``jointpose/parallel/``): the process mesh
with data and tensor parallelism (``mesh.py``, ``mrf_tp.py``) and the
two-stage pipelined predictor (``pipeline.py``)."""

from jointpose_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    init_distributed,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_params,
    shard_state,
)

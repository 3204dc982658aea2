"""Data and sequence parallelism (counterpart of the JAX package's
``parallel/``): one process per rank over a ``torch.distributed`` process
group, a ``DeviceMesh`` with the JAX axis names, the collectives with
their gradients (``collectives.py``), a one-step dry run over a
(data, seq) mesh (``dryrun.py``) and the pipeline's packed parameter
layout (``pipeline.py``, for reading pipeline-parallel JAX checkpoints).
Tensor parallelism, FSDP and the pipeline schedule are ROADMAP Queue 1
item 9b."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    batch_spec,
    fsdp_param_specs,
    init_multi_host,
    make_mesh,
    make_seq_mesh,
    mesh_from_config,
    param_specs,
    shard_batch,
    shard_params,
    shard_params_fsdp,
)
from .pipeline import (
    pack_pipeline_params,
    stack_block_params,
    unpack_pipeline_params,
    unstack_block_params,
)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "init_multi_host",
           "make_mesh", "make_seq_mesh", "mesh_from_config", "batch_spec",
           "param_specs", "shard_batch", "shard_params", "fsdp_param_specs",
           "shard_params_fsdp", "pack_pipeline_params",
           "stack_block_params", "unpack_pipeline_params",
           "unstack_block_params"]

"""The device mesh on ``torch.distributed`` (port of ``sisua_tpu/parallel``):
the (data × model) mesh, the world's start (``spawn``, ``init_from_env``)
and the collectives of a mesh step (``functional``)."""

from . import functional
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_sharding, create_mesh,
                   default_backend, device_memory_limit, init_from_env,
                   is_main_rank, param_plan, replicated_sharding,
                   shard_batch, shard_params, spawn)

__all__ = ["create_mesh", "batch_sharding", "replicated_sharding",
           "shard_batch", "shard_params", "DATA_AXIS", "MODEL_AXIS",
           "device_memory_limit", "param_plan", "spawn", "init_from_env",
           "default_backend", "is_main_rank", "functional"]

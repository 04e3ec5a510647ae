"""Tensor and data parallelism over ``torch.distributed`` (port of
``ddm_tpu/parallel``: Megatron TP with DP beside it; ``--sp``, expert
parallelism, ``--pp``, ``--fsdp`` and ``--multihost`` are ROADMAP.md Queue 1
item 11)."""

from .data_parallel import make_sharded_train_step
from .fsdp import clip_grads_by_global_norm_sharded_
from .mesh import Mesh, make_mesh
from .sharding import (
    DIT_TP_RULES,
    gather_full_state_dict,
    gather_state_dicts,
    shard_state_dict,
    spec_for_name,
)
from .tp import tp_region_enter, tp_region_exit

__all__ = [
    "DIT_TP_RULES",
    "Mesh",
    "clip_grads_by_global_norm_sharded_",
    "gather_full_state_dict",
    "gather_state_dicts",
    "make_mesh",
    "make_sharded_train_step",
    "shard_state_dict",
    "spec_for_name",
    "tp_region_enter",
    "tp_region_exit",
]

"""Parallelism: the process mesh, the sharded train step, the
pipeline schedules, LoRA, the distributed bootstrap — the port of
``skypilot_tpu/parallel``.
"""
from skypilot_torch.parallel.mesh import (
    MeshConfig,
    make_mesh,
    auto_mesh_config,
    describe_config,
    replan_mesh_config,
    rescale_global_batch,
)
from skypilot_torch.parallel.train import (
    TrainState,
    build_train_step,
    init_qlora_state,
    init_train_state,
    instrument_train_step,
    plan_train_state,
)
from skypilot_torch.parallel import distributed
from skypilot_torch.parallel import lora
from skypilot_torch.parallel import pipeline

__all__ = [
    'MeshConfig',
    'TrainState',
    'auto_mesh_config',
    'build_train_step',
    'describe_config',
    'distributed',
    'init_qlora_state',
    'init_train_state',
    'instrument_train_step',
    'lora',
    'make_mesh',
    'pipeline',
    'plan_train_state',
    'replan_mesh_config',
    'rescale_global_batch',
]

"""Data parallelism over lanes (counterpart of ``neuralrgbd_tpu/parallel``),
and joining a torchrun launch (``init_distributed``)."""

from neuralrgbd_tpu_torch.parallel.launch import init_distributed
from neuralrgbd_tpu_torch.parallel.mesh import (lane_block, lane_mesh,
                                                make_mesh,
                                                make_sharded_infer_step,
                                                make_sharded_train_step,
                                                mesh_size, replicate,
                                                shard_batch)

__all__ = ["init_distributed", "lane_block", "lane_mesh", "make_mesh",
           "make_sharded_infer_step", "make_sharded_train_step", "mesh_size",
           "replicate", "shard_batch"]

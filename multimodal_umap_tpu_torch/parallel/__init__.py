"""Parallelism: the process mesh, its sharding plan and its collectives."""

from .collectives import collective_summary, recording
from .mesh import Mesh, ShardingPlan, create_mesh, shard_task

__all__ = ["Mesh", "ShardingPlan", "collective_summary", "create_mesh",
           "recording", "shard_task"]

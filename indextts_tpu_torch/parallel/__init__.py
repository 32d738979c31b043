"""Tensor parallelism of the port: the tp=2 mesh, the GPT-2 shard split and
the replicated decode inputs (`mesh.py`)."""

from indextts_tpu_torch.parallel.mesh import Mesh, Replicated, is_tp, make_mesh, shard_gpt2_tp

__all__ = ["Mesh", "Replicated", "is_tp", "make_mesh", "shard_gpt2_tp"]

"""The port's mesh (`mesh.py`): dp x sp x tp ranks over named devices, the
rows and frames each rank holds, the GPT-2 and DiT shard splits and the
replicated decode inputs; and the train step (`train.py`)."""

from indextts_tpu_torch.parallel.mesh import (Mesh, Replicated, batch_sharding, is_tp,
                                              make_mesh, replicated, seq_sharding, shard_dit,
                                              shard_gpt2_tp)

__all__ = ["Mesh", "Replicated", "batch_sharding", "is_tp", "make_mesh", "replicated",
           "seq_sharding", "shard_dit", "shard_gpt2_tp"]

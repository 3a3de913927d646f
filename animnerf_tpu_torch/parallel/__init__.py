"""Data parallelism over processes on ``torch.distributed`` — counterpart
of ``animnerf_tpu/parallel/``: ``mesh.py`` (the mesh, the batch and ray
shards, the collectives, the start-up) and ``train_pjit.py`` (the sharded
training and evaluation steps)."""

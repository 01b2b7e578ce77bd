"""Multi-device rendering: pixel / sample sharding, geometry sharding and
frames over hosts.

One controlling process per host drives every device of a mesh, as JAX's
``shard_map`` does: a ``sharding.Mesh`` is a grid of ``torch.device``s with
named axes, each shard's work runs on its own device from one Python
thread (CUDA launches are asynchronous, so shards on different cards
overlap), and every reduction that JAX writes as ``psum`` / ``pmin`` is an
explicit one on the output device, in shard-index order, so a run repeats
bit for bit. A mesh may name one device more than once (the CPU, or a
machine with one card): the same code then runs its shards one after the
other. ``torch.distributed`` is used only by ``multihost.py``, where the
JAX package uses ``jax.distributed``.
"""

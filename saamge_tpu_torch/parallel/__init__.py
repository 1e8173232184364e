"""Distribution of the port: a one-controller shard mesh (``mesh.py``)
and the x-slab sharded structured solve on it (``structured_sharded.py``,
with its production-regime check in ``checks.py``).

Port of saamge_tpu/parallel/{structured_sharded,checks}.py.  One process
drives every shard, as one JAX controller drives its mesh; nothing here
uses ``torch.distributed``."""

"""Several devices on ``torch.distributed``, one process a device (the
counterpart of the JAX package's ``parallel/``): the launcher
(``launch``), the (data, model) grid of ranks and its splits (``mesh``),
the tensor-parallel pair (``tp``) and the entry hooks with their sharded
workloads (``dryrun``).

Of the JAX package's exports, ``data_mesh`` is ``mesh.data_mesh`` here.
``batch_sharding``, ``replicated`` and ``shard_batch`` build and apply
``jax.sharding`` shardings of one array over a mesh; a rank here holds its
own rows (``mesh.Grid.rows``), so they have no counterpart and nothing is
re-exported."""

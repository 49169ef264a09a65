"""Several devices on ``torch.distributed``, one process a device (the
counterpart of the JAX package's ``parallel/``): the launcher
(``launch``), the (data, model) grid of ranks and its splits (``mesh``),
the tensor-parallel pair (``tp``) and the entry hooks with their sharded
workloads (``dryrun``)."""

"""The multi-GPU layer (``agplace_tpu/parallel``).

JAX runs one controller over ``jax.devices()``.  The port runs one process
per card (``torchrun --nproc_per_node N``), joined in a ``torch.distributed``
process group by ``bootstrap.initialize_distributed``; a mesh's devices are
the group's ranks (``mesh.Mesh``).  ``data`` splits a batch (global BN
moments, the towers' outputs gathered for the global loss, the gradient
all-reduced: ``train/step.py``, ``embed.py``); ``gallery`` splits the
retrieval database (``retrieval/sharded.py``).  Launched without torchrun,
the world is one rank and every flag resolves to single-device, as JAX's on
a one-device host.
"""

"""Parallel training and mesh decode over ``torch.distributed`` — the port
of ``sat_tpu.parallel``.

The JAX package runs one SPMD program over a GSPMD device mesh.  The
port runs one process a mesh position (``torchrun``), and writes the
collectives out:

* ``mesh`` — the launch bootstrap, the device and backend rule, and the
  (data, model) mesh with one process group an axis;
* ``sharding`` — the one placement rule (vocab-sized leaves over
  ``model``), shard a train state (a fresh one or a restored one);
* ``collectives`` — the differentiable reductions, the gradient bucket,
  the host gathers;
* ``data`` — each rank's rows of the global batch;
* ``vocab`` — vocab tensor parallelism (embedding, projection, CE, argmax);
* ``train`` — the mesh decode (the mesh's loss and step are
  ``models.captioner.compute_loss`` and ``train.step.make_train_step``
  with a ``mesh``);
* ``context`` — context parallelism (the distributed-softmax attend).

Importing this package starts nothing: groups are made by ``make_mesh``.
"""

from .mesh import Mesh, initialize_distributed, make_mesh, sync_processes
from .sharding import shard_train_state

__all__ = [
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "sync_processes",
    "shard_train_state",
]

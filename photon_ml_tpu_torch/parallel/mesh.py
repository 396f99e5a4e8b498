"""Axis names of the parallel layouts (counterpart of
``photon_ml_tpu/parallel/mesh.py``, its names only).

The JAX package builds a ``jax.sharding.Mesh`` over chips; here one process
drives one card and the ``torch.distributed`` process group is the mesh:

- ``"data"`` — sample sharding of the fixed effect: each rank holds a block
  of rows and one ``all_reduce`` per evaluation sums the blocks (the
  reference's ``treeAggregate``);
- ``"entity"`` — random-effect entities partitioned over ranks
  (:mod:`photon_ml_tpu_torch.game.multiprocess`), solved with no
  collective at all.

The ``"feature"`` axis (coefficient sharding inside one process over several
cards, ``--mesh feature=N``) is not ported.
"""

DATA_AXIS = "data"
ENTITY_AXIS = "entity"

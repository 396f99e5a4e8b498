"""Device meshes inside one process (counterpart of
``photon_ml_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over chips; here a
:class:`Mesh` is a grid of ``torch.device`` slots that one process drives,
with the same axis vocabulary:

- ``"data"`` — sample sharding of the fixed effect: block ``i`` of the rows
  lives on the slot of data index ``i``, each block is evaluated there and
  the partials are summed in slot order on the first slot
  (:class:`~photon_ml_tpu_torch.parallel.distributed.DistributedGLMObjective`
  with ``mesh=``);
- ``"entity"`` — random-effect bucket lanes split into contiguous slices,
  one a slot (:class:`~photon_ml_tpu_torch.game.random_effect.
  RandomEffectSolver` with ``mesh=``); the item axis of a ranking index
  (:meth:`~photon_ml_tpu_torch.retrieval.index.ItemIndex.build`);
- ``"feature"`` — the coefficient dimension split into column blocks
  (:class:`~photon_ml_tpu_torch.parallel.distributed.
  FeatureShardedGLMObjective`).

Several processes, one card each, are the other layout: the
``torch.distributed`` process group of ``--multihost``
(:mod:`~photon_ml_tpu_torch.parallel.multihost`).

A device may fill several slots of one mesh. That is the counterpart of the
JAX tests' virtual CPU devices (eight slots on the CPU), and the only way a
machine with one card runs a mesh wider than one: every slot on
``cuda:0``, each block and each lane slice a launch of its own there, the
copies between slots no-ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

DATA_AXIS = "data"
ENTITY_AXIS = "entity"
FEATURE_AXIS = "feature"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A row-major grid of device slots: ``axis_names[k]`` has ``sizes[k]``
    positions and ``devices`` lists the slots, the last axis fastest."""

    axis_names: tuple
    sizes: tuple
    devices: tuple

    def __post_init__(self):
        n = 1
        for s in self.sizes:
            n *= s
        if len(self.axis_names) != len(self.sizes) or n != len(self.devices):
            raise ValueError(f"mesh axes {self.axis_names} of sizes "
                             f"{self.sizes} need {n} devices, got "
                             f"{len(self.devices)}")

    @property
    def shape(self) -> dict:
        """Axis name to size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    def device_at(self, index: dict) -> torch.device:
        """The slot at ``index`` (axis name to position; an axis left out
        is at position 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.sizes):
            flat = flat * size + int(index.get(name, 0))
        return self.devices[flat]

    def axis_devices(self, axis: str) -> tuple:
        """The slots along ``axis``, every other axis at position 0."""
        return tuple(self.device_at({axis: i})
                     for i in range(self.shape[axis]))

    def lane_devices(self, axes: Sequence[str]) -> tuple:
        """The slots of a leading dimension split over ``axes``, the first
        axis major (``PartitionSpec(axes)``): slice ``k`` of
        ``prod(sizes of axes)`` goes to ``lane_devices(axes)[k]``."""
        out = [{}]
        for name in axes:
            out = [dict(ix, **{name: i}) for ix in out
                   for i in range(self.shape[name])]
        return tuple(self.device_at(ix) for ix in out)


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: Optional[dict] = None, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh; the default is every device on one ``"data"`` axis.
    ``devices`` defaults to every visible card and may name one device
    several times (see the module docstring)."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _visible_devices())
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: len(devices)}
    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[n]) for n in names)
    n_needed = 1
    for s in shape:
        n_needed *= s
    if n_needed > len(devices):
        raise ValueError(
            f"mesh {axis_sizes} needs {n_needed} devices, have {len(devices)}")
    return Mesh(axis_names=names, sizes=shape,
                devices=tuple(devices[:n_needed]))


def on_slot(device: torch.device):
    """Make ``device`` the current CUDA device for a slot's work (the
    kernels launch on the current device's stream); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()

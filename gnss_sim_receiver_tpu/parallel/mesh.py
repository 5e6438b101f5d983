"""Device mesh + sharding helpers.

Design (SURVEY.md sections 2.13/7): satellite channels are embarrassingly
parallel — every per-channel array in the receiver (tracking state, PRN
code tables, correlator outputs, acquisition grids) has the channel axis
leading, so sharding that axis over the mesh scales tracking and
acquisition linearly; the IF sample stream is replicated (every channel
reads the same antenna samples; a 20 ms chunk at 10 Msps is ~1.6 MB).  Observables/PVT gather is a per-epoch host pull of
a few hundred bytes per channel.

Acquisition's Doppler axis can additionally be sharded for single-channel
cold starts (grid axes: channels x Doppler x delay)."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHANNEL_AXIS = "ch"


def make_mesh(n_devices: int | None = None,
              axis: str = CHANNEL_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_channel_axis(tree, mesh: Mesh, axis: str = CHANNEL_AXIS):
    """Place every array of the pytree with its LEADING axis sharded over
    the mesh (per-channel state/codes); scalars and 0-d arrays are
    replicated."""
    def place(x):
        x = jax.numpy.asarray(x)
        spec = P(axis) if x.ndim >= 1 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(place, tree)


def replicate(tree, mesh: Mesh):
    """Fully replicate a pytree over the mesh (the shared sample chunk)."""
    def place(x):
        return jax.device_put(jax.numpy.asarray(x),
                              NamedSharding(mesh, P()))
    return jax.tree.map(place, tree)

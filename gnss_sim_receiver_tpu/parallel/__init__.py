"""Multi-device scale-out: mesh construction and channel sharding.

The reference scales by GNU Radio threads on one host (SURVEY.md section
2.13); this framework scales by sharding the channel axis of the batched
array program over a jax.sharding.Mesh (device collectives instead of ring
buffers)."""

from gnss_sim_receiver_tpu.parallel.mesh import (  # noqa: F401
    CHANNEL_AXIS, make_mesh, shard_channel_axis, replicate)

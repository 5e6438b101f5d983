"""Software-defined GNSS receiver framework on JAX.

A from-scratch re-design of the capabilities of the reference
``gnss_sim_receiver`` (a GNSS-SDR v0.0.19 fork) as an array program for an
accelerator:

- the per-satellite GNU Radio thread-per-block flowgraph becomes a *batched
  array program*: channels are rows of arrays, time advances in fixed-size
  sample blocks, and the DLL/PLL loop state is carried through ``lax.scan``;
- the VOLK SIMD kernels become XLA programs batched over
  (channels x taps x Doppler bins);
- the control plane (channel FSM, acquisition manager) runs host-side in
  Python while the device executes pure dataflow;
- scale-out is via ``jax.sharding.Mesh`` + ``shard_map`` over channels.

Package layout:
  ops/       numeric kernels: PRN codes, PCPS acquisition, correlators,
             discriminators, loop filters, filters/resamplers
  models/    receiver-stage engines: acquisition, tracking, telemetry,
             observables, PVT
  sim/       JAX signal simulator (the test fixture replacing gnss-sim /
             bladeGPS in the reference)
  parallel/  mesh / sharding helpers
  utils/     configuration, data model (Gnss_Synchro equivalent), sample IO
"""

__version__ = "0.1.0"

import os as _os

# one fixed directory in the checkout: the cache path is part of what JAX
# keys a hit on, so it must not move between runs
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _setup_compilation_cache() -> None:
    """Keep JAX's persistent compilation cache so fresh processes skip the
    receiver's compiles.  Where JAX_COMPILATION_CACHE_DIR is set, JAX
    reads it itself and nothing is configured here."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)


_setup_compilation_cache()

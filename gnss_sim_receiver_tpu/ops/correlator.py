"""Batched carrier-wipeoff + multi-tap code correlator.

This is the per-epoch tracking kernel — the batched analogue of the
reference's multicorrelator stack:
  - volk_gnsssdr_32f_xn_resampler_32f_xn          (N-tap code resampling)
  - volk_gnsssdr_32fc_32f_rotator_dot_prod_32fc_xn (rotator + N dot products)
  - cuda_multicorrelator (tracking/libs/cuda_multicorrelator.cu)
wrapped by cpu_multicorrelator_real_codes.cc:75-144.

Design: every tracking channel correlates a fixed-size sample block gathered
from a shared device-resident sample chunk at a per-channel offset.  The
carrier NCO (sin/cos), code NCO (fractional chip index -> code-table gather)
and the K-tap complex dot products are fused into one XLA program, batched
over channels; the tap reduction is an einsum, one
[C,K,B]x[C,B] contraction instead of C*K scalar loops.

All shapes static: B (block length) and K (taps) are compile-time; the
actual integration length N_c <= B is masked per channel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("block_size",))
def gather_blocks(x: jax.Array, positions: jax.Array, block_size: int):
    """[C] start positions -> [C, B] sample blocks from the shared chunk.
    Positions are clamped to the valid range (callers guarantee a halo)."""
    max_start = x.shape[0] - block_size
    pos = jnp.clip(positions, 0, max_start)
    return jax.vmap(
        lambda p: jax.lax.dynamic_slice(x, (p,), (block_size,)))(pos)


def correlate_multitap(
    blocks: jax.Array,          # [C, B] complex64 sample blocks
    codes: jax.Array,           # [C, L] float32 +-1 code tables
    tap_offsets_chips: jax.Array,  # [K] float32 (e.g. [-0.25, 0, +0.25])
    rem_code_phase_chips: jax.Array,   # [C] float32
    code_freq_chips: jax.Array,        # [C] float32 chips/s
    rem_carrier_phase_rad: jax.Array,  # [C] float32
    carrier_doppler_hz: jax.Array,     # [C] float32
    n_samples: jax.Array,              # [C] int32 integration length <= B
    fs: float,
    table_oversample: int = 1,
) -> jax.Array:
    """Fused NCO + wipeoff + K-tap correlation.  Returns [C, K] complex64.

    Mirrors one do_correlation_step() of the reference
    (dll_pll_veml_tracking.cc:1037-1062) for all channels at once.

    `table_oversample` > 1 selects band-limited sub-chip replica tables
    (prn_codes.bandlimited_table_normalized, `table_oversample` entries
    per chip): the lookup index becomes floor(chips * oversample).
    """
    c, b = blocks.shape
    n = jax.lax.broadcasted_iota(jnp.float32, (1, b), 1)       # [1, B]
    inv_fs = jnp.float32(1.0 / fs)

    # carrier NCO + wipeoff (phase grows along the block)
    phase = (rem_carrier_phase_rad[:, None]
             + 2.0 * jnp.pi * carrier_doppler_hz[:, None] * n * inv_fs)
    rot = jax.lax.complex(jnp.cos(phase), -jnp.sin(phase))      # exp(-j phase)
    mask = n < n_samples[:, None].astype(jnp.float32)
    xr = blocks * rot * mask                                    # [C, B]

    # code NCO: fractional chip index per sample, K tap shifts, table gather
    chips = (rem_code_phase_chips[:, None]
             + code_freq_chips[:, None] * n * inv_fs)           # [C, B]
    l = codes.shape[1]
    k_ovs = jnp.float32(table_oversample)
    idx = jnp.floor((chips[:, None, :]
                     + tap_offsets_chips[None, :, None])
                    * k_ovs).astype(jnp.int32)
    idx = jnp.mod(idx, l)                                       # [C, K, B]
    code_vals = jnp.take_along_axis(
        codes[:, None, :], idx.reshape(c, -1)[:, None, :], axis=-1
    ).reshape(c, idx.shape[1], b)                               # [C, K, B]

    # K complex dot products per channel in one contraction
    return jnp.einsum("ckb,cb->ck", code_vals, xr,
                      preferred_element_type=jnp.complex64)

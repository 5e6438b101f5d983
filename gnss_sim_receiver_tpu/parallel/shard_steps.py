"""Explicit-collective device steps (shard_map) for multi-device / multi-host
scale-out.

Three sharded programs cover the receiver's scale axes (SURVEY.md §2.13/§7;
the reference has no distributed backend — its per-channel GNU Radio
threads map here onto mesh axes):

  * tracking_step_sharded — CHANNEL axis over the mesh; each shard scans
    its channel group (trk.track_chunk), then `all_gather`s the per-epoch
    observable records so host rank 0 (observables/PVT) reads the full
    [T, C] batch — the analogue of every tracking block streaming
    Gnss_Synchro into hybrid_observables (gnss_flowgraph.cc:1152-1173).

  * acquisition_doppler_sharded — DOPPLER axis over the mesh for cold
    starts: each device searches a Doppler sub-band of the full PCPS grid;
    the global peak is reduced with an `all_gather` of per-shard
    (peak, doppler, delay) candidates (the batched analogue of
    pcps_acquisition.cc:640-672's Doppler loop, run as a parallel axis).

  * overlap_save_acq_grid — TIME axis over the mesh for long coherent /
    many-dwell acquisition: the capture is split into per-device segments,
    each device fetches a one-code-period halo from its right neighbour via
    `ppermute` (overlap-save linear correlation, SURVEY.md §5 "overlap-save
    FFT segmentation with halo exchange"), folds its valid lags modulo the
    code period, and the non-coherent grid is combined with `psum`.

Multi-host: the same code runs over the all-process mesh built by
make_multihost_mesh() after jax.distributed.initialize().  The 1-D
channel/time axis follows the algorithm alone: the cards of one host are
joined all to all, so no axis order is preferred within a host.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gnss_sim_receiver_tpu.parallel.mesh import CHANNEL_AXIS


def make_multihost_mesh(axis: str = CHANNEL_AXIS) -> Mesh:
    """All-process mesh for multi-host runs.  Call
    jax.distributed.initialize(coordinator, n_hosts, host_id) first; the
    flat axis enumerates devices in jax.devices() order, which keeps each
    host's devices contiguous, so a channel group lives on one host."""
    return Mesh(np.array(jax.devices()), (axis,))


def tracking_step_sharded(mesh: Mesh, conf, n_epochs: int, codes, taps,
                          x, state, axis: str = CHANNEL_AXIS):
    """One tracking scan with channels sharded over `mesh`.

    Returns (new_state sharded [C...], outs gathered [T, C] replicated).
    """
    from gnss_sim_receiver_tpu.models import tracking as trk

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(), P(), P(axis)),
             out_specs=(P(axis), P()), check_vma=False)
    def step(codes_l, taps_l, x_l, state_l):
        new_state, outs = trk.track_chunk(conf, n_epochs, codes_l, taps_l,
                                          x_l, state_l)
        # per-epoch observable records to every shard (host pulls rank 0)
        outs = {k: jax.lax.all_gather(v, axis, axis=1, tiled=True)
                for k, v in outs.items()}
        return new_state, outs

    return step(jnp.asarray(codes), jnp.asarray(taps), jnp.asarray(x),
                state)


def tracking_block_step_sharded(mesh: Mesh, conf, n_blocks: int,
                                e_block: int, codes_rep, taps, x, state,
                                sec_code=None, data_codes_rep=None,
                                axis: str = CHANNEL_AXIS):
    """The flagship block-FFT tracking kernel
    (models.tracking_block.track_chunk_blocks) with the CHANNEL axis
    sharded over `mesh`.

    Each shard computes the shared window spectra of the (replicated)
    chunk once and runs its channel group's matmul-DFT correlation; the
    per-epoch [T, C] output planes are `all_gather`ed so the host
    observables/telemetry path reads the full batch — the steady-state
    analogue of tracking_step_sharded (which covers the per-epoch
    pull-in kernel).  Returns (new_state sharded [C...], outs gathered,
    replicated).

    `codes_rep` / `data_codes_rep` are per-channel [C, F2] replica
    tables (sharded); `sec_code` is the chain-wide secondary-code table
    (replicated).
    """
    from gnss_sim_receiver_tpu.models import tracking_block as tb

    n_dev = mesh.shape[axis]
    c_total = int(codes_rep.shape[0])
    if c_total % n_dev:
        raise ValueError(f"channels ({c_total}) must divide the mesh "
                         f"axis ({n_dev})")

    def _gather(v):
        if v.ndim >= 2:           # [T, C] planes
            return jax.lax.all_gather(v, axis, axis=1, tiled=True)
        return jax.lax.all_gather(v, axis, axis=0, tiled=True)   # [C]

    if sec_code is None and data_codes_rep is None:
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(axis), P(), P(), P(axis)),
                 out_specs=(P(axis), P()), check_vma=False)
        def step(codes_l, taps_l, x_l, state_l):
            new_state, outs = tb.track_chunk_blocks(
                conf, n_blocks, e_block, codes_l, taps_l, x_l, state_l)
            return new_state, {k: _gather(v) for k, v in outs.items()}

        return step(jnp.asarray(codes_rep), jnp.asarray(taps),
                    jnp.asarray(x), state)

    sec = (jnp.asarray(sec_code) if sec_code is not None
           else jnp.zeros((0,), jnp.float32))
    data_rep = (jnp.asarray(data_codes_rep)
                if data_codes_rep is not None
                else jnp.zeros_like(jnp.asarray(codes_rep)))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(), P(), P(axis), P(), P(axis)),
             out_specs=(P(axis), P()), check_vma=False)
    def step_full(codes_l, taps_l, x_l, state_l, sec_l, data_l):
        new_state, outs = tb.track_chunk_blocks(
            conf, n_blocks, e_block, codes_l, taps_l, x_l, state_l,
            sec_code=sec_l if sec_l.shape[0] else None,
            data_codes_rep=data_l if data_codes_rep is not None
            else None)
        return new_state, {k: _gather(v) for k, v in outs.items()}

    return step_full(jnp.asarray(codes_rep), jnp.asarray(taps),
                     jnp.asarray(x), state, sec, data_rep)


def acquisition_doppler_sharded(mesh: Mesh, x_dwells, code_fft_conj,
                                dopplers, fs: float,
                                axis: str = CHANNEL_AXIS):
    """PCPS with the DOPPLER axis sharded: each device grids its Doppler
    sub-band for every channel; per-shard peak candidates are all_gathered
    and the global winner selected on-device.

    Args mirror ops.pcps.pcps_grid; len(dopplers) must divide by the mesh
    size.  Returns (peak [C], doppler_hz [C], delay_idx [C], noise [C]) —
    replicated; `noise` is the mean grid power (input-power CFAR reference)
    reduced across shards with psum.
    """
    from gnss_sim_receiver_tpu.ops import pcps

    n_shards = mesh.devices.size

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(axis)),
             out_specs=(P(), P(), P(), P()), check_vma=False)
    def step(x_dw, cfc, dops):
        grid = pcps.pcps_grid(x_dw, cfc, dops, fs)          # [C, D/S, N]
        peak, dop_i, del_i = pcps.grid_peak(grid)
        dop_hz = dops[dop_i]
        # global peak: gather the S candidates per channel, pick the max
        cand = jnp.stack([peak,
                          dop_hz.astype(jnp.float32),
                          del_i.astype(jnp.float32)])       # [3, C]
        allc = jax.lax.all_gather(cand, axis)               # [S, 3, C]
        win = jnp.argmax(allc[:, 0, :], axis=0)             # [C]
        sel = jnp.take_along_axis(allc, win[None, None, :], axis=0)[0]
        # noise floor: mean cell power over the WHOLE grid (psum across
        # Doppler shards) — the input-power reference of the non-CFAR path
        noise = jax.lax.psum(jnp.sum(grid, axis=(1, 2)), axis) / (
            jnp.float32(grid.shape[2]) * jnp.float32(
                grid.shape[1] * n_shards))
        return sel[0], sel[1], sel[2].astype(jnp.int32), noise

    return step(jnp.asarray(x_dwells), jnp.asarray(code_fft_conj),
                jnp.asarray(dopplers))


def overlap_save_acq_grid(mesh: Mesh, x, code_samples, dopplers, fs: float,
                          axis: str = CHANNEL_AXIS):
    """Time-sharded long-integration PCPS grid with halo exchange.

    Args:
      x: [S*L] complex64 capture (L per device; L % N == 0).
      code_samples: [N] float32 sampled +-1 replica (one code period).
      dopplers: [D] float32.

    Returns [D, N] float32 non-coherent grid, replicated on every device:
    sum over all S*(L/N) code-period windows of |linear correlation|^2.
    Each device correlates its segment extended by an N-sample halo from
    its right neighbour (ppermute), so every window is a true linear
    correlation; grids combine with psum.
    """
    n = int(code_samples.shape[0])
    s = mesh.devices.size
    total = int(x.shape[0])
    l_seg = total // s
    if l_seg % n or total % s:
        raise ValueError(f"need len(x) = S*k*N, got {total} (N={n}, S={s})")
    code_fft_c = jnp.conj(jnp.fft.fft(
        jnp.concatenate([jnp.asarray(code_samples, jnp.complex64),
                         jnp.zeros(l_seg, jnp.complex64)])))
    perm = [((j + 1) % s, j) for j in range(s)]   # receive from the right

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(), P()),
             out_specs=P())
    def step(x_l, cfc, dops):
        x_seg = x_l                                 # [L]
        halo = jax.lax.ppermute(x_seg[:n], axis, perm)
        ext = jnp.concatenate([x_seg, halo])        # [L + N]
        i = jax.lax.axis_index(axis)
        # absolute-time carrier so coherence is segment-invariant
        t = (jnp.arange(l_seg + n, dtype=jnp.float32)
             + jnp.float32(l_seg) * i) / jnp.float32(fs)
        phase = -2.0 * jnp.pi * dops[:, None] * t[None, :]
        wiped = ext[None, :] * jax.lax.complex(jnp.cos(phase),
                                               jnp.sin(phase))
        corr = jnp.fft.ifft(jnp.fft.fft(wiped, axis=-1) * cfc[None, :],
                            axis=-1)[:, :l_seg]     # valid lags only
        mag = jnp.real(corr) ** 2 + jnp.imag(corr) ** 2
        local = mag.reshape(mag.shape[0], l_seg // n, n).sum(axis=1)
        return jax.lax.psum(local, axis)            # [D, N]

    return step(jnp.asarray(x, jnp.complex64), code_fft_c,
                jnp.asarray(dopplers, jnp.float32))

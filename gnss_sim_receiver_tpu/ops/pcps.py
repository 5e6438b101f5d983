"""Batched Parallel Code Phase Search (PCPS) acquisition kernels.

Batched replacement for the reference's FFT acquisition core
(src/algorithms/acquisition/gnuradio_blocks/pcps_acquisition.cc:600-871) and
its OpenCL/FPGA offload variants: the entire (channels x Doppler bins x code
delay) search grid is computed as one batched XLA FFT program instead of a
per-Doppler-bin loop of FFTW calls — channels and Doppler bins are array
axes, so a single dispatch searches every satellite at once.

All functions are pure and jit-friendly; shapes are static.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from scipy import special as _sp_special


def doppler_grid(doppler_max: float, doppler_step: float,
                 doppler_center: float = 0.0) -> np.ndarray:
    """Doppler bin centers [-max, +max] + center (reference
    pcps_acquisition.cc:261 num_doppler_bins, inclusive of +max)."""
    n = int(np.ceil(2.0 * doppler_max / doppler_step)) + 1
    return (doppler_center - doppler_max
            + doppler_step * np.arange(n)).astype(np.float32)


@partial(jax.jit, static_argnames=("fs",))
def pcps_grid(x_dwells: jax.Array, code_fft_conj: jax.Array,
              dopplers: jax.Array, fs: float) -> jax.Array:
    """Non-coherently accumulated PCPS magnitude grid.

    Args:
      x_dwells: [M, N] complex64 — M non-coherent dwells of N samples
        (N = samples per coherent integration, zero-padded if needed).
      code_fft_conj: [C, N] complex64 — conj(FFT(local code replica)) per
        channel (the reference precomputes this per adapter).
      dopplers: [D] float32 Doppler bin centers (Hz).
      fs: sampling rate (Hz).

    Returns:
      [C, D, N] float32 grid of |circular correlation|^2 summed over dwells.

    Per Doppler bin this computes the reference's
      wipeoff -> FFT -> x conj(code FFT) -> IFFT -> |.|^2 accumulate
    (pcps_acquisition.cc:640-672) for all channels/bins in one shot.
    """
    m, n = x_dwells.shape
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(fs)
    phase = -2.0 * jnp.pi * dopplers[:, None] * t[None, :]
    carrier = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))      # [D, N]
    wiped = x_dwells[:, None, :] * carrier[None, :, :]             # [M, D, N]
    spec = jnp.fft.fft(wiped, axis=-1)                             # [M, D, N]
    prod = spec[:, None, :, :] * code_fft_conj[None, :, None, :]   # [M, C, D, N]
    corr = jnp.fft.ifft(prod, axis=-1)
    mag = jnp.real(corr) ** 2 + jnp.imag(corr) ** 2
    return jnp.sum(mag, axis=0)                                    # [C, D, N]


@partial(jax.jit, static_argnames=("fs",))
def pcps_grid_per_channel(x_dwells: jax.Array, code_fft_conj: jax.Array,
                          dopplers: jax.Array, fs: float) -> jax.Array:
    """PCPS grid where every channel searches its OWN Doppler bin set.

    Args:
      x_dwells: [M, N] complex64 dwells.
      code_fft_conj: [C, N] complex64.
      dopplers: [C, D] float32 per-channel Doppler centers (Hz).

    Returns [C, D, N] float32.  Used by the batched two-step refinement
    (pcps_acquisition.cc:698-758 make_2_steps: narrow grid re-centered on
    each channel's coarse hit) — all channels refine in ONE dispatch
    instead of the reference's per-channel re-run.
    """
    m, n = x_dwells.shape
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(fs)
    phase = -2.0 * jnp.pi * dopplers[:, :, None] * t[None, None, :]
    carrier = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))  # [C, D, N]
    wiped = x_dwells[:, None, None, :] * carrier[None]         # [M, C, D, N]
    spec = jnp.fft.fft(wiped, axis=-1)
    prod = spec * code_fft_conj[None, :, None, :]
    corr = jnp.fft.ifft(prod, axis=-1)
    mag = jnp.real(corr) ** 2 + jnp.imag(corr) ** 2
    return jnp.sum(mag, axis=0)                                # [C, D, N]


@jax.jit
def grid_peak(grid: jax.Array):
    """Argmax over each channel's (Doppler, delay) grid.

    Returns (peak_value [C], doppler_idx [C], delay_idx [C]) — the batched
    analogue of volk_gnsssdr_32f_index_max_32u per bin + the cross-bin max
    scan (pcps_acquisition.cc:504-517).
    """
    c, d, n = grid.shape
    flat = grid.reshape(c, d * n)
    idx = jnp.argmax(flat, axis=-1)
    peak = jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]
    return peak, (idx // n).astype(jnp.int32), (idx % n).astype(jnp.int32)


@jax.jit
def max_to_input_power_stat(grid: jax.Array, n_dwells: jax.Array):
    """CFAR test statistic: grid peak over the mean power of the Doppler row
    'opposite' the peak (noise-only reference row), exactly mirroring
    pcps_acquisition.cc:496-528 max_to_input_power_statistic.

    Returns (test_stat [C], doppler_idx [C], delay_idx [C]).
    """
    c, d, n = grid.shape
    peak, dop_idx, del_idx = grid_peak(grid)
    opp = (dop_idx + d // 2) % d
    opp_rows = jnp.take_along_axis(grid, opp[:, None, None], axis=1)[:, 0, :]
    input_power = jnp.mean(opp_rows, axis=-1) / 2.0 / n_dwells
    return peak / jnp.maximum(input_power, 1e-30), dop_idx, del_idx


@partial(jax.jit, static_argnames=("samples_per_chip",))
def first_vs_second_peak_stat(grid: jax.Array, samples_per_chip: int):
    """First/second-peak ratio with a +-1 chip circular exclusion zone
    around the main peak, mirroring pcps_acquisition.cc:531-597.

    Returns (test_stat [C], doppler_idx [C], delay_idx [C]).
    """
    c, d, n = grid.shape
    peak, dop_idx, del_idx = grid_peak(grid)
    rows = jnp.take_along_axis(grid, dop_idx[:, None, None], axis=1)[:, 0, :]
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]
    dist = jnp.abs((pos - del_idx[:, None] + n // 2) % n - n // 2)
    masked = jnp.where(dist <= samples_per_chip, 0.0, rows)
    second = jnp.max(masked, axis=-1)
    return peak / jnp.maximum(second, 1e-30), dop_idx, del_idx


def cfar_threshold(pfa: float, n_cells: int, n_dwells: int = 1,
                   bit_transition: bool = False) -> float:
    """Detection threshold from target Pfa via the inverse regularized lower
    incomplete gamma — same formula as pcps_acquisition.cc:884-900
    calculate_threshold()."""
    if pfa <= 0.0:
        return 0.0
    dof = 2.0 * (1 if bit_transition else n_dwells)
    return float(2.0 * _sp_special.gammaincinv(
        dof, (1.0 - pfa) ** (1.0 / float(n_cells))))


@partial(jax.jit, static_argnames=("fs", "fold"))
def pcps_quicksync_grid(x_dwells: jax.Array, codes_sampled: jax.Array,
                        dopplers: jax.Array, fs: float, fold: int):
    """QuickSync folded acquisition
    (pcps_quicksync_acquisition_cc.cc): the dwell and the local code are
    both FOLDED by summing `fold` equal segments, shrinking the FFT by
    `fold` (and the noise by averaging); the resulting grid resolves the
    code phase MODULO N/fold.

    Args:
      x_dwells: [M, N]; codes_sampled: [C, N] float32 +-1 sampled codes
      (time domain — folding happens here); dopplers: [D].
    Returns [C, D, N//fold] magnitude grid.
    """
    m, n = x_dwells.shape
    nf = n // fold
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(fs)
    phase = -2.0 * jnp.pi * dopplers[:, None] * t[None, :]
    carrier = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    wiped = x_dwells[:, None, :] * carrier[None, :, :]             # [M,D,N]
    folded = wiped[..., : nf * fold].reshape(m, -1, fold, nf).sum(axis=2)
    code_f = codes_sampled[:, : nf * fold].reshape(
        codes_sampled.shape[0], fold, nf).sum(axis=1)              # [C, NF]
    cfc = jnp.conj(jnp.fft.fft(code_f.astype(jnp.complex64), axis=-1))
    spec = jnp.fft.fft(folded, axis=-1)                            # [M,D,NF]
    prod = spec[:, None, :, :] * cfc[None, :, None, :]
    corr = jnp.fft.ifft(prod, axis=-1)
    mag = jnp.real(corr) ** 2 + jnp.imag(corr) ** 2
    return jnp.sum(mag, axis=0)                                    # [C,D,NF]


@partial(jax.jit, static_argnames=("fs", "fold"))
def quicksync_resolve(x_dwell: jax.Array, codes_sampled: jax.Array,
                      doppler_hz: jax.Array, delay_mod: jax.Array,
                      fs: float, fold: int = 4):
    """Resolve the QuickSync fold ambiguity: evaluate the FULL-length
    correlation at the `fold` candidate delays (delay_mod + k*N/fold) for
    each channel's detected Doppler and return the winning absolute
    delay (pcps_quicksync_acquisition_cc.cc ambiguity resolution role).

    x_dwell [N], codes_sampled [C, N], doppler_hz [C], delay_mod [C].
    Returns ([C] delays, [C] magnitudes)."""
    c, n = codes_sampled.shape
    nf = n // fold
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(fs)
    ph = -2.0 * jnp.pi * doppler_hz[:, None] * t[None, :]
    wiped = x_dwell[None, :] * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    cand = delay_mod[:, None] + nf * jnp.arange(fold)[None, :]     # [C, K]

    def corr_at(ch_wiped, code, d):
        rolled = jnp.roll(code, d)
        v = jnp.sum(ch_wiped * rolled)
        return jnp.abs(v)

    mags = jax.vmap(
        lambda w, code, ds: jax.vmap(lambda d: corr_at(w, code, d))(ds)
    )(wiped, codes_sampled, cand)                                  # [C, K]
    k = jnp.argmax(mags, axis=1)
    return (jnp.take_along_axis(cand, k[:, None], axis=1)[:, 0],
            jnp.take_along_axis(mags, k[:, None], axis=1)[:, 0])


@partial(jax.jit, static_argnames=("fs",))
def pcps_8ms_grid(x_dwells: jax.Array, code_fft_conj: jax.Array,
                  dopplers: jax.Array, fs: float):
    """Galileo E1 8 ms acquisition (galileo_pcps_8ms_acquisition_cc.cc):
    each dwell spans TWO consecutive code periods; both halves are
    correlated separately (carrier wiped over the full dwell so their
    relative phase is preserved) and combined coherently under both
    data-symbol sign hypotheses, max(|c1+c2|^2, |c1-c2|^2) — doubling
    coherent gain without knowing the E1B symbol edge sign.

    x_dwells: [M, 2N]; code_fft_conj: [C, N].  Returns [C, D, N]."""
    m, n2 = x_dwells.shape
    n = n2 // 2
    t = jnp.arange(n2, dtype=jnp.float32) / jnp.float32(fs)
    phase = -2.0 * jnp.pi * dopplers[:, None] * t[None, :]
    carrier = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    wiped = x_dwells[:, None, :] * carrier[None, :, :]       # [M, D, 2N]
    halves = wiped.reshape(m, -1, 2, n)                      # [M, D, 2, N]
    spec = jnp.fft.fft(halves, axis=-1)
    corr = jnp.fft.ifft(spec[:, None] * code_fft_conj[None, :, None,
                                                      None, :],
                        axis=-1)                             # [M,C,D,2,N]
    c1 = corr[..., 0, :]
    c2 = corr[..., 1, :]
    plus = jnp.abs(c1 + c2) ** 2
    minus = jnp.abs(c1 - c2) ** 2
    return jnp.sum(jnp.maximum(plus, minus), axis=0)


@partial(jax.jit, static_argnames=("fs",))
def pcps_cccwsr_grid(x_dwells: jax.Array, code_data_fft_conj: jax.Array,
                     code_pilot_fft_conj: jax.Array,
                     dopplers: jax.Array, fs: float):
    """Coherent Channel Combining With Sign Recovery (E1 CBOC data+pilot,
    pcps_cccwsr_acquisition_cc.cc): correlate the dwell against the data
    and pilot codes separately, then combine coherently under BOTH
    relative-sign hypotheses and keep the larger — recovering the
    unknown data/pilot sign instead of wasting half the power.

    Returns [C, D, N] magnitude grid max(|d+p|^2, |d-p|^2) summed over
    dwells."""
    m, n = x_dwells.shape
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(fs)
    phase = -2.0 * jnp.pi * dopplers[:, None] * t[None, :]
    carrier = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    wiped = x_dwells[:, None, :] * carrier[None, :, :]
    spec = jnp.fft.fft(wiped, axis=-1)
    cd = jnp.fft.ifft(spec[:, None, :, :]
                      * code_data_fft_conj[None, :, None, :], axis=-1)
    cp = jnp.fft.ifft(spec[:, None, :, :]
                      * code_pilot_fft_conj[None, :, None, :], axis=-1)
    plus = jnp.abs(cd + cp) ** 2
    minus = jnp.abs(cd - cp) ** 2
    return jnp.sum(jnp.maximum(plus, minus), axis=0)


@partial(jax.jit, static_argnames=("fs", "caf_bins"))
def pcps_e5a_noncoherent_iq_grid(x_dwells: jax.Array,
                                 code_i_fft_conj: jax.Array,
                                 code_q_fft_conj: jax.Array,
                                 dopplers: jax.Array, fs: float,
                                 caf_bins: int = 0):
    """Galileo E5a non-coherent I/Q acquisition with optional CAF
    Doppler-axis filtering
    (galileo_e5a_noncoherent_iq_acquisition_caf_cc.cc): |corr_I|^2 +
    |corr_Q|^2 accumulated over dwells; with caf_bins > 0 the grid is
    smoothed along Doppler by a (2*caf_bins+1)-bin boxcar (the CAF
    filter's sidelobe-averaging role)."""
    m, n = x_dwells.shape
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(fs)
    phase = -2.0 * jnp.pi * dopplers[:, None] * t[None, :]
    carrier = jax.lax.complex(jnp.cos(phase), jnp.sin(phase))
    wiped = x_dwells[:, None, :] * carrier[None, :, :]
    spec = jnp.fft.fft(wiped, axis=-1)
    ci = jnp.fft.ifft(spec[:, None, :, :]
                      * code_i_fft_conj[None, :, None, :], axis=-1)
    cq = jnp.fft.ifft(spec[:, None, :, :]
                      * code_q_fft_conj[None, :, None, :], axis=-1)
    grid = jnp.sum(jnp.abs(ci) ** 2 + jnp.abs(cq) ** 2, axis=0)
    if caf_bins > 0:
        k = 2 * caf_bins + 1
        kern = jnp.ones(k, jnp.float32) / k
        grid = jax.vmap(  # convolve along the Doppler axis per channel
            lambda g: jax.vmap(
                lambda col: jnp.convolve(col, kern, mode="same"),
                in_axes=1, out_axes=1)(g))(grid)
    return grid

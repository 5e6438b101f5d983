"""Acquisition detection-performance harness (ROC / Pd-Pfa sweeps).

The batched equivalent of the reference's acq_performance_test
(src/tests/unit-tests/signal-processing-blocks/acquisition/
acq_performance_test.cc:283-376): measure the PCPS detector's false-alarm
rate on noise and its detection probability versus C/N0 by running
thousands of independent trials.  Batched: trials are an array axis —
one jitted program evaluates [trials] grids at once (vmapped pcps_grid),
so a 1000-trial sweep costs milliseconds instead of the reference's
minutes of per-trial flowgraph runs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.ops import pcps, prn_codes


@partial(jax.jit, static_argnames=("n", "n_trials", "fs", "use_cfar",
                                   "spc", "m"))
def _trial_stats(key, code_sig, code_fft_conj, dopplers, amp, dop_true_hz,
                 delay_samples, n, n_trials, fs, use_cfar, spc, m):
    """[n_trials] detection statistics for signal at amplitude `amp`
    (0 = noise-only trials), true Doppler/delay fixed."""
    keys = jax.random.split(key, 2)
    noise = (jax.random.normal(keys[0], (n_trials, m, n))
             + 1j * jax.random.normal(keys[1], (n_trials, m, n))
             ) * jnp.sqrt(0.5)
    # signal replica: code at delay, carrier at dop (same for all trials)
    t = (jnp.arange(m * n) / fs).reshape(m, n)
    sig = (jnp.roll(code_sig[None, :].repeat(m, axis=0), delay_samples,
                    axis=-1)
           * jnp.exp(2j * jnp.pi * dop_true_hz * t))
    x = noise + amp * sig[None]

    def one(xi):
        grid = pcps.pcps_grid(xi, code_fft_conj, dopplers, fs)
        if use_cfar:
            stat, _, _ = pcps.max_to_input_power_stat(grid, jnp.float32(m))
        else:
            stat, _, _ = pcps.first_vs_second_peak_stat(grid, spc)
        return stat[0]

    return jax.vmap(one)(x.astype(jnp.complex64))


def sweep(prn: int = 1, fs: float = 2_000_000.0, cn0_db_hz=(38.0, 42.0,
                                                            46.0),
          pfa: float = 0.01, n_trials: int = 256, doppler_max=5000.0,
          doppler_step=250.0, max_dwells: int = 1, seed: int = 0,
          dop_true_hz: float = 1375.0, delay_samples: int = 700):
    """Measured (pfa_hat, {cn0: pd_hat}, threshold) for the GPS L1 C/A
    PCPS detector.  Noise power is unit per complex sample; amplitude for
    a C/N0 follows the simulator's convention amp = sqrt(2 C/N0 / fs)."""
    n = int(round(fs * 1e-3))
    code = prn_codes.sample_code(prn_codes.gps_l1_ca_code(prn), fs,
                                 constants.GPS_L1_CA_CODE_RATE_CPS, n)
    cfc = jnp.asarray(np.conj(np.fft.fft(code))[None].astype(np.complex64))
    dops = jnp.asarray(pcps.doppler_grid(doppler_max, doppler_step))
    n_cells = n * len(dops)
    thr = pcps.cfar_threshold(pfa, n_cells, max_dwells)
    key = jax.random.PRNGKey(seed)

    key, sub = jax.random.split(key)
    code_j = jnp.asarray(code.astype(np.float32))
    s0 = np.asarray(_trial_stats(
        sub, code_j, cfc, dops, jnp.float32(0.0),
        jnp.float32(dop_true_hz), delay_samples, n, n_trials, float(fs),
        True, 2, max_dwells))
    pfa_hat = float((s0 > thr).mean())

    pd = {}
    for cn0 in cn0_db_hz:
        amp = np.sqrt(2.0 * 10.0 ** (cn0 / 10.0) / fs)
        key, sub = jax.random.split(key)
        s = np.asarray(_trial_stats(
            sub, code_j, cfc, dops, jnp.float32(amp),
            jnp.float32(dop_true_hz), delay_samples, n, n_trials,
            float(fs), True, 2, max_dwells))
        pd[float(cn0)] = float((s > thr).mean())
    return pfa_hat, pd, float(thr)

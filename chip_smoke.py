#!/usr/bin/env python3
"""Smoke run of the receiver's main path on one GPU.

    python chip_smoke.py

One process, one card.  Each phase checks its results against a plain
reference and raises on the first failure, so any failing phase ends the
run with a non-zero exit code:

  device    platform, device kind and count, JAX version, the card's name
            and power limit (nvidia-smi), native library, compile cache
  fft       the block tracking kernel's FFT route (window spectra of 1 s of
            signal, 12-channel replica batch) against NumPy float64, at
            2, 4 and 20 Msps
  kernels   the block tracking kernel against the per-epoch kernel and
            against a float64 evaluation of its E/P/L correlations; the
            per-epoch correlator, the KF covariance update, the PCPS grid
            and the FIR decimator against float64 NumPy.  Every contraction
            runs at default precision and at HIGHEST.
  receiver  Receiver.process_array on a 12-satellite, 120 s, 2 Msps
            device-resident scenario, cold and warm, checked against the
            simulated position (2D < 2 m, 3D < 5 m)
  cli       python -m gnss_sim_receiver_tpu on a simulated 40 s ishort
            capture at 4 Msps (tests/data/gnss-sdr_GPS_L1_ishort.conf)

Every number is printed beside the card's name and power limit.  The last
line of standard output is one JSON object naming the device.  Without a
GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ISHORT_CONF = os.path.join(REPO, "tests", "data", "gnss-sdr_GPS_L1_ishort.conf")

# Tolerances, each relative to the magnitude named beside it.
FFT_TOL = 1e-5        # |X - X64| / max|X64|: float32 FFT round-off is ~1e-7
#                       per stage; TF32 (10-bit mantissa) would read ~1e-3
CORR_TOL = 1e-4       # correlator outputs, relative to mean |prompt|: two
#                       orders above float32 round-off, one below TF32
PCPS_TOL = 1e-4       # grid, relative to the grid's peak
FIR_TOL = 1e-4        # FIR output, relative to its RMS
KF_TOL = 1e-4         # covariance entries, relative to sqrt(P_ii P_jj)
KERNEL_AGREE = (0.05, 0.15)   # block vs per-epoch kernel over 1 s, 12
#                               channels: median / max prompt difference
#                               relative to mean |prompt|.  Two loop
#                               closures (1 ms wide PLL vs 20 ms narrow)
#                               that the other 11 satellites' cross-
#                               correlation moves apart; 3 clean channels
#                               agree to 0.01 / 0.05
#                               (tests/test_tracking_block.py)
DOPPLER_TOL_HZ = 5.0          # either kernel's mean Doppler vs truth
RATES = (2_000_000.0, 4_000_000.0, 20_000_000.0)
GPS_CA_RATE = 1.023e6


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, card: str, text: str) -> None:
    print(f"[{phase}] {text}  ({card})", flush=True)


def card_name_and_power() -> str:
    """`name, power.limit` of the first card, read by a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- device


def phase_device() -> dict:
    import jax

    from gnss_sim_receiver_tpu import native

    dev = jax.devices()[0]
    card = card_name_and_power()
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__,
            "card": card, "native": native.have_native(),
            "compile_cache": jax.config.jax_compilation_cache_dir}
    print(f"[device] platform={info['platform']} kind={info['kind']} "
          f"count={info['count']} jax={info['jax']}", flush=True)
    print(card, flush=True)
    print(f"[device] native library loaded: {info['native']}; compile "
          f"cache: {info['compile_cache']}", flush=True)
    return info


# ------------------------------------------------------------------- fft


def phase_fft(card: str, rates=RATES, seconds: float = 1.0,
              n_channels: int = 12, seed: int = 0) -> dict:
    """The block kernel's FFT route against NumPy float64: the shared
    window spectra of `seconds` of signal ([~1000, nfft] at 1 s) and the
    Doppler-ramped replica batch ([n_channels, nfft])."""
    import jax
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.models import tracking as trk
    from gnss_sim_receiver_tpu.models import tracking_block as tb

    rng = np.random.default_rng(seed)
    out = {}
    for fs in rates:
        conf = trk.TrackingConf(fs=fs)
        s0 = conf.nominal_epoch_samples
        nfft = tb.block_fft_size(conf)
        n = int(fs * seconds)
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        got = np.asarray(jax.jit(tb._window_spectra, static_argnums=(1, 2))(
            jnp.asarray(x), s0, nfft))
        xp = np.concatenate([np.zeros(tb._LEAD, np.complex128), x,
                             np.zeros(nfft, np.complex128)])
        idx = (np.arange(got.shape[0]) * s0)[:, None] + np.arange(nfft)
        ref = np.fft.fft(xp[idx], axis=-1)
        err_w = float(np.abs(got - ref).max() / np.abs(ref).max())

        codes = rng.choice([-1.0, 1.0], (n_channels, nfft)).astype(
            np.float32)
        codes[:, s0:] = 0.0
        omega = (2 * np.pi * rng.uniform(-5000, 5000, n_channels) / fs
                 ).astype(np.float32)
        got_r = np.asarray(jax.jit(tb._replica_spectra)(
            jnp.asarray(codes), jnp.asarray(omega)))
        ramp = omega.astype(np.float64)[:, None] * np.arange(nfft)
        ref_r = np.conj(np.fft.fft(codes * np.exp(1j * ramp), axis=-1))
        err_r = float(np.abs(got_r - ref_r).max() / np.abs(ref_r).max())
        say("fft", card,
            f"fs={fs / 1e6:g}Msps windows={list(got.shape)} "
            f"max_err/peak={err_w:.3e}; replicas={list(got_r.shape)} "
            f"max_err/peak={err_r:.3e}; tol={FFT_TOL:g}")
        check(err_w <= FFT_TOL and err_r <= FFT_TOL,
              f"fft at {fs} Hz: window {err_w:.3e}, replica {err_r:.3e}")
        out[fs] = (err_w, err_r)
    return out


# --------------------------------------------------------------- kernels


def _sky(fs: float, n_channels: int, n_samples: int, seed: int):
    """Noise-free GPS L1 C/A sky with integer-sample code starts, and the
    band-limited replica tables both tracking kernels read."""
    from gnss_sim_receiver_tpu.ops import prn_codes
    from gnss_sim_receiver_tpu.sim import SatelliteSignalParams
    from gnss_sim_receiver_tpu.sim.device_generator import \
        generate_baseband_device_resident

    rng = np.random.default_rng(seed)
    s0 = int(round(fs * 1e-3))
    prns = list(range(1, n_channels + 1))
    dops = (np.linspace(-4000.0, 4000.0, n_channels)
            + rng.uniform(-50.0, 50.0, n_channels))
    delays = rng.integers(0, s0, n_channels)
    sats = [SatelliteSignalParams(prn=p, cn0_db_hz=50.0, doppler_hz=float(d),
                                  delay_chips=float(n * GPS_CA_RATE / fs),
                                  nav_bits=np.ones(64, np.int8))
            for p, d, n in zip(prns, dops, delays)]
    x = generate_baseband_device_resident(sats, fs, n_samples, noise=False,
                                          seed=seed)
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        np.asarray(prn_codes.gps_l1_ca_code(p), np.float32), fs,
        GPS_CA_RATE, s0) for p in prns])
    return x, tables, dops, delays


def _armed_state(conf, dops, delays):
    """Every channel armed exactly on truth (pull-in done: the regime in
    which the receiver runs the block kernel)."""
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.models import tracking as trk

    st = trk._init_state(len(dops))
    for ch, d in enumerate(dops):
        f0 = conf.code_rate_cps * (1.0 + d / conf.carrier_freq_hz)
        st = trk._arm_channel(st, ch, float(d), float(f0))
    pos = np.asarray(delays, np.int64)
    phase0 = np.mod(2.0 * np.pi * np.asarray(dops) * pos / conf.fs,
                    2.0 * np.pi).astype(np.float32)
    return st._replace(pos=jnp.asarray(pos.astype(np.int32)),
                       rem_carr_phase=jnp.asarray(phase0))


def epoch_grid_bound(conf, e_block: int, max_doppler_hz: float = 5e3
                     ) -> float:
    """Bound, relative to |P|, on what the block kernel's float32
    closed-form epoch grid changes in its correlations against an exact
    grid.  By the block's last epoch the grid (s_per = L / rate * fs, then
    e * s_per, then the window lag) may sit `d` samples off: two roundings
    of s_per accumulated over e_block epochs, one of e * s_per and one of
    the lag.  A slope-one correlation (E/L on the triangle's flanks) moves
    by d in chips, and the carrier phase folded into the lag phasor by
    omega * d radians."""
    s0 = np.float32(conf.nominal_epoch_samples)
    d = (2 * e_block * np.spacing(s0)
         + np.spacing(np.float32(e_block) * s0) + np.spacing(2 * s0))
    return float(d * conf.code_rate_cps / conf.fs
                 + 2.0 * np.pi * max_doppler_hz / conf.fs * d)


def block_correlations_f64(conf, x, st, codes_rep, taps, e_block: int):
    """Float64 NumPy evaluation of the block kernel's first block of E/P/L
    correlations -> [C, E, K]: the same window grid, replica spectra and
    fractional-lag phasors as models.tracking_block, in float64."""
    from gnss_sim_receiver_tpu.models import tracking_block as tb

    fs = conf.fs
    s0 = conf.nominal_epoch_samples
    nfft = tb.block_fft_size(conf)
    lead = tb._LEAD
    x = np.asarray(x).astype(np.complex128)
    rate = np.asarray(st.code_freq, np.float64)
    dop = np.asarray(st.carrier_doppler, np.float64)
    pos = np.asarray(st.pos, np.int64)
    u0 = np.asarray(st.rem_code_phase, np.float64) / rate * fs
    rem_carr = np.asarray(st.rem_carr_phase, np.float64)
    taps = np.asarray(taps, np.float64)
    e = np.arange(e_block)
    n_wins = max(1, (len(x) + lead - nfft) // s0 + 1)
    ecs = (e[None, :] * (conf.code_length_chips / rate * fs)[:, None]
           - u0[:, None])                                       # [C, E]
    omega = 2.0 * np.pi * dop / fs
    m = np.arange(nfft)
    rep = np.asarray(codes_rep, np.float64) * np.exp(1j * omega[:, None] * m)
    rf = np.conj(np.fft.fft(rep, axis=-1))                      # [C, F]
    w0 = np.clip(pos // s0, 0, max(n_wins - e_block, 0))
    xp = np.concatenate([np.zeros(lead), x,
                         np.zeros(nfft + e_block * s0)])
    starts = (w0[:, None] + e[None, :]) * s0
    xf = np.fft.fft(xp[starts[..., None] + m], axis=-1)         # [C, E, F]
    stretch = (conf.code_length_chips * (dop - conf.doppler_bias_hz)
               / conf.carrier_freq_hz)
    shift = 0.5 * stretch / rate * fs
    lag = ((pos - w0 * s0)[:, None] + (ecs - e[None, :] * s0) + lead
           - shift[:, None])
    f = np.where(m >= nfft // 2, m - nfft, m)
    ph_sc = rem_carr[:, None] + omega[:, None] * (ecs - shift[:, None])
    pl = np.exp(1j * (2.0 * np.pi * f * lag[..., None] / nfft
                      - ph_sc[..., None]))
    tap_s = -taps[None, :] / rate[:, None] * fs                 # [C, K]
    pt = np.exp(1j * (2.0 * np.pi * f * tap_s[..., None] / nfft
                      - (omega[:, None] * tap_s)[..., None]))
    return np.einsum("cef,ckf->cek", xf * rf[:, None, :] * pl, pt) / nfft


def correlator_f64(blocks, codes, taps, rem_code, code_freq, rem_carr, dop,
                   n_samples, fs, k_ovs, ambiguity: float = 4e-3):
    """Float64 NumPy form of ops.correlator.correlate_multitap -> ([C, K]
    correlations, [C, K] bound).  A sample whose table index lies within
    `ambiguity` of an integer may round to either neighbour in float32;
    `bound` sums what choosing the other entry would change."""
    blocks = np.asarray(blocks).astype(np.complex128)
    c, b = blocks.shape
    n = np.arange(b)
    phase = (np.asarray(rem_carr, np.float64)[:, None]
             + 2.0 * np.pi * np.asarray(dop, np.float64)[:, None] * n / fs)
    mask = n[None, :] < np.asarray(n_samples)[:, None]
    xr = blocks * np.exp(-1j * phase) * mask
    chips = (np.asarray(rem_code, np.float64)[:, None]
             + np.asarray(code_freq, np.float64)[:, None] * n / fs)
    codes = np.asarray(codes, np.float64)
    fidx = (chips[:, None, :]
            + np.asarray(taps, np.float64)[None, :, None]) * k_ovs
    l = codes.shape[1]
    pick = lambda i: np.take_along_axis(
        codes[:, None, :], np.floor(i).astype(np.int64) % l, axis=-1)
    vals = pick(fidx)                                           # [C, K, B]
    swing = np.abs(pick(fidx + ambiguity) - pick(fidx - ambiguity))
    bound = np.einsum("ckb,cb->ck", swing, np.abs(xr))
    return np.einsum("ckb,cb->ck", vals, xr), bound


def kf_covariance_f64(conf, p, t_int):
    """Float64 predict + update of models.tracking._kf_update's
    covariance."""
    beta = conf.code_rate_cps / conf.carrier_freq_hz
    c = p.shape[0]
    f = np.tile(np.eye(4), (c, 1, 1))
    f[:, 0, 2] = beta * t_int
    f[:, 0, 3] = beta * t_int * t_int / 2.0
    f[:, 1, 2] = t_int
    f[:, 1, 3] = t_int * t_int / 2.0
    f[:, 2, 3] = t_int
    q = np.diag([conf.kf_q_code_chips2, conf.kf_q_phase_cyc2,
                 conf.kf_q_dop_hz2, conf.kf_q_doprate_hz2s2])
    pp = np.einsum("cij,cjk,clk->cil", f, p, f) + q[None]
    s = pp[:, :2, :2] + np.diag([conf.kf_r_code_chips2,
                                 conf.kf_r_phase_cyc2])[None]
    k = np.einsum("cij,cjk->cik", pp[:, :, :2], np.linalg.inv(s))
    kh = np.zeros((c, 4, 4))
    kh[:, :, :2] = k
    return np.einsum("cij,cjk->cik", np.eye(4)[None] - kh, pp)


def _precision_gap(outs: dict, scale) -> float:
    """max |default - HIGHEST| / scale: what default matmul precision alone
    changes (both runs share every other operation)."""
    return float((np.abs(outs["default"] - outs["highest"]) / scale).max())


def _precisions():
    """(label, context) for default precision and for HIGHEST."""
    import jax
    return (("default", contextlib.nullcontext),
            ("highest", lambda: jax.default_matmul_precision("highest")))


def _check_block_kernel(card, fs, n_channels, seconds, seed):
    import jax
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.models import tracking as trk
    from gnss_sim_receiver_tpu.models import tracking_block as tb

    conf = trk.TrackingConf(fs=fs, enable_fll_pullin=False)
    s0 = conf.nominal_epoch_samples
    e_block = 20
    n_blocks = max(2, int(round(seconds * 1000)) // e_block)
    t = n_blocks * e_block
    nfft = tb.block_fft_size(conf)
    n = s0 + (t + 4) * s0 + 2 * nfft + 4096
    x, tables, dops, delays = _sky(fs, n_channels, n, seed)
    taps = jnp.asarray([+0.25, 0.0, -0.25], jnp.float32)
    codes = jnp.asarray(tables)
    codes_rep = tb.code_spectra(conf, tables)
    st0 = _armed_state(conf, dops, delays)
    res = {}
    for label, ctx in _precisions():
        with ctx():
            st_e, out_e = trk.track_chunk(conf, t, codes, taps, x, st0)
            st_b, out_b = tb.track_chunk_blocks(conf, n_blocks, e_block,
                                                codes_rep, taps, x, st0)
            _, one = tb.track_chunk_blocks(conf, 1, e_block, codes_rep,
                                           taps, x, st0)
            jax.block_until_ready((out_e, out_b, one))
        res[label] = (st_e, out_e, st_b, out_b, one)

    ref = block_correlations_f64(conf, x, st0, np.asarray(codes_rep),
                                 np.asarray(taps), e_block)   # [C, E, K]
    p64 = ref[:, :, 1].T
    scale = float(np.abs(p64).mean())
    tol_f64 = CORR_TOL + epoch_grid_bound(conf, e_block)
    for label, (st_e, out_e, st_b, out_b, one) in res.items():
        err = max(
            float(np.abs(np.asarray(one["prompt"]) - p64).max()),
            float(np.abs(np.asarray(one["early_mag"])
                         - np.abs(ref[:, :, 0].T)).max()),
            float(np.abs(np.asarray(one["late_mag"])
                         - np.abs(ref[:, :, 2].T)).max())) / scale
        p_e = np.asarray(out_e["prompt"])
        p_b = np.asarray(out_b["prompt"])
        rel = np.abs(p_b - p_e) / np.abs(p_e).mean()
        pos_d = int(np.abs(np.asarray(out_e["pos_start"], np.int64)
                           - np.asarray(out_b["pos_start"], np.int64)).max())
        # Doppler over the last 100 epochs: the per-epoch PLL's output
        # carries its proportional term, which jitters epoch to epoch
        dop_e = float(np.abs(np.asarray(out_e["carrier_doppler_hz"])[
            -100:].mean(axis=0) - dops).max())
        dop_b = float(np.abs(np.asarray(out_b["carrier_doppler_hz"])[
            -100:].mean(axis=0) - dops).max())
        say("kernels", card,
            f"block kernel fs={fs / 1e6:g}Msps C={n_channels} T={t} "
            f"precision={label}: EPL vs float64 {err:.3e} of mean|P| "
            f"(tol {tol_f64:.3g} = {CORR_TOL:g} + float32 epoch-grid "
            f"bound); vs per-epoch kernel median "
            f"{np.median(rel):.3e} max {rel.max():.3e} (tol "
            f"{KERNEL_AGREE[0]:g}/{KERNEL_AGREE[1]:g}); pos_start diff "
            f"{pos_d} (tol 2); mean Doppler error over the last 100 "
            f"epochs: per-epoch {dop_e:.3f} Hz, block {dop_b:.3f} Hz (tol "
            f"{DOPPLER_TOL_HZ:g})")
        res[label] = dict(err_f64=err, med=float(np.median(rel)),
                          max=float(rel.max()), bit_hist=np.asarray(
                              st_b.bit_hist), epl=np.stack([
                                  np.asarray(one[k]).astype(np.complex64)
                                  for k in ("early_mag", "prompt",
                                            "late_mag")]))
        check(np.median(rel) < KERNEL_AGREE[0] and rel.max() < KERNEL_AGREE[1],
              f"block vs per-epoch prompts at {fs} Hz ({label})")
        check(pos_d <= 2 and dop_e < DOPPLER_TOL_HZ
              and dop_b < DOPPLER_TOL_HZ,
              f"kernel bookkeeping / Doppler at {fs} Hz ({label})")
        check(np.asarray(st_b.active).all()
              and not np.asarray(st_b.lock_lost).any(),
              f"block kernel lost lock at {fs} Hz ({label})")
    check(np.array_equal(res["default"]["bit_hist"],
                         res["highest"]["bit_hist"]),
          f"bit-sync histogram differs between precisions at {fs} Hz")
    gap = _precision_gap({k: v["epl"] for k, v in res.items()}, scale)
    say("kernels", card,
        f"block kernel fs={fs / 1e6:g}Msps EPL default vs highest {gap:.3e} "
        f"of mean|P| (tol {CORR_TOL:g})")
    check(res["default"]["err_f64"] <= tol_f64 and gap <= CORR_TOL,
          f"block kernel EPL vs float64 at {fs} Hz: "
          f"{res['default']['err_f64']:.3e}, precision gap {gap:.3e}")
    return res


def _check_correlator(card, fs, n_channels, seed):
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.models import tracking as trk
    from gnss_sim_receiver_tpu.ops import correlator

    conf = trk.TrackingConf(fs=fs)
    s0 = conf.nominal_epoch_samples
    x, tables, dops, delays = _sky(fs, n_channels, 4 * s0 + conf.block_size,
                                   seed)
    rng = np.random.default_rng(seed)
    taps = np.asarray([+0.25, 0.0, -0.25], np.float32)
    f0 = (conf.code_rate_cps * (1.0 + dops / conf.carrier_freq_hz)
          ).astype(np.float32)
    rem_code = rng.uniform(0, 1, n_channels).astype(np.float32)
    rem_carr = rng.uniform(0, 2 * np.pi, n_channels).astype(np.float32)
    n_c = np.full(n_channels, s0, np.int32)
    blocks = correlator.gather_blocks(x, jnp.asarray(delays, jnp.int32),
                                      conf.block_size)
    k_ovs = tables.shape[1] // conf.code_length_chips
    ref, bound = correlator_f64(blocks, tables, taps, rem_code, f0,
                                rem_carr, dops.astype(np.float32), n_c, fs,
                                k_ovs)
    scale = float(np.abs(ref[:, 1]).mean())
    errs, outs = {}, {}
    for label, ctx in _precisions():
        with ctx():
            got = np.asarray(correlator.correlate_multitap(
                blocks, jnp.asarray(tables), jnp.asarray(taps),
                jnp.asarray(rem_code), jnp.asarray(f0),
                jnp.asarray(rem_carr), jnp.asarray(dops, jnp.float32),
                jnp.asarray(n_c), fs, table_oversample=k_ovs))
        errs[label] = float(np.maximum(np.abs(got - ref) - bound, 0.0)
                            .max()) / scale
        outs[label] = got
    gap = _precision_gap(outs, scale)
    say("kernels", card,
        f"per-epoch correlator fs={fs / 1e6:g}Msps [C,K,B]=[{n_channels},3,"
        f"{conf.block_size}] vs float64, beyond the index-rounding bound "
        f"(max {bound.max() / scale:.3e}): default {errs['default']:.3e} "
        f"highest {errs['highest']:.3e}; default vs highest {gap:.3e}; of "
        f"mean|P| (tol {CORR_TOL:g})")
    check(errs["default"] <= CORR_TOL and gap <= CORR_TOL,
          f"correlator at {fs} Hz")
    return errs


def _check_kf(card, n_channels, seed):
    import jax
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.models import tracking as trk

    conf = trk.TrackingConf(tracking_mode="kf", enable_fll_pullin=False)
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_channels, 4, 4)) * np.sqrt(
        [0.1, 0.1, 100.0, 10.0])[None, :, None]
    p = (np.einsum("cij,ckj->cik", a, a) / 4.0).astype(np.float32)
    st = trk._init_state(n_channels)._replace(kf_p=jnp.asarray(p))
    t_int = np.full(n_channels, 1e-3, np.float32)
    zeros = jnp.zeros(n_channels, jnp.float32)
    ref = kf_covariance_f64(conf, p.astype(np.float64), 1e-3)
    sd = np.sqrt(np.abs(np.einsum("cii->ci", ref)))
    norm = sd[:, :, None] * sd[:, None, :]
    errs, outs = {}, {}
    for label, ctx in _precisions():
        with ctx():
            out = jax.jit(trk._kf_update, static_argnums=0)(
                conf, st, zeros.astype(jnp.complex64), zeros, zeros,
                jnp.asarray(t_int))
            got = np.asarray(out[4])
        errs[label] = float((np.abs(got - ref) / norm).max())
        outs[label] = got
    gap = _precision_gap(outs, norm)
    say("kernels", card,
        f"KF covariance update [C,4,4]=[{n_channels},4,4] vs float64: "
        f"default {errs['default']:.3e} highest {errs['highest']:.3e}; "
        f"default vs highest {gap:.3e}; of sqrt(P_ii P_jj) (tol {KF_TOL:g})")
    check(errs["default"] <= KF_TOL and gap <= KF_TOL, "KF covariance update")
    return errs


def _check_pcps(card, n_prns, n_delays, n_dwells, seed):
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.ops import pcps, prn_codes

    fs = n_delays * 1000.0
    rng = np.random.default_rng(seed)
    x, _, _, _ = _sky(fs, n_prns, n_dwells * n_delays, seed)
    x = np.asarray(x).reshape(n_dwells, n_delays) + (
        rng.standard_normal((n_dwells, n_delays))
        + 1j * rng.standard_normal((n_dwells, n_delays))) * 0.7
    sampled = np.stack([prn_codes.sample_code(prn_codes.gps_l1_ca_code(p),
                                              fs, GPS_CA_RATE, n_delays)
                        for p in range(1, n_prns + 1)])
    cfc = np.conj(np.fft.fft(sampled, axis=-1))
    dops = pcps.doppler_grid(5000.0, 250.0)
    t = np.arange(n_delays) / fs
    wiped = x[:, None, :] * np.exp(-2j * np.pi * dops.astype(np.float64)[
        :, None] * t)[None]
    corr = np.fft.ifft(np.fft.fft(wiped, axis=-1)[:, None]
                       * cfc[None, :, None, :], axis=-1)
    ref = (np.abs(corr) ** 2).sum(axis=0)                      # [C, D, N]
    errs, outs = {}, {}
    for label, ctx in _precisions():
        with ctx():
            got = np.asarray(pcps.pcps_grid(
                jnp.asarray(x.astype(np.complex64)),
                jnp.asarray(cfc.astype(np.complex64)), jnp.asarray(dops),
                fs))
        errs[label] = float(np.abs(got - ref).max() / ref.max())
        outs[label] = got
    gap = _precision_gap(outs, ref.max())
    say("kernels", card,
        f"PCPS grid [C,D,N]=[{n_prns},{len(dops)},{n_delays}] x "
        f"{n_dwells} dwells vs float64: default {errs['default']:.3e} "
        f"highest {errs['highest']:.3e}; default vs highest {gap:.3e}; of "
        f"peak (tol {PCPS_TOL:g})")
    check(errs["default"] <= PCPS_TOL and gap <= PCPS_TOL, "PCPS grid")
    return errs


def _check_fir(card, n_samples, seed):
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.ops import filters

    rng = np.random.default_rng(seed)
    x = (np.round(rng.standard_normal(n_samples) * 150.0)
         + 1j * np.round(rng.standard_normal(n_samples) * 150.0))
    taps = filters.design_lowpass(5, 0.45)
    decim = 2
    pad = len(taps) // 2
    full = np.convolve(x, taps.astype(np.float64))
    ref = full[len(taps) - 1 - pad:len(taps) - 1 - pad + n_samples][::decim]
    rms = float(np.sqrt(np.mean(np.abs(ref) ** 2)))
    errs, outs = {}, {}
    for label, ctx in _precisions():
        with ctx():
            got = np.asarray(filters.fir_filter(
                jnp.asarray(x.astype(np.complex64)), jnp.asarray(taps),
                decim))
        check(got.shape == ref.shape, f"FIR shape {got.shape}")
        errs[label] = float(np.abs(got - ref).max()) / rms
        outs[label] = got
    gap = _precision_gap(outs, rms)
    say("kernels", card,
        f"FIR decimator N={n_samples} taps={len(taps)} decim={decim} vs "
        f"float64: default {errs['default']:.3e} highest "
        f"{errs['highest']:.3e}; default vs highest {gap:.3e}; of RMS (tol "
        f"{FIR_TOL:g})")
    check(errs["default"] <= FIR_TOL and gap <= FIR_TOL, "FIR decimator")
    return errs


def phase_kernels(card: str, rates=RATES, n_channels: int = 12,
                  seconds: float = 1.0, n_prns: int = 12,
                  n_delays: int = 2000, n_dwells: int = 2,
                  fir_samples: int = 4_000_000, seed: int = 1) -> dict:
    out = {}
    for fs in rates:
        out[("block", fs)] = _check_block_kernel(card, fs, n_channels,
                                                 seconds, seed)
        out[("corr", fs)] = _check_correlator(card, fs, n_channels, seed)
    out["kf"] = _check_kf(card, n_channels, seed)
    out["pcps"] = _check_pcps(card, n_prns, n_delays, n_dwells, seed)
    out["fir"] = _check_fir(card, fir_samples, seed)
    return out


# -------------------------------------------------------------- receiver

_SKY_OFFSETS = [(0.0, 0.0), (40.0, 15.0), (-35.0, 20.0), (15.0, 55.0),
                (-20.0, -50.0), (45.0, -25.0), (-45.0, -15.0), (5.0, -60.0),
                (30.0, 40.0), (-10.0, 62.0), (25.0, -42.0), (-28.0, 47.0)]
_T0_GPS = 345600.0
_RX_LLH = (40.0, -75.0, 100.0)


def _rx_true():
    from gnss_sim_receiver_tpu.utils import geodesy
    return geodesy.llh_to_ecef(np.radians(_RX_LLH[0]),
                               np.radians(_RX_LLH[1]), _RX_LLH[2])


def position_errors(positions_ecef) -> tuple[float, float]:
    """(2D, 3D) error of the mean of `positions_ecef` against truth."""
    from gnss_sim_receiver_tpu.utils import geodesy
    ref = (np.radians(_RX_LLH[0]), np.radians(_RX_LLH[1]))
    enu = geodesy.ecef_to_enu(np.mean(positions_ecef, axis=0) - _rx_true(),
                              ref)
    return float(np.linalg.norm(enu[:2])), float(np.linalg.norm(enu))


def phase_receiver(card: str, duration_s: float = 120.0, n_sats: int = 12,
                   n_channels: int = 12, fs: float = 2_000_000.0,
                   seed: int = 3) -> dict:
    """Receiver.process_array on a device-resident static scenario, once
    cold and once warm."""
    import jax

    from gnss_sim_receiver_tpu.models.receiver import Receiver, ReceiverConf
    from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
    from gnss_sim_receiver_tpu.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu.sim.scenario import build_static_scenario

    ephs = make_sky_constellation(_RX_LLH[0], _RX_LLH[1], toe=_T0_GPS + 600,
                                  offsets_deg=_SKY_OFFSETS[:n_sats])
    sats = build_static_scenario(ephs, _rx_true(), _T0_GPS, duration_s,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband_device_resident(sats, fs, int(fs * duration_s),
                                          seed=seed)
    jax.block_until_ready(x)
    conf = ReceiverConf(fs=fs, prns=tuple(range(1, n_sats + 1)),
                        max_channels=n_channels,
                        max_acq_channels=n_channels, pvt_rate_ms=500)
    walls = []
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(Receiver(conf).process_array(x))
        walls.append(time.perf_counter() - t0)
    cold, warm = runs
    n_fix = len(warm.solutions)
    # a fix needs subframes 1-3 (18 s of LNAV at the earliest, 30 s at
    # the latest); from then on one every pvt_rate_ms
    min_fixes = int((duration_s - 36.0) / 0.5)
    err2d, err3d = (position_errors([s.rx_ecef_m for s in warm.solutions])
                    if n_fix else (float("inf"), float("inf")))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    say("receiver", card,
        f"{n_sats} sats, {n_channels} channels, {fs / 1e6:g} Msps, "
        f"{duration_s:g} s: fixes cold={len(cold.solutions)} warm={n_fix} "
        f"(>= {min_fixes}); mean position error 2D={err2d:.3f} m (< 2) "
        f"3D={err3d:.3f} m (< 5)")
    say("receiver", card,
        f"warm wall {walls[1]:.3f} s = {duration_s / walls[1]:.2f} s of "
        f"signal per wall second; compile/set-up (cold - warm) "
        f"{walls[0] - walls[1]:.3f} s; peak_bytes_in_use "
        f"{peak if peak is not None else 'not reported'}")
    check(n_fix >= min_fixes and len(cold.solutions) == n_fix,
          f"receiver fixes: cold {len(cold.solutions)} warm {n_fix}")
    check(err2d < 2.0 and err3d < 5.0,
          f"receiver position error 2D {err2d:.3f} m 3D {err3d:.3f} m")
    return dict(walls=walls, n_fix=n_fix, err2d=err2d, err3d=err3d,
                peak_bytes=peak)


# ------------------------------------------------------------------- cli


def phase_cli(card: str, duration_s: float = 40.0, n_sats: int = 6,
              seed: int = 42, conf_path: str = ISHORT_CONF) -> dict:
    """The canonical file receiver through the CLI's `main`: a simulated
    ishort capture at the conf's rate, conditioned (FIR, decimation) and
    processed; the printed mean position is checked against truth."""
    from gnss_sim_receiver_tpu.__main__ import main as cli_main
    from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
    from gnss_sim_receiver_tpu.sim.device_generator import \
        generate_baseband_device
    from gnss_sim_receiver_tpu.sim.scenario import build_static_scenario
    from gnss_sim_receiver_tpu.utils import geodesy
    from gnss_sim_receiver_tpu.utils.config import FileConfiguration
    from gnss_sim_receiver_tpu.utils.sample_io import write_samples

    conf = FileConfiguration(conf_path)
    fs_in = float(conf.property("SignalSource.sampling_frequency", 0))
    ephs = make_sky_constellation(_RX_LLH[0], _RX_LLH[1], toe=_T0_GPS + 600,
                                  offsets_deg=_SKY_OFFSETS[:n_sats])
    sats = build_static_scenario(ephs, _rx_true(), _T0_GPS, duration_s,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband_device(sats, fs_in, int(fs_in * duration_s),
                                 seed=seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cap = os.path.join(tmp, "capture.ishort")
        write_samples(cap, x, "ishort", scale=200.0)
        del x
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([f"--config_file={conf_path}",
                           f"--signal_file={cap}"])
        wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"[cli] | {line}")
    mean = [ln for ln in text.splitlines() if ln.startswith("Mean position")]
    err3d = float("inf")
    if mean:
        kv = dict(item.split("=") for item in mean[0].split()
                  if "=" in item)
        pos = geodesy.llh_to_ecef(np.radians(float(kv["lat"])),
                                  np.radians(float(kv["lon"])),
                                  float(kv["h"]))
        err3d = float(np.linalg.norm(np.asarray(pos) - _rx_true()))
    say("cli", card,
        f"{os.path.basename(conf_path)}: {n_sats} sats, {duration_s:g} s at "
        f"{fs_in / 1e6:g} Msps: rc={rc}, mean position 3D error "
        f"{err3d:.3f} m (< 5), wall {wall:.3f} s")
    check(rc == 0, f"CLI returned {rc}")
    check(err3d < 5.0, f"CLI mean position error {err3d:.3f} m")
    return dict(rc=rc, err3d=err3d, wall=wall)


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is "
              f"{backend}", file=sys.stderr)
        return 1
    import gnss_sim_receiver_tpu  # noqa: F401  (sets the compile cache)

    info = phase_device()
    card = info["card"]
    phase_fft(card)
    phase_kernels(card)
    phase_receiver(card)
    phase_cli(card)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

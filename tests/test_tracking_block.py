"""Direct unit tests of the block-processing tracking kernel
(models.tracking_block) against the per-epoch kernel on identical
TrackState — prompts, sample bookkeeping, Doppler and code phase must
agree within tight numeric bounds.

Reference analogue: the dump-compare discipline of
src/tests/unit-tests/signal-processing-blocks/tracking/ applied between
the repo's own two kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gnss_sim_receiver_tpu.models import tracking as trk
from gnss_sim_receiver_tpu.models import tracking_block as tb
from gnss_sim_receiver_tpu.ops import prn_codes
from gnss_sim_receiver_tpu.sim import SatelliteSignalParams, generate_baseband

FS = 2_000_000.0
F_L1 = 1575.42e6
CODE_RATE = 1.023e6
E_BLOCK = 20
N_BLOCKS = 5
T = E_BLOCK * N_BLOCKS


def _armed_state(conf, prns, dops, delay_samples):
    """Identical armed state for both kernels, EXACTLY on truth (pull-in
    already done — the regime where the receiver switches to the block
    kernel): integer-sample code starts, carrier NCO phase matching the
    simulator's exp(j*2*pi*f_d*t) at the start sample."""
    c = len(prns)
    st = trk._init_state(c)
    for ch in range(c):
        f0 = conf.code_rate_cps * (1.0 + dops[ch] / conf.carrier_freq_hz)
        st = trk._arm_channel(st, ch, float(dops[ch]), float(f0))
    pos = np.asarray(delay_samples, np.int64)
    phase0 = np.mod(2.0 * np.pi * np.asarray(dops) * pos / FS,
                    2.0 * np.pi).astype(np.float32)
    return st._replace(pos=jnp.asarray(pos.astype(np.int32)),
                       rem_carr_phase=jnp.asarray(phase0))


def _tables(conf, prns, provider=None):
    """Band-limited replica tables for BOTH kernels (the TrackingEngine
    convention — one shared replica waveform)."""
    provider = provider or prn_codes.gps_l1_ca_code
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        np.asarray(provider(p), np.float32), conf.fs, conf.code_rate_cps,
        conf.nominal_epoch_samples) for p in prns])
    return jnp.asarray(tables), tb.code_spectra(conf, tables)


def test_block_vs_per_epoch_equivalence():
    prns = [5, 13, 27]
    dops = [-2400.0, 0.0, 3100.0]
    delay_samples = [587, 980, 1520]
    delays = [n * CODE_RATE / FS for n in delay_samples]
    bits = np.ones(64, np.int8)
    sats = [SatelliteSignalParams(prn=p, cn0_db_hz=50.0, doppler_hz=d,
                                  delay_chips=dl, nav_bits=bits)
            for p, d, dl in zip(prns, dops, delays)]
    n_samp = max(delay_samples) + (T + 4) * 2000 + 4096
    x = generate_baseband(sats, FS, n_samp, noise=False)
    x_dev = jnp.asarray(x)

    conf = trk.TrackingConf(fs=FS, enable_fll_pullin=False)
    taps = jnp.asarray([+0.25, 0.0, -0.25], jnp.float32)
    codes, codes_fft = _tables(conf, prns)
    st0 = _armed_state(conf, prns, dops, delay_samples)

    st_e, out_e = trk.track_chunk(conf, T, codes, taps, x_dev, st0)
    st_b, out_b = tb.track_chunk_blocks(conf, N_BLOCKS, E_BLOCK, codes_fft,
                                        taps, x_dev, st0)

    p_e = np.asarray(out_e["prompt"])
    p_b = np.asarray(out_b["prompt"])
    scale = np.abs(p_e).mean()
    # prompt complex agreement (DTFT phasor-lag correlator vs time-domain
    # gather correlator): a couple of percent of the prompt amplitude
    rel = np.abs(p_b - p_e) / scale
    assert np.median(rel) < 0.01, np.median(rel)
    assert rel.max() < 0.05, rel.max()
    # early/late: the band-limited replica's correlation shape sits
    # ~12% above the sampled triangle at +-0.25 chips (symmetric — no
    # lock-point bias, slightly different DLL gain); magnitudes must be
    # within 20% and the E/L BALANCE (the discriminator input) must
    # agree at lock
    for k in ("early_mag", "late_mag"):
        d = np.abs(np.asarray(out_b[k]) - np.asarray(out_e[k])) / scale
        assert np.median(d) < 0.2, (k, np.median(d))
    bal_b = (np.asarray(out_b["early_mag"]) - np.asarray(out_b["late_mag"]))
    bal_e = (np.asarray(out_e["early_mag"]) - np.asarray(out_e["late_mag"]))
    assert np.abs(np.median(bal_b, axis=0)
                  - np.median(bal_e, axis=0)).max() / scale.mean() < 0.05

    # sample bookkeeping: closed-form epoch boundaries must track the
    # per-epoch rounding to <= 2 samples (rates differ only by loop noise)
    ps_e = np.asarray(out_e["pos_start"], np.int64)
    ps_b = np.asarray(out_b["pos_start"], np.int64)
    assert np.abs(ps_e - ps_b).max() <= 2
    assert np.abs(np.asarray(st_e.pos) - np.asarray(st_b.pos)).max() <= 2

    # loop outputs: both kernels must hold the clean signal at truth
    for st in (st_e, st_b):
        assert np.abs(np.asarray(st.carrier_doppler) - dops).max() < 2.0
        assert np.asarray(st.active).all()
        assert not np.asarray(st.lock_lost).any()
    # code phase at epoch end (samples): same convention, sub-sample agree
    cp_e = np.asarray(out_e["code_phase_samples"])[-E_BLOCK:]
    cp_b = np.asarray(out_b["code_phase_samples"])[-E_BLOCK:]
    assert np.abs(cp_e - cp_b).max() < 0.1
    # accumulated carrier phase after 100 ms (carrier-phase observable)
    ac_e = np.asarray(out_e["acc_phase_cycles"])[-1]
    ac_b = np.asarray(out_b["acc_phase_cycles"])[-1]
    assert np.abs(ac_e - ac_b).max() < 0.05
    # C/N0: clean-signal estimates land high for both
    assert (np.asarray(st_b.cn0_db_hz) > 45.0).all()


def test_block_data_prompt_matches_per_epoch():
    """track_pilot: the data-component prompt (the path that shipped
    broken in r3) must match the per-epoch data correlator."""
    pilot_prn, data_prn = 3, 17
    dop = 1200.0
    delay_n = 821
    delay = delay_n * CODE_RATE / FS
    bits = np.ones(64, np.int8)
    sats = [SatelliteSignalParams(prn=pilot_prn, cn0_db_hz=50.0,
                                  doppler_hz=dop, delay_chips=delay,
                                  nav_bits=bits),
            SatelliteSignalParams(prn=data_prn, cn0_db_hz=50.0,
                                  doppler_hz=dop, delay_chips=delay,
                                  nav_bits=bits)]
    n_samp = delay_n + (T + 4) * 2000 + 4096
    x = jnp.asarray(generate_baseband(sats, FS, n_samp, noise=False))

    conf = trk.TrackingConf(fs=FS, enable_fll_pullin=False, track_pilot=True)
    taps = jnp.asarray([+0.25, 0.0, -0.25], jnp.float32)
    codes, codes_fft = _tables(conf, [pilot_prn])
    data_codes, data_codes_fft = _tables(conf, [data_prn])
    st0 = _armed_state(conf, [pilot_prn], [dop], [delay_n])

    _, out_e = trk.track_chunk(conf, T, codes, taps, x, st0,
                               data_codes=data_codes)
    _, out_b = tb.track_chunk_blocks(conf, N_BLOCKS, E_BLOCK, codes_fft,
                                     taps, x, st0,
                                     data_codes_rep=data_codes_fft)
    d_e = np.asarray(out_e["prompt"])     # data prompt in track_pilot mode
    d_b = np.asarray(out_b["prompt"])
    scale = np.abs(d_e).mean()
    assert scale > 0
    rel = np.abs(d_b - d_e) / scale
    assert np.median(rel) < 0.02, np.median(rel)
    assert rel.max() < 0.08, rel.max()
    # data energy concentrated in I (carrier tracked on the pilot)
    assert np.abs(d_b.real).mean() > 5 * np.abs(d_b.imag).mean()


def test_block_kernel_state_interop():
    """Chunks may alternate kernels: per-epoch -> block -> per-epoch on
    the same state must keep tracking (the receiver's actual handoff)."""
    prn, dop = 9, -800.0
    delay_n = 500
    delay = delay_n * CODE_RATE / FS
    bits = np.ones(64, np.int8)
    sats = [SatelliteSignalParams(prn=prn, cn0_db_hz=49.0, doppler_hz=dop,
                                  delay_chips=delay, nav_bits=bits)]
    n_samp = delay_n + (3 * T + 8) * 2000 + 4096
    x = jnp.asarray(generate_baseband(sats, FS, n_samp, noise=False))
    conf = trk.TrackingConf(fs=FS, enable_fll_pullin=False)
    taps = jnp.asarray([+0.25, 0.0, -0.25], jnp.float32)
    codes, codes_fft = _tables(conf, [prn])
    st = _armed_state(conf, [prn], [dop], [delay_n])

    st, _ = trk.track_chunk(conf, T, codes, taps, x, st)
    st, _ = tb.track_chunk_blocks(conf, N_BLOCKS, E_BLOCK, codes_fft,
                                  taps, x, st)
    st, out = trk.track_chunk(conf, T, codes, taps, x, st)
    assert bool(np.asarray(st.active)[0])
    assert not bool(np.asarray(st.lock_lost)[0])
    assert abs(float(np.asarray(st.carrier_doppler)[0]) - dop) < 2.0
    p = np.asarray(out["prompt"])[:, 0]
    assert np.abs(p.real).mean() > 5 * np.abs(p.imag).mean()


def test_block_mode_pullin_from_acquisition_errors():
    """The block kernel's own FLL + wide-DLL staging pulls in straight
    from acquisition-grade handoff errors (+200 Hz Doppler off the grid,
    ~1.5 samples of code error) — the receiver no longer needs a
    per-epoch pull-in phase for non-secondary chains."""
    prn, dop_true = 21, 1700.0
    delay_n = 700
    delay = delay_n * CODE_RATE / FS
    # RANDOM nav bits: a flip between two prompts rails that pair's
    # cross-dot discriminator, which is exactly the failure mode the
    # block FLL's median estimator exists for
    rng = np.random.default_rng(7)
    bits = np.where(rng.random(128) < 0.5, 1, -1).astype(np.int8)
    sats = [SatelliteSignalParams(prn=prn, cn0_db_hz=42.0,
                                  doppler_hz=dop_true, delay_chips=delay,
                                  nav_bits=bits)]
    n_blocks = 120                     # 2.4 s
    n_samp = delay_n + (n_blocks * E_BLOCK + 8) * 2000 + 4096
    x = jnp.asarray(generate_baseband(sats, FS, n_samp, noise=True,
                                      seed=11))
    conf = trk.TrackingConf(fs=FS)     # FLL pull-in ON (default)
    taps = jnp.asarray([+0.25, 0.0, -0.25], jnp.float32)
    _, codes_fft = _tables(conf, [prn])
    # arm WITH the errors: acquisition-grid-edge -125 Hz, 2 samples late
    st = _armed_state(conf, [prn], [dop_true - 125.0], [delay_n])
    st = st._replace(pos=st.pos + 2)
    st, out = tb.track_chunk_blocks(conf, n_blocks, E_BLOCK, codes_fft,
                                    taps, x, st)
    assert bool(np.asarray(st.active)[0])
    assert not bool(np.asarray(st.lock_lost)[0])
    assert abs(float(np.asarray(st.carrier_doppler)[0]) - dop_true) < 5.0
    # last 10 blocks phase-locked: prompt I dominates Q
    p = np.asarray(out["prompt"])[-200:, 0]
    assert np.abs(p.real).mean() > 2.5 * np.abs(p.imag).mean()
    assert float(np.asarray(st.cn0_db_hz)[0]) > 38.0


@pytest.mark.parametrize("fs", [2e6, 4e6, 20e6])
def test_block_fft_route_matches_float64(fs):
    """The block kernel's FFT route (shared window spectra and Doppler-
    ramped replica spectra) against NumPy float64 at the kernel's own
    FFT length (block_fft_size) for each sample rate."""
    conf = trk.TrackingConf(fs=fs)
    s0 = conf.nominal_epoch_samples
    nfft = tb.block_fft_size(conf)
    rng = np.random.default_rng(int(fs) % 1000)
    n = 24 * s0
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    got = np.asarray(tb._window_spectra(jnp.asarray(x), s0, nfft))
    xp = np.concatenate([np.zeros(tb._LEAD), x, np.zeros(nfft)])
    idx = (np.arange(got.shape[0]) * s0)[:, None] + np.arange(nfft)
    ref = np.fft.fft(xp[idx], axis=-1)
    assert got.shape == ((n + tb._LEAD - nfft) // s0 + 1, nfft)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    codes = np.zeros((3, nfft), np.float32)
    codes[:, :s0] = rng.choice([-1.0, 1.0], (3, s0))
    omega = (2 * np.pi * np.array([-4000.0, 0.0, 3100.0]) / fs
             ).astype(np.float32)
    got_r = np.asarray(tb._replica_spectra(jnp.asarray(codes),
                                           jnp.asarray(omega)))
    ref_r = np.conj(np.fft.fft(
        codes * np.exp(1j * omega.astype(np.float64)[:, None]
                       * np.arange(nfft)), axis=-1))
    assert np.abs(got_r - ref_r).max() <= 1e-5 * np.abs(ref_r).max()

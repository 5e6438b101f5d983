"""Device-side batch signal synthesizer.

Same signal model as sim.signal_generator (the bladeGPS/gnss-sim role:
rectangular chips, linearized delay/Doppler per 8192-sample anchor block,
C/N0-scaled amplitude, complex AWGN) but synthesized for ALL satellites at
once on the accelerator: per-(sat, block) anchors are computed host-side
in float64 (cheap: n/8192 per sat), and the per-sample float32 expansion —
two gathers (code chip, nav symbol) + carrier rotation + sum over
satellites — runs as one fused XLA program per sample chunk.

A 48-satellite, 4.092 Msps, 20 s scenario takes minutes in the host
NumPy path and seconds here; chip_smoke.py's receiver phase uses the
device-resident form.
Numerical parity with the host generator is float32-rounding level
(tests/test_device_generator.py).
"""

from __future__ import annotations

import functools

import numpy as np

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.sim import signal_generator as sg

_B = 8192               # anchor block (matches sg._ANCHOR_BLOCK semantics)


@functools.partial(
    __import__("jax").jit, static_argnames=("b", "with_noise"))
def _expand_chunk(codes, code_len, bits, bits_len, sc_per_sym,
                  base, frac, crate, ph0, phr, amp, key, b, with_noise):
    """[S]-batched per-sample expansion of one chunk.

    codes [S, Lc]  +-1 sub-chip tables (padded); code_len [S]
    bits  [S, Nb]  +-1 nav symbol signs (padded);  bits_len [S]
    sc_per_sym [S] sub-chips per nav symbol
    base [S, nblk] int32 global sub-chip index at block anchor
    frac/crate/ph0/phr [S, nblk] f32 linearization coefficients
    -> complex64 [nblk * b]
    """
    import jax
    import jax.numpy as jnp

    nloc = jnp.arange(b, dtype=jnp.float32)
    chip_off = frac[..., None] + crate[..., None] * nloc       # [S,nblk,b]
    k = base[..., None] + jnp.floor(chip_off).astype(jnp.int32)

    def one_sat(code_s, lc_s, bits_s, nb_s, sps_s, k_s):
        chip = code_s[jnp.mod(k_s, lc_s)]
        sym = bits_s[jnp.mod(k_s // sps_s, nb_s)]
        return chip * sym

    cv = jax.vmap(one_sat)(codes, code_len, bits, bits_len,
                           sc_per_sym, k.reshape(k.shape[0], -1))
    ph = (ph0[..., None] + phr[..., None] * nloc).reshape(cv.shape)
    av = amp[:, None]
    re = (cv * av * jnp.cos(ph)).sum(axis=0)
    im = (cv * av * jnp.sin(ph)).sum(axis=0)
    if with_noise:
        n = jax.random.normal(key, (2, re.shape[0]), dtype=jnp.float32)
        s = jnp.float32(np.sqrt(0.5))
        re = re + s * n[0]
        im = im + s * n[1]
    return jax.lax.complex(re, im)


def _sat_tables(sats):
    """Padded code/bit tables + geometry params for the batch."""
    codes, bit_arrs, sps, lcs = [], [], [], []
    for sat in sats:
        code, _, sc_per_sym = sg._sig_params(sat)
        codes.append(np.asarray(code, np.float32))
        bit_arrs.append(np.asarray(sat.nav_bits, np.float32))
        sps.append(sc_per_sym)
        lcs.append(len(code))
    lc_max = max(lcs)
    nb_max = max(len(b) for b in bit_arrs)
    code_pad = np.zeros((len(sats), lc_max), np.float32)
    bits_pad = np.zeros((len(sats), nb_max), np.float32)
    for i, (c, b) in enumerate(zip(codes, bit_arrs)):
        code_pad[i, :len(c)] = c
        bits_pad[i, :len(b)] = b
    return (code_pad, np.asarray(lcs, np.int32), bits_pad,
            np.asarray([len(b) for b in bit_arrs], np.int32),
            np.asarray(sps, np.int32))


def _anchors(sats, fs, start_sample, nblk, amp_fs):
    """Host-side float64 per-(sat, block) linearization (the anchor math of
    sg._sat_signal_block, vectorized over sats x blocks)."""
    S = len(sats)
    f_c = constants.GPS_L1_FREQ_HZ
    base = np.zeros((S, nblk), np.int64)
    frac = np.zeros((S, nblk), np.float32)
    crate = np.zeros((S, nblk), np.float32)
    ph0 = np.zeros((S, nblk), np.float32)
    phr = np.zeros((S, nblk), np.float32)
    amp = np.zeros(S, np.float32)
    s_b = start_sample + _B * np.arange(nblk, dtype=np.float64)
    t_b = s_b / fs
    for i, sat in enumerate(sats):
        _, code_rate, _ = sg._sig_params(sat)
        icd_chip_rate = (code_rate / 2.0 if sat.signal in ("1B", "1P")
                         else code_rate)
        delay0 = sat.delay_sec + sat.delay_chips / icd_chip_rate
        dop_code0 = (sat.code_doppler_hz
                     if getattr(sat, "code_doppler_hz", None) is not None
                     else sat.doppler_hz)
        f_code = getattr(sat, "carrier_ref_hz", None) or f_c
        delay_b = delay0 - (dop_code0 / f_code) * t_b \
            - (sat.doppler_rate_hz_s / f_code) * t_b * t_b / 2.0
        chipf_b = (t_b - delay_b) * code_rate
        dop_b = sat.doppler_hz + sat.doppler_rate_hz_s * t_b
        dopc_b = dop_code0 + sat.doppler_rate_hz_s * t_b
        base[i] = np.floor(chipf_b).astype(np.int64)
        frac[i] = (chipf_b - np.floor(chipf_b)).astype(np.float32)
        crate[i] = (code_rate * (1.0 + dopc_b / f_code)
                    / fs).astype(np.float32)
        ph0[i] = np.mod(2.0 * np.pi * (sat.doppler_hz * t_b
                                       + sat.doppler_rate_hz_s
                                       * t_b * t_b / 2.0)
                        + sat.carrier_phase_rad,
                        2.0 * np.pi).astype(np.float32)
        phr[i] = (2.0 * np.pi * dop_b / fs).astype(np.float32)
        amp[i] = sg.cn0_to_amplitude(sat.cn0_db_hz, amp_fs or fs)
    return base, frac, crate, ph0, phr, amp


def generate_baseband_device(sats, fs: float, n_samples: int, *,
                             start_sample: int = 0, noise: bool = True,
                             seed: int = 0,
                             chunk_samples: int = 2_097_152) -> np.ndarray:
    """Drop-in device-accelerated generate_baseband (noise streams differ
    from the host path's — statistics match, realizations don't)."""
    import jax

    rng = np.random.default_rng(seed)
    for sat in sats:
        if sat.nav_bits is None:
            sat.nav_bits = (rng.integers(0, 2, 1500) * 2 - 1).astype(np.int8)
    codes, lcs, bits, nbs, sps = _sat_tables(sats)
    codes_d = jax.device_put(codes)
    bits_d = jax.device_put(bits)
    lcs_d, nbs_d, sps_d = map(jax.device_put, (lcs, nbs, sps))
    out = np.empty(n_samples, np.complex64)
    key = jax.random.PRNGKey(seed)
    # nav-symbol index must stay within the provided bit stream; global
    # sub-chip indices must fit int32
    pos = 0
    while pos < n_samples:
        n = min(chunk_samples, n_samples - pos)
        nblk = -(-n // _B)
        base, frac, crate, ph0, phr, amp = _anchors(
            sats, fs, start_sample + pos, nblk, None)
        if (base + int(np.ceil(crate.max() * _B)) + 1).max() >= 2 ** 31:
            raise OverflowError("scenario too long for int32 chip indices")
        key, sub = jax.random.split(key)
        chunk = _expand_chunk(
            codes_d, lcs_d, bits_d, nbs_d, sps_d,
            jax.device_put(base.astype(np.int32)),
            jax.device_put(frac), jax.device_put(crate),
            jax.device_put(ph0), jax.device_put(phr),
            jax.device_put(amp), sub, _B, bool(noise))
        out[pos:pos + n] = np.asarray(chunk)[:n]
        pos += n
    return out


def generate_baseband_device_resident(sats, fs: float, n_samples: int, *,
                                      start_sample: int = 0,
                                      noise: bool = True, seed: int = 0,
                                      chunk_samples: int = 4_194_304):
    """generate_baseband_device, but the capture STAYS ON DEVICE as one
    complex64 jax.Array — the zero-transfer input for
    Receiver.process_array (chip_smoke.py's receiver phase feeds this
    straight into tracking/acquisition; no sample crosses the host
    link)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for sat in sats:
        if sat.nav_bits is None:
            sat.nav_bits = (rng.integers(0, 2, 1500) * 2 - 1).astype(np.int8)
    codes, lcs, bits, nbs, sps = _sat_tables(sats)
    codes_d = jax.device_put(codes)
    bits_d = jax.device_put(bits)
    lcs_d, nbs_d, sps_d = map(jax.device_put, (lcs, nbs, sps))
    key = jax.random.PRNGKey(seed)
    parts = []
    pos = 0
    while pos < n_samples:
        n = min(chunk_samples, n_samples - pos)
        nblk = -(-n // _B)
        base, frac, crate, ph0, phr, amp = _anchors(
            sats, fs, start_sample + pos, nblk, None)
        if (base + int(np.ceil(crate.max() * _B)) + 1).max() >= 2 ** 31:
            raise OverflowError("scenario too long for int32 chip indices")
        key, sub = jax.random.split(key)
        chunk = _expand_chunk(
            codes_d, lcs_d, bits_d, nbs_d, sps_d,
            jax.device_put(base.astype(np.int32)),
            jax.device_put(frac), jax.device_put(crate),
            jax.device_put(ph0), jax.device_put(phr),
            jax.device_put(amp), sub, _B, bool(noise))
        parts.append(chunk[:n])
        pos += n
    x = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return x[:n_samples]

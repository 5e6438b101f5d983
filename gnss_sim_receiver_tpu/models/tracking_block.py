"""Block-processing tracking kernel: the receiver's steady-state path.

The per-epoch scan (models.tracking) runs one `lax.scan` step per code
epoch and gathers every channel's samples per epoch.  This kernel
restructures steady-state tracking:

- ONE scan step per BLOCK of `e_block` epochs (default 20 = one GPS bit;
  the loops close at block cadence with the narrow bandwidths — exactly
  the reference's extended-coherent-integration regime, states 3-4 of
  dll_pll_veml_tracking.cc:1933-2027);
- ONE shared set of window spectra for ALL channels: the chunk is cut
  into a fixed overlapping window grid (length ~2 code periods, stride
  one period) and FFT'd ONCE up front.  Each channel/epoch then reads its
  window, so FFT work does not scale with channels x epochs;
- carrier wipeoff moves into the REPLICA: each channel's band-limited
  code table is multiplied by its Doppler ramp exp(+j w n) and FFT'd
  per block ([C, F2]), which is exactly equivalent to
  wiping the signal (sum_n x[n] e^{-jwn} c[n-t] =
  e^{-jwt} sum_n x[n] g[n-t], g = c e^{-jwn}, and
  G[-f] = conj(FFT(c e^{+jwn}))); the leftover e^{-jw t} and the
  channel's carrier phase at the exact fractional epoch start are
  scalars folded into the lag/tap phasors.  No approximation — Doppler
  is NOT quantized to window bins;
- the E/P/L taps drop out of one einsum against per-epoch DTFT-exact
  fractional-lag phase ramps;
- epoch boundaries in closed form: with the code NCO rate constant
  within a block, the cumulative sample count of epoch e is EXACTLY
  round(e*S - u0) (S = code period in samples, u0 = phase offset), so
  per-epoch starts/lengths/outputs vectorize with no inner loop.

Approximations (each matching the reference's own extended mode or
corrected to first order):
- code-Doppler stretch within one epoch is ignored by the DFT replica
  (<= 0.004 chips at +-5 kHz); the resulting half-stretch lag bias is
  deterministic and corrected in the phasor lag;
- Doppler/code rates are held constant within a block (loops close per
  block, reference narrow-mode behavior).

FLL pull-in runs at block cadence for EVERY dll_pll chain: chains
without a secondary code use the four-quadrant cross-dot with a median
over the block's pairs; secondary-code chains (pre-sync) use the
two-quadrant decision-directed form (ops/discriminators
fll_cross_dot_decision) whose +-1/(4T) = +-250 Hz range covers the
+-125 Hz acquisition-grid error while being fully insensitive to the
secondary-chip flips that corrupt four-quadrant pairs — so ALL chains
hand off from acquisition straight into block mode.  Once the secondary
code is synced and wiped, the four-quadrant form takes over per channel.

State interop: consumes and produces the SAME TrackState as the
per-epoch kernel, so chunks can alternate kernels freely.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sim_receiver_tpu.models.tracking import (TrackState, TrackingConf,
                                                   N_SEC_MAX, _DECIM_F32)
from gnss_sim_receiver_tpu.ops import discriminators
from gnss_sim_receiver_tpu.ops import loop_filters as lf

# window grid lead: windows start LEAD samples before their s0-grid
# point so small negative epoch-start excursions (round(-u0) = -1, tap
# advance) stay inside the window
_LEAD = 16


def good_size(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n: a length the FFT
    library factors into small radices."""
    best = 1 << int(np.ceil(np.log2(max(n, 1))))
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < n:
                p2 *= 2
            best = min(best, p2)
            p3 *= 3
        p5 *= 5
    return best


def block_fft_size(conf: TrackingConf) -> int:
    """Shared-window FFT length: stride is one code period, so any
    epoch that STARTS inside window w's first period (plus the LEAD
    margin and the <=2-sample closed-form rounding drift) must FIT —
    one period for the start offset + one period of replica + tap
    margin, rounded up to a 5-smooth length."""
    s0 = conf.nominal_epoch_samples
    return good_size(2 * s0 + 2 * _LEAD + 32)


def code_spectra(conf: TrackingConf, code_tables, oversample: int = 8):
    """fs-sampled band-limited replica, zero-padded to the window FFT
    length -> [C, F2] float32 (device).  TIME domain: the kernel builds
    each block's replica SPECTRUM on device by applying the channel's
    Doppler ramp and FFT-ing (Doppler lives in the replica, see module
    docstring), so the host precomputes only the waveform.

    The replica is the band-limited sub-chip table
    (prn_codes.bandlimited_table_normalized) sampled at fs over one code
    period — the SAME waveform the per-epoch kernel gathers from, so
    amplitudes and DLL lock points agree between kernels (pseudorange
    conventions cancel in RTK double differences across handoffs).

    `code_tables` may be raw +-1 chip tables [C, L] (band-limited and
    normalized here) or prebuilt band-limited tables [C, L*K]
    (TrackingEngine.codes).  Host-side precompute, not a hot path.
    """
    from gnss_sim_receiver_tpu.ops import prn_codes

    nfft = block_fft_size(conf)
    s0 = conf.nominal_epoch_samples
    tables = np.asarray(code_tables, np.float32)
    l = conf.code_length_chips
    k = tables.shape[1] // l
    if k == 1:
        tables = np.stack([
            prn_codes.bandlimited_table_normalized(
                row, conf.fs, conf.code_rate_cps, s0, oversample)
            if np.any(row) else
            np.zeros(l * oversample, np.float32)
            for row in tables])
        k = oversample
    idx = (np.floor(np.arange(s0, dtype=np.float64)
                    * (conf.code_rate_cps / conf.fs) * k).astype(np.int64)
           % tables.shape[1])
    z = np.zeros((tables.shape[0], nfft), np.float32)
    z[:, :s0] = tables[:, idx]
    return jnp.asarray(z)


def _window_spectra(x_chunk: jax.Array, s0: int, nfft: int):
    """Overlapping fixed-grid windows (start w*s0 - LEAD, length nfft)
    over the whole chunk, FFT'd in one batch -> [W, F2] complex64.
    Built with a reshape+concat (no per-window dynamic slices)."""
    lead = _LEAD
    n = x_chunk.shape[0] + lead
    w = max(1, (n - nfft) // s0 + 1)
    k = (nfft + s0 - 1) // s0
    pad_to = (w + k) * s0
    xp = jnp.concatenate([
        jnp.zeros(lead, x_chunk.dtype), x_chunk,
        jnp.zeros(max(0, pad_to - n), x_chunk.dtype)])[:pad_to]
    rows = xp.reshape(w + k, s0)
    wins = jnp.concatenate([rows[i:w + i] for i in range(k)],
                           axis=1)[:, :nfft]
    return jnp.fft.fft(wins, axis=-1)


def _replica_spectra(codes_rep: jax.Array, omega: jax.Array) -> jax.Array:
    """Conjugate spectra of the Doppler-ramped block replicas -> [C, F2]:
    exp(+j w m) * code, FFT'd, is exactly the conjugate spectrum of the
    carrier-at-Doppler replica (see the module docstring)."""
    m = jax.lax.broadcasted_iota(jnp.float32, (1, codes_rep.shape[1]), 1)
    ramp = omega[:, None] * m                                  # [C, F2]
    rep_t = jax.lax.complex(codes_rep * jnp.cos(ramp),
                            codes_rep * jnp.sin(ramp))
    return jnp.conj(jnp.fft.fft(rep_t, axis=-1))


@partial(jax.jit, static_argnames=("conf", "n_blocks", "e_block"))
def track_chunk_blocks(conf: TrackingConf, n_blocks: int, e_block: int,
                       codes_rep: jax.Array, taps: jax.Array,
                       x_chunk: jax.Array, state: TrackState,
                       sec_code: jax.Array | None = None,
                       data_codes_rep: jax.Array | None = None):
    """Scan n_blocks blocks of e_block epochs each.  Returns
    (new_state, outs) with the same per-epoch [T, C] output planes as
    track_chunk (T = n_blocks*e_block).  `codes_rep` /
    `data_codes_rep` are the [C, F2] time-domain block replica tables
    from code_spectra()."""
    fs = conf.fs
    c_ch = codes_rep.shape[0]
    s0 = conf.nominal_epoch_samples
    nfft = block_fft_size(conf)
    k_taps = taps.shape[0]
    l_chips = jnp.float32(conf.code_length_chips)
    e_idx = jnp.arange(e_block, dtype=jnp.float32)            # [E]
    # SIGNED frequency bins: the fractional-lag shift theorem needs
    # f in [-N/2, N/2), not [0, N) (integer lags can't tell the
    # difference; fractional taps/lags absolutely can)
    f_raw = jnp.arange(nfft, dtype=jnp.float32)
    f_bins = jnp.where(f_raw >= nfft // 2, f_raw - nfft, f_raw)   # [F]
    two_pi = jnp.float32(2.0 * np.pi)

    # ---- shared window spectra, ONCE per chunk -------------------------
    xf_all = _window_spectra(x_chunk, s0, nfft)               # [W, F2]
    n_wins = xf_all.shape[0]

    prompt_i = k_taps // 2   # taps ordered [+d.. 0 ..-d]; center = prompt

    def body(st: TrackState, _):
        act = st.active
        rate = st.code_freq                                    # [C] chips/s
        dop = st.carrier_doppler                               # [C]
        s_per = l_chips / rate * jnp.float32(fs)               # [C] code
        #                                                        period in
        #                                                        samples
        u0 = st.rem_code_phase / rate * jnp.float32(fs)        # [C] samples
        # closed-form epoch boundaries: cumulative samples of epoch e
        ecs = e_idx[None, :] * s_per[:, None] - u0[:, None]    # [C, E]
        n_cum = jnp.round(ecs)                                 # [C, E]
        n_next = jnp.round((e_idx[None, :] + 1.0) * s_per[:, None]
                           - u0[:, None])
        n_len = n_next - n_cum                                 # [C, E]
        # residual code phase at each epoch END (the per-epoch kernel's
        # OUTPUT convention: sample_counter and code_phase_samples both
        # refer to the epoch end, so their rounding cancels in (sc - cps))
        rem_end = (n_next - ((e_idx[None, :] + 1.0) * s_per[:, None]
                             - u0[:, None])) * rate[:, None] / jnp.float32(fs)
        # block totals
        n_total = jnp.round(jnp.float32(e_block) * s_per - u0)   # [C]
        rem_new = (n_total - (jnp.float32(e_block) * s_per - u0)) \
            * rate / jnp.float32(fs)

        # ---- replica spectra with the Doppler ramp ---------------------
        # [C, F2] per block — the ONLY per-channel FFT work
        omega = two_pi * dop / jnp.float32(fs)                 # rad/sample
        rf = _replica_spectra(codes_rep, omega)                # [C, F2]

        # ---- window selection: contiguous slab per channel -------------
        # epoch e of channel c always fits window w0_c + e: within one
        # block the epoch-start drift off the w0_c + e*s0 grid is
        # |u0| + E*|s_per - s0| <= a few samples, absorbed by the LEAD
        # margin below and the window's tail margin (block_fft_size).
        # A contiguous slab of E rows per channel, cut by an unrolled
        # loop of scalar-start dynamic slices (one plain copy per
        # channel), instead of a data-dependent per-(c,e) row gather
        # xf_all[w_ce] or vmap(dynamic_slice), which both lower to an
        # XLA gather.  Which form is fastest on the GPU is not measured.
        w0 = jnp.clip(st.pos // jnp.int32(s0), 0,
                      jnp.int32(max(n_wins - e_block, 0)))     # [C]
        xf = jnp.stack([
            jax.lax.dynamic_slice(xf_all, (w0[c], 0),
                                  (e_block, xf_all.shape[1]))
            for c in range(c_ch)])                             # [C, E, F2]

        # ---- fractional replica lag within the window ------------------
        # window w0+e starts at chunk sample (w0+e)*s0 - LEAD; the
        # integer parts stay in int32 (pos can be ~2^20 where float32
        # spacing is 0.06 samples), the fractional part rides on the
        # small ecs - e*s0 residual
        d_int = (st.pos - w0 * jnp.int32(s0)).astype(jnp.float32)  # [C]
        lag = (d_int[:, None]
               + (ecs - e_idx[None, :] * jnp.float32(s0))
               + jnp.float32(_LEAD))                           # [C, E]
        # deterministic half-stretch correction: the signal's code runs
        # at rate*(1+dop/fc) vs the nominal-rate replica: by mid-epoch
        # the signal phase leads by stretch/2 chips, so the replica must
        # ADVANCE (lag decreases) to match
        stretch = (l_chips * (dop - jnp.float32(conf.doppler_bias_hz))
                   / jnp.float32(conf.carrier_freq_hz))        # chips
        lag = lag - 0.5 * stretch[:, None] / rate[:, None] * jnp.float32(fs)
        # a POSITIVE tap advances the replica (code[floor(chips + tap)]):
        # phase-0 moves EARLIER by tap/rate*fs samples -> NEGATIVE lag
        tap_samps = (-taps[None, :] / rate[:, None]
                     * jnp.float32(fs))                        # [C, K]
        # exact DTFT fractional-lag phasors (NOT 2-point interpolation:
        # the DLL parks the prompt inside the one integer-lag bracket
        # where linear interpolation of the triangle is worst, losing up
        # to ~26% amplitude and biasing each tap differently).
        # FACTORED: e^{j2pi f (lag+tap)/N} = lag phasor [C,E,F] x tap
        # phasor [C,K,F], contracted over F per tap (below).
        # The carrier-phase scalars ride along in the same angles:
        #   e^{-j(rem_carr + w*ecs)}  per (c,e)  — the channel's carrier
        #     phase at the exact fractional epoch start (the identity's
        #     e^{-j theta_w - j w tau} with theta_w the phase at window
        #     start; theta_w + w*lag = rem_carr + w*ecs), and
        #   e^{-j w*tap}              per (c,k)
        # so no separate complex multiplies are spent on them.
        ph_sc = st.rem_carr_phase[:, None] + omega[:, None] * (
            ecs - 0.5 * stretch[:, None] / rate[:, None] * jnp.float32(fs))
        # angle reduction: f*lag reaches ~2e6 "bins" (lag can be a whole
        # code period in the shared-window grid) and float32 cos/sin at
        # 2*pi*f*lag/N ~ 6e3 rad carries ~5e-4 rad of rounding noise —
        # enough to show up as alignment-dependent correlation error.
        # The INTEGER part of f*lag is periodic mod N and exact in int32
        # (|f*lag_int| < 2^23); only the fractional remainder stays in
        # float, keeping every angle below ~2*pi*(1 + |f|/2N)
        lag_int = jnp.round(lag)
        lag_frac = lag - lag_int                               # [C, E]
        f_int = f_bins.astype(jnp.int32)                       # [F]
        prod_mod = jnp.mod(f_int[None, None, :]
                           * lag_int.astype(jnp.int32)[..., None],
                           jnp.int32(nfft)).astype(jnp.float32)
        ang_l = (two_pi * (prod_mod
                           + f_bins[None, None, :] * lag_frac[..., None])
                 / jnp.float32(nfft)
                 - ph_sc[..., None])                           # [C, E, F]
        pl = jax.lax.complex(jnp.cos(ang_l), jnp.sin(ang_l))
        ang_t = (two_pi * f_bins[None, None, :]
                 * tap_samps[..., None] / jnp.float32(nfft)
                 - (omega[:, None] * tap_samps)[..., None])    # [C, K, F]
        pt = jax.lax.complex(jnp.cos(ang_t), jnp.sin(ang_t))
        z = xf * rf[:, None, :] * pl                           # [C, E, F]
        # a multiply-and-sum over F, not an einsum: as a dot the GPU runs
        # it in TF32 at default precision (up to 1.8e-4 of |P| off at
        # 20 Msps; chip_smoke.py's tolerance is 1e-4), and in float32 at
        # HIGHEST it is 2.5x slower than this fused float32 reduction
        corr = jnp.sum(z[:, :, None, :] * pt[:, None, :, :], axis=-1) \
            / jnp.float32(nfft)                                # [C, E, K]

        prompt = corr[:, :, prompt_i]                          # [C, E]
        early = corr[:, :, prompt_i - 1]
        late = corr[:, :, prompt_i + 1]

        # optional data-component prompt (track_pilot): correlate the
        # data code's spectrum at the PROMPT lag only (the per-epoch
        # kernel's zero-tap dcorr, tracking.py _epoch_step); taps are
        # centered so the prompt tap phasor is 1 — the lag phasor alone
        # places the replica
        data_prompt = None
        if data_codes_rep is not None:
            rfd = _replica_spectra(data_codes_rep, omega)      # [C, F2]
            yd = xf * rfd[:, None, :]                          # [C, E, F]
            data_prompt = jnp.sum(yd * pl, axis=-1) / jnp.float32(nfft)

        # ---- secondary-code sync + wipeoff (pilot) ---------------------
        epoch_g = st.epoch[:, None] + jnp.arange(e_block)[None, :]
        sec_state = dict(sec_buf=st.sec_buf, sec_synced=st.sec_synced,
                         sec_off=st.sec_off, sec_polarity=st.sec_polarity)
        if sec_code is not None:
            n_sec = sec_code.shape[0]
            sign_e = jnp.where(jnp.real(prompt) >= 0, 1.0, -1.0)  # [C, E]
            # roll the sign history buffer by E and append the block
            buf = jnp.concatenate(
                [st.sec_buf[:, e_block % N_SEC_MAX:],
                 sign_e[:, -min(e_block, N_SEC_MAX):]], axis=1
            )[:, -N_SEC_MAX:]
            # all-cyclic-shift hard match over the last n_sec entries
            last = buf[:, N_SEC_MAX - n_sec:]                 # [C, n_sec]
            # epoch index of last entry:
            e_last = st.epoch + jnp.int32(e_block) - 1
            shifts = jnp.arange(n_sec)
            # chip expected at buffer slot j for offset o:
            # sec[(e_last - (n_sec-1-j) + o) mod n_sec]
            j_idx = jnp.arange(n_sec)
            idx = jnp.mod(e_last[:, None, None] - (n_sec - 1 - j_idx)[None,
                                                                      None, :]
                          + shifts[None, :, None], n_sec)
            expect = sec_code[idx]                            # [C, O, J]
            m = jnp.einsum("cj,coj->co", last, expect)        # [C, O]
            best = jnp.argmax(jnp.abs(m), axis=1)
            best_val = jnp.take_along_axis(m, best[:, None], axis=1)[:, 0]
            hit = jnp.abs(best_val) >= jnp.float32(n_sec)
            newly = hit & ~st.sec_synced & act
            sec_state = dict(
                sec_buf=buf,
                sec_synced=st.sec_synced | newly,
                sec_off=jnp.where(newly, best.astype(jnp.int32),
                                  st.sec_off),
                sec_polarity=jnp.where(newly, jnp.sign(best_val),
                                       st.sec_polarity))
            # wipeoff where synced
            chip = sec_code[jnp.mod(epoch_g + sec_state["sec_off"][:, None],
                                    n_sec)] * \
                sec_state["sec_polarity"][:, None]
            wipe = jnp.where(sec_state["sec_synced"][:, None], chip, 1.0)
            prompt = prompt * wipe
            early = early * wipe
            late = late * wipe

        # ---- per-epoch discriminators, block-averaged closure ----------
        carr_err = discriminators.pll_costas(prompt) / two_pi   # [C, E]
        code_err = discriminators.dll_nc_e_minus_l_normalized(
            jnp.abs(early), jnp.abs(late),
            jnp.float32(conf.early_late_space_chips))
        carr_err_m = jnp.mean(carr_err, axis=1)
        code_err_m = jnp.mean(code_err, axis=1)
        t_blk = n_total / jnp.float32(fs)                       # [C]
        # two-stage loops: the handoff (straight from acquisition or
        # from the per-epoch kernel) can carry a half-chip / 100+ Hz
        # error — settle with the WIDE bandwidths for the first ~1 s of
        # block mode, then narrow.  ext_n doubles as the blocks-in-mode
        # counter (the per-epoch kernel zeroes it on arm).
        blocks_in = st.ext_n
        settle = blocks_in < jnp.int32(50)
        dll_bw_eff = jnp.where(settle, jnp.float32(conf.dll_bw_hz),
                               jnp.float32(conf.dll_bw_narrow_hz))
        # PLL stays at the NARROW bandwidth even while young: the block
        # closure runs at t_blk (~20 ms), and BL*T stability caps the
        # loop at ~15 Hz here (35 Hz wide would put BL*T at 0.7 and
        # oscillate).  Frequency pull-in is the FLL's job below.
        pll_new, pll_out = lf.third_order_step(
            st.pll, carr_err_m, jnp.float32(conf.pll_bw_narrow_hz), t_blk)
        dll_new, dll_out = lf.second_order_step(
            st.dll, code_err_m, dll_bw_eff, t_blk)
        doppler_new = pll_out
        # FLL-assisted pull-in (run_dll_pll :1080-1099): per-epoch-pair
        # cross-dot averaged over the block, nudging the PLL frequency
        # integrator while the channel is young — this is what lets a
        # chain hand off from acquisition STRAIGHT into block mode
        # (+-250 Hz grid error pulls in at first-order gain
        # 4*BL_f*t_blk ~= 1.2 per block, stable since < 2).
        if conf.enable_fll_pullin:
            prev_prompts = jnp.concatenate(
                [st.prompt_prev[:, None], prompt[:, :-1]], axis=1)
            t_pair = (n_len / jnp.float32(fs))                  # [C, E]
            f_err4 = discriminators.fll_cross_dot(prev_prompts, prompt,
                                                  t_pair)
            # MEDIAN over the block's pairs, not the mean: a nav-bit
            # flip between two prompts throws that pair's four-quadrant
            # discriminator to the +-500 Hz rail, and one flipped pair
            # in e_block would bias a mean by ~25 Hz every block (enough
            # to wreck a 20 ms-cadence closure).  The median ignores the
            # outlier while keeping the full +-500 Hz pull range.
            f_err_m = jnp.median(f_err4, axis=1)
            if conf.fll_decision_directed:
                # data chains whose symbols flip every epoch: the
                # two-quadrant form always (see TrackingConf)
                f_err_m = jnp.median(discriminators.fll_cross_dot_decision(
                    prev_prompts, prompt, t_pair), axis=1)
            elif sec_code is not None:
                # secondary-code chains BEFORE sync: chips flip between
                # arbitrary consecutive epochs, so up to half the
                # four-quadrant pairs rail and even the median breaks.
                # The two-quadrant decision-directed form is fully
                # flip-insensitive; its +-1/(4T) range (+-250 Hz at
                # 1 ms) covers the +-125 Hz acquisition-grid error.
                # After sync the prompts above are already wiped —
                # switch to the four-quadrant median per channel.
                f_err2 = discriminators.fll_cross_dot_decision(
                    prev_prompts, prompt, t_pair)
                f_err_m = jnp.where(sec_state["sec_synced"], f_err_m,
                                    jnp.median(f_err2, axis=1))
            # engaged during the pull-in window AND any time carrier
            # lock has not (or no longer) been achieved: the narrow PLL
            # closing at block cadence (BL*T ~ 0.3) cannot recover a
            # frequency ramp on its own at low C/N0 — without this the
            # loop walks off at ~10 Hz/s after a slip cascade (measured,
            # see test_block_mode_pullin_low_cn0)
            in_pullin = ((st.epoch < jnp.int32(conf.fll_pullin_epochs))
                         | (st.carrier_lock
                            < jnp.float32(conf.carrier_lock_threshold)))
            # per-block gain capped at 0.5: the per-epoch form
            # 4*BL_f*t_int lands at 1.2 for a 20 ms block — an
            # underdamped (sign-alternating) first-order recursion that
            # amplifies discriminator noise ~6x.  0.5 converges
            # geometrically (125 Hz -> <1 Hz inside the 12-block
            # pull-in window) with the noise of a damped loop.
            g_fll = jnp.minimum(4.0 * jnp.float32(conf.fll_bw_hz) * t_blk,
                                jnp.float32(0.5))
            # after the pull-in window, lock-recovery mode runs at 0.3x
            # gain: enough to stop a slip-cascade frequency ramp
            # (~10 Hz/s) at 7.5x/s correction, small enough (~1.5 Hz
            # RMS kicks at 42 dB-Hz) for the PLL to reach phase lock
            # under it
            g_eff = jnp.where(st.epoch < jnp.int32(conf.fll_pullin_epochs),
                              g_fll, 0.3 * g_fll)
            fll_nudge = jnp.where(in_pullin, g_eff * f_err_m,
                                  jnp.zeros_like(f_err_m))
            doppler_new = doppler_new + fll_nudge
            pll_new = lf.LoopFilterState(vel=pll_new.vel + fll_nudge,
                                         acc=pll_new.acc)
        code_freq_new = (jnp.float32(conf.code_rate_cps)
                         * (1.0 + (doppler_new
                                   - jnp.float32(conf.doppler_bias_hz))
                            / jnp.float32(conf.carrier_freq_hz))
                         + dll_out)

        # ---- lock / C/N0 over the block --------------------------------
        # per-PROMPT sign-insensitive forms averaged over the block: a
        # nav-bit edge inside a block must not read as loss of lock
        # (reference carrier_lock_test averages (I^2-Q^2)/(I^2+Q^2) per
        # prompt, cn0_and_tracking_lock_status)
        pi_ = jnp.real(prompt)
        pq_ = jnp.imag(prompt)
        p2 = pi_ * pi_ + pq_ * pq_
        carrier_lock = jnp.mean((pi_ * pi_ - pq_ * pq_)
                                / jnp.maximum(p2, 1e-12), axis=1)
        # rectified-I SNV C/N0 (sign-insensitive; same estimator class as
        # the reference's SNV with |I|)
        mean_abs_i = jnp.mean(jnp.abs(pi_), axis=1)
        total = jnp.mean(p2, axis=1)
        sig = mean_abs_i * mean_abs_i
        noise = jnp.maximum(total - sig, 1e-12)
        t_sym = t_blk / jnp.float32(e_block)
        cn0_lin = jnp.maximum(sig / noise, 1e-6) / t_sym
        cn0_db = 10.0 * jnp.log10(cn0_lin)
        # one block ~= one per-epoch C/N0 window (cn0_window_epochs), so
        # the fail counter moves +-1 per BLOCK — same timescale as the
        # per-epoch kernel's +-1 per window — and the pull-in transient
        # is exempt exactly as there (in_transitory, tracking.py:605-607)
        in_transitory = st.epoch < jnp.int32(conf.fll_pullin_epochs)
        bad = ((carrier_lock < jnp.float32(conf.carrier_lock_threshold))
               | (cn0_db < jnp.float32(conf.cn0_min_db_hz))) \
            & ~in_transitory
        fail = jnp.where(bad, st.lock_fail + 1.0,
                         jnp.maximum(st.lock_fail - 1.0, 0.0))
        lost = fail > jnp.float32(conf.max_lock_fail)

        # ---- bit-sync histogram (data channels) ------------------------
        sign_e = jnp.where(pi_ >= 0, 1.0, -1.0)
        prev = jnp.concatenate([st.prev_sign[:, None], sign_e[:, :-1]],
                               axis=1)
        tr = (prev != 0.0) & (sign_e != prev)                  # [C, E]
        phase_mod = jnp.mod(epoch_g, 20)
        hist_inc = jnp.einsum(
            "ce,cep->cp", tr.astype(jnp.float32),
            (phase_mod[:, :, None]
             == jnp.arange(20)[None, None, :]).astype(jnp.float32))
        hist = st.bit_hist + hist_inc
        total = jnp.sum(hist, axis=1)
        top = jnp.argmax(hist, axis=1)
        peak = jnp.max(hist, axis=1)
        sync_ok = (total >= jnp.float32(conf.bit_sync_min_transitions)) \
            & (peak >= 0.8 * total)
        newly_bit = sync_ok & ~st.bit_synced & act
        bit_synced = st.bit_synced | newly_bit
        bit_phase = jnp.where(newly_bit, top.astype(jnp.int32),
                              st.bit_phase)

        # ---- carrier phase bookkeeping (Kahan over blocks) -------------
        cyc_blk = dop * t_blk
        y_k = cyc_blk - st.acc_phase_comp
        t_sum = st.acc_phase_cycles + y_k
        comp = (t_sum - st.acc_phase_cycles) - y_k
        rem_carr_new = jnp.mod(st.rem_carr_phase
                               + two_pi * dop * t_blk, two_pi)
        # per-epoch acc phase at epoch END (affine within the block)
        acc_e = (st.acc_phase_cycles - st.acc_phase_comp)[:, None] \
            + dop[:, None] * (n_next / jnp.float32(fs))        # [C, E]

        # ---- outputs ([E, C] planes) -----------------------------------
        sel = lambda new, old: jnp.where(act, new, old)
        pos_new = jnp.where(act,
                            st.pos + n_total.astype(jnp.int32),
                            st.pos + jnp.int32(e_block * s0))
        new_state = st._replace(
            active=act & ~lost,
            pos=pos_new,
            rem_code_phase=sel(rem_new, st.rem_code_phase),
            code_freq=sel(code_freq_new, st.code_freq),
            carrier_doppler=sel(doppler_new, st.carrier_doppler),
            rem_carr_phase=sel(rem_carr_new, st.rem_carr_phase),
            acc_phase_cycles=sel(t_sum, st.acc_phase_cycles),
            acc_phase_comp=sel(comp, st.acc_phase_comp),
            dll=jax.tree.map(sel, dll_new, st.dll),
            pll=jax.tree.map(sel, pll_new, st.pll),
            prompt_prev=sel(prompt[:, -1], st.prompt_prev),
            epoch=jnp.where(act, st.epoch + jnp.int32(e_block), st.epoch),
            cn0_db_hz=sel(cn0_db, st.cn0_db_hz),
            carrier_lock=sel(carrier_lock, st.carrier_lock),
            lock_fail=sel(fail, st.lock_fail),
            lock_lost=sel(lost, st.lock_lost),
            bit_hist=jnp.where(act[:, None], hist, st.bit_hist),
            prev_sign=sel(sign_e[:, -1], st.prev_sign),
            bit_synced=sel(bit_synced, st.bit_synced),
            bit_phase=sel(bit_phase, st.bit_phase),
            sec_buf=jnp.where(act[:, None], sec_state["sec_buf"],
                              st.sec_buf),
            sec_synced=sel(sec_state["sec_synced"], st.sec_synced),
            sec_off=sel(sec_state["sec_off"], st.sec_off),
            sec_polarity=sel(sec_state["sec_polarity"], st.sec_polarity),
            ext_n=jnp.where(act, jnp.minimum(st.ext_n + 1,
                                             jnp.int32(10000)), st.ext_n),
        )
        outs = {
            "prompt": (data_prompt if data_prompt is not None
                       else prompt).T,                         # [E, C]
            "early_mag": jnp.abs(early).T,
            "late_mag": jnp.abs(late).T,
            "carrier_doppler_hz": jnp.broadcast_to(dop[None, :],
                                                   (e_block, c_ch)),
            "code_freq_cps": jnp.broadcast_to(rate[None, :],
                                              (e_block, c_ch)),
            "rem_code_phase_chips": rem_end.T,
            "acc_phase_cycles": acc_e.T,
            "code_phase_samples": (rem_end / rate[:, None]
                                   * jnp.float32(fs)).T,
            "pos_start": (st.pos[:, None]
                          + n_cum.astype(jnp.int32)).T,
            "n_samples": n_len.astype(jnp.int32).T,
            "cn0_db_hz": jnp.broadcast_to(cn0_db[None, :],
                                          (e_block, c_ch)),
            "valid": jnp.broadcast_to(act[None, :], (e_block, c_ch)),
        }
        return new_state, outs

    new_state, outs = jax.lax.scan(body, state, None, length=n_blocks)
    # [n_blocks, E, C] -> [T, C]
    outs = {k: v.reshape(n_blocks * e_block, -1) for k, v in outs.items()}
    return new_state, outs


@partial(jax.jit, static_argnames=("conf", "n_blocks", "e_block", "decim"))
def track_chunk_blocks_packed_decim(conf: TrackingConf, n_blocks: int,
                                    e_block: int, decim: int,
                                    codes_rep: jax.Array, taps: jax.Array,
                                    x_chunk: jax.Array, state: TrackState,
                                    sec_code: jax.Array | None = None,
                                    data_codes_rep: jax.Array | None = None):
    """Block kernel + the same rate-split single-buffer transfer format
    as tracking.track_chunk_packed_decim."""
    new_state, outs = track_chunk_blocks(
        conf, n_blocks, e_block, codes_rep, taps, x_chunk, state,
        sec_code=sec_code, data_codes_rep=data_codes_rep)
    n_epochs = n_blocks * e_block
    pre = jnp.real(outs["prompt"])
    valid = outs["valid"]
    scale = jnp.maximum(jnp.max(jnp.abs(pre), axis=0) / 126.0,
                        jnp.float32(1e-20))
    q = jnp.clip(jnp.round(pre / scale), -126.0, 126.0).astype(jnp.int8)
    sym = jnp.where(valid, q, jnp.int8(-128))
    rows = jnp.arange(decim - 1, n_epochs, decim)
    f32 = jnp.stack([outs[k][rows] for k in _DECIM_F32])
    sc = (outs["pos_start"][rows]
          + outs["n_samples"][rows]).astype(jnp.int32)
    flat = sym.ravel()
    pad = (-flat.shape[0]) % 4
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros(pad, jnp.int8)])
    sym_i32 = jax.lax.bitcast_convert_type(flat.reshape(-1, 4), jnp.int32)
    buf = jnp.concatenate([
        sym_i32,
        jax.lax.bitcast_convert_type(f32, jnp.int32).ravel(),
        sc.ravel(),
        new_state.pos.astype(jnp.int32),
        new_state.active.astype(jnp.int32),
        new_state.lock_lost.astype(jnp.int32),
        jax.lax.bitcast_convert_type(scale, jnp.int32)])
    return new_state, buf

"""Batched DLL/PLL tracking engine.

Batched re-design of the reference `dll_pll_veml_tracking` GNU Radio
block (src/algorithms/tracking/gnuradio_blocks/dll_pll_veml_tracking.cc):
instead of one thread per channel consuming a variable number of samples per
iteration (consume_each(d_current_prn_length_samples), :2061), ALL channels
advance one code epoch per `lax.scan` step over a shared device-resident
sample chunk.  The reference's variable-length consume becomes a
per-channel sample *pointer* plus fractional code/carrier phase remnants
carried as scan state; the per-1ms loop closure (discriminators -> loop
filters -> NCO update, run_dll_pll() :1065-1152 and update_tracking_vars()
:1189-1260) runs vectorized on-device, so no host round-trip ever touches
the ms-rate feedback path.

The host-side TrackingEngine wraps the jitted chunk scan with absolute
sample bookkeeping (int64) and acquisition->tracking handoff
(pull-in alignment, :1757-1788).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.ops import cn0 as cn0_ops
from gnss_sim_receiver_tpu.ops import correlator, discriminators
from gnss_sim_receiver_tpu.ops import loop_filters as lf
from gnss_sim_receiver_tpu.ops import prn_codes

N_SEC_MAX = 32   # longest supported secondary code (NH20, CS25 fit)


@dataclasses.dataclass(frozen=True)
class TrackingConf:
    """Reference Dll_Pll_Conf subset (tracking/libs/dll_pll_conf.h:42-80)."""
    fs: float = 2_000_000.0
    code_rate_cps: float = constants.GPS_L1_CA_CODE_RATE_CPS
    code_length_chips: int = constants.GPS_L1_CA_CODE_LENGTH_CHIPS
    carrier_freq_hz: float = constants.GPS_L1_FREQ_HZ
    pll_bw_hz: float = 35.0
    pll_filter_order: int = 3
    dll_bw_hz: float = 2.0
    dll_filter_order: int = 2
    enable_fll_pullin: bool = True
    fll_bw_hz: float = 15.0
    fll_pullin_epochs: int = 250
    # use the two-quadrant decision-directed cross-dot discriminator
    # (ops/discriminators fll_cross_dot_decision) instead of the
    # four-quadrant form: fully insensitive to a symbol/secondary-chip
    # flip between the two prompts at half the pull range (+-1/(4T)).
    # Set for data chains whose symbols flip every epoch (L5I NH10,
    # E5a-I CS20, E5b-I CS4, B1I/B3I NH20, L2C CM, E6-B, SBAS) — their
    # two-step acquisition error (<= doppler_step2/2) sits well inside
    # the reduced range, so FLL pull-in works where the four-quadrant
    # form would rail on ~half the pairs (reference fll_diff_atan family)
    fll_decision_directed: bool = False
    early_late_space_chips: float = 0.5
    # > 0 adds very-early/very-late taps (5-tap VEML, the BOC sideband
    # disambiguator of dll_pll_VEML_tracking; used with the
    # dll_nc_vemlp_normalized discriminator)
    very_early_late_space_chips: float = 0.0
    cn0_window_epochs: int = 20
    # rectified (|I|,|Q|) carrier-lock test for meander/bi-binary signals
    # (GLONASS GNAV) whose data is zero-mean over every window — the
    # coherent NBD/NBP test reads -1 there even in perfect lock
    lock_rectify: bool = False
    cn0_min_db_hz: float = 25.0
    carrier_lock_threshold: float = 0.75
    max_lock_fail: int = 50
    # tracking_mode "kf": joint code/carrier Kalman tracker replacing the
    # DLL/PLL loop filters (reference kf_tracking,
    # tracking/gnuradio_blocks/kf_tracking.cc, state
    # [code phase, carrier phase, Doppler, Doppler rate],
    # kf_tracking.h:128-129)
    tracking_mode: str = "dll_pll"     # "dll_pll" | "kf" | "gaussian"
    # "gaussian": the KF tracker with Bayesian (normal-inverse-Wishart)
    # ADAPTIVE measurement-noise estimation from the innovation stream
    # (reference gps_l1_ca_gaussian_tracking_cc + bayesian_estimation.cc
    # update_sequential), carried through the scan with an exponential
    # forgetting factor so the posterior tracks changing C/N0
    bayes_forgetting: float = 0.995
    bayes_nu0: float = 30.0
    # extended coherent integration (reference tracking states 2->3->4,
    # dll_pll_veml_tracking.cc:1789-2027 + extend_correlation_symbols):
    # after on-device bit sync, prompts are summed coherently over
    # extend_correlation_symbols epochs (divisor of 20) and the loops close
    # at that cadence with the narrow bandwidths.
    extend_correlation_symbols: int = 1
    pll_bw_narrow_hz: float = 15.0
    dll_bw_narrow_hz: float = 0.5
    bit_sync_min_transitions: int = 16
    # secondary code (pilot channels: L5Q NH20, E1C CS25, B1I NH20...):
    # hard sign-match sync of the prompt signs against the sequence, then
    # per-epoch wipeoff (reference acquire_secondary(),
    # dll_pll_veml_tracking.cc:925-969; |corr| must equal the length)
    secondary_code: tuple = ()
    # non-physical baseband carrier offset excluded from code-Doppler
    # aiding (GLONASS FDMA slot k rides at +k*DFRQ in the tracked Doppler
    # but does not Doppler the code; the reference biases acquisition by
    # d_doppler_bias for the same reason, pcps_acquisition.cc:211-230)
    doppler_bias_hz: float = 0.0
    # track_pilot (dll_pll_conf.h): the LOOPS close on the pilot code
    # (this conf's code/secondary describe the pilot component) while a
    # separate data-prompt correlator taps the data code for telemetry
    # (dll_pll_veml_tracking.cc:1050-1061) — the engine must then be
    # built with data_code_provider
    track_pilot: bool = False
    kf_q_code_chips2: float = 1e-4
    kf_q_phase_cyc2: float = 1e-6
    kf_q_dop_hz2: float = 1.0
    kf_q_doprate_hz2s2: float = 10.0
    kf_r_code_chips2: float = 2e-3
    kf_r_phase_cyc2: float = 5e-4

    @property
    def t_epoch_nominal_s(self) -> float:
        return self.code_length_chips / self.code_rate_cps

    @property
    def nominal_epoch_samples(self) -> int:
        return int(round(self.fs * self.t_epoch_nominal_s))

    @property
    def block_size(self) -> int:
        # fixed correlation block: one code period + slack, VPU-aligned
        b = int(np.ceil(self.fs * self.t_epoch_nominal_s * 1.01)) + 16
        return ((b + 127) // 128) * 128


class TrackState(NamedTuple):
    """Per-channel scan-carried state; every field is [C]-shaped."""
    active: jnp.ndarray            # bool
    pos: jnp.ndarray               # int32 next epoch start (chunk-relative)
    rem_code_phase: jnp.ndarray    # float32 chips into the code period
    code_freq: jnp.ndarray         # float32 chips/s
    carrier_doppler: jnp.ndarray   # float32 Hz
    rem_carr_phase: jnp.ndarray    # float32 rad (NCO phase mod 2pi)
    acc_phase_cycles: jnp.ndarray  # float32 Kahan sum of carrier cycles
    acc_phase_comp: jnp.ndarray    # float32 Kahan compensation
    dll: lf.LoopFilterState
    pll: lf.LoopFilterState
    prompt_prev: jnp.ndarray       # complex64 (FLL memory)
    epoch: jnp.ndarray             # int32 epochs since start_tracking
    cn0_acc: cn0_ops.Cn0AccumState
    cn0_db_hz: jnp.ndarray         # float32
    carrier_lock: jnp.ndarray      # float32
    lock_fail: jnp.ndarray         # float32
    lock_lost: jnp.ndarray         # bool
    kf_p: jnp.ndarray              # [C, 4, 4] KF covariance (kf mode)
    kf_fdot: jnp.ndarray           # [C] Doppler rate estimate (kf mode)
    bit_hist: jnp.ndarray          # [C, 20] sign-transition histogram
    prev_sign: jnp.ndarray         # [C] last prompt-I sign
    bit_synced: jnp.ndarray        # [C] bool
    bit_phase: jnp.ndarray         # [C] int32 epoch%20 of bit starts
    ext_p: jnp.ndarray             # [C] complex64 coherent P accumulator
    ext_e: jnp.ndarray             # [C] complex64 coherent E accumulator
    ext_l: jnp.ndarray             # [C] complex64 coherent L accumulator
    ext_n: jnp.ndarray             # [C] int32 symbols accumulated
    sec_buf: jnp.ndarray           # [C, N_SEC_MAX] recent prompt-I signs
    sec_synced: jnp.ndarray        # [C] bool
    sec_off: jnp.ndarray           # [C] int32: sec chip = sec[(e+off)%N]
    sec_polarity: jnp.ndarray      # [C] +-1 (180-deg phase lock flag)
    # Bayesian adaptive measurement noise ("gaussian" mode): NIW
    # posterior pseudo-counts and scale sums per channel
    bayes_nu: jnp.ndarray          # [C] float32
    bayes_psi_code: jnp.ndarray    # [C] float32 (chips^2 scale sum)
    bayes_psi_carr: jnp.ndarray    # [C] float32 (cycles^2 scale sum)


@partial(jax.jit, static_argnames=("n_channels",))
def _init_state(n_channels: int) -> TrackState:
    # jitted: the whole state is built by one device program instead of
    # ~30 eager constant uploads
    z = lambda dt=jnp.float32: jnp.zeros(n_channels, dt)
    return TrackState(
        active=z(bool), pos=z(jnp.int32), rem_code_phase=z(),
        code_freq=jnp.full(n_channels, constants.GPS_L1_CA_CODE_RATE_CPS,
                           jnp.float32),
        carrier_doppler=z(), rem_carr_phase=z(),
        acc_phase_cycles=z(), acc_phase_comp=z(),
        dll=lf.init_state(n_channels), pll=lf.init_state(n_channels),
        prompt_prev=z(jnp.complex64), epoch=z(jnp.int32),
        cn0_acc=cn0_ops.init_accum(n_channels),
        cn0_db_hz=z(), carrier_lock=z(), lock_fail=z(),
        lock_lost=z(bool),
        kf_p=jnp.tile(jnp.diag(jnp.asarray(
            [0.1, 0.1, 100.0, 10.0], jnp.float32))[None],
            (n_channels, 1, 1)),
        kf_fdot=z(),
        bit_hist=jnp.zeros((n_channels, 20), jnp.float32),
        prev_sign=z(), bit_synced=z(bool), bit_phase=z(jnp.int32),
        ext_p=z(jnp.complex64), ext_e=z(jnp.complex64),
        ext_l=z(jnp.complex64), ext_n=z(jnp.int32),
        sec_buf=jnp.zeros((n_channels, N_SEC_MAX), jnp.float32),
        sec_synced=z(bool), sec_off=z(jnp.int32),
        sec_polarity=jnp.ones(n_channels, jnp.float32),
        bayes_nu=jnp.full(n_channels, 30.0, jnp.float32),
        bayes_psi_code=jnp.full(n_channels, 30.0 * 2e-3, jnp.float32),
        bayes_psi_carr=jnp.full(n_channels, 30.0 * 5e-4, jnp.float32),
    )


@jax.jit
def _arm_channel(s: TrackState, ch, doppler_hz, code_freq0) -> TrackState:
    """Channel-arming state update, jitted so the ~30 scatter updates run
    as one device program instead of one eager dispatch each."""
    return s._replace(
        active=s.active.at[ch].set(True),
        pos=s.pos.at[ch].set(0),
        rem_code_phase=s.rem_code_phase.at[ch].set(0.0),
        code_freq=s.code_freq.at[ch].set(code_freq0),
        carrier_doppler=s.carrier_doppler.at[ch].set(doppler_hz),
        rem_carr_phase=s.rem_carr_phase.at[ch].set(0.0),
        acc_phase_cycles=s.acc_phase_cycles.at[ch].set(0.0),
        acc_phase_comp=s.acc_phase_comp.at[ch].set(0.0),
        dll=lf.LoopFilterState(vel=s.dll.vel.at[ch].set(0.0),
                               acc=s.dll.acc.at[ch].set(0.0)),
        pll=lf.LoopFilterState(vel=s.pll.vel.at[ch].set(doppler_hz),
                               acc=s.pll.acc.at[ch].set(0.0)),
        prompt_prev=s.prompt_prev.at[ch].set(0.0 + 0.0j),
        epoch=s.epoch.at[ch].set(0),
        cn0_db_hz=s.cn0_db_hz.at[ch].set(0.0),
        carrier_lock=s.carrier_lock.at[ch].set(1.0),
        lock_fail=s.lock_fail.at[ch].set(0.0),
        lock_lost=s.lock_lost.at[ch].set(False),
        kf_p=s.kf_p.at[ch].set(jnp.diag(jnp.asarray(
            [0.1, 0.1, 100.0, 10.0], jnp.float32))),
        kf_fdot=s.kf_fdot.at[ch].set(0.0),
        bit_hist=s.bit_hist.at[ch].set(0.0),
        prev_sign=s.prev_sign.at[ch].set(0.0),
        bit_synced=s.bit_synced.at[ch].set(False),
        bit_phase=s.bit_phase.at[ch].set(0),
        ext_p=s.ext_p.at[ch].set(0.0 + 0.0j),
        ext_e=s.ext_e.at[ch].set(0.0 + 0.0j),
        ext_l=s.ext_l.at[ch].set(0.0 + 0.0j),
        ext_n=s.ext_n.at[ch].set(0),
        sec_buf=s.sec_buf.at[ch].set(0.0),
        sec_synced=s.sec_synced.at[ch].set(False),
        sec_off=s.sec_off.at[ch].set(0),
        sec_polarity=s.sec_polarity.at[ch].set(1.0),
        bayes_nu=s.bayes_nu.at[ch].set(30.0),
        bayes_psi_code=s.bayes_psi_code.at[ch].set(30.0 * 2e-3),
        bayes_psi_carr=s.bayes_psi_carr.at[ch].set(30.0 * 5e-4),
    )


def _dll_pll_update(conf: TrackingConf, state: TrackState, prompt,
                    carr_err_cyc, code_err_chips, t_int,
                    pll_bw_hz=None, dll_bw_hz=None, apply_fll=True):
    """Classic loop closure (run_dll_pll :1065-1152): FLL-assisted PLL +
    carrier-aided DLL.  Bandwidth overrides serve the narrow (extended
    coherent integration) mode."""
    pll_bw = conf.pll_bw_hz if pll_bw_hz is None else pll_bw_hz
    dll_bw = conf.dll_bw_hz if dll_bw_hz is None else dll_bw_hz
    if conf.pll_filter_order == 3:
        wn = jnp.float32(pll_bw / 0.7845)
        pll_acc = state.pll.acc + wn * wn * wn * t_int * carr_err_cyc
        pll_vel = state.pll.vel + t_int * (pll_acc
                                           + 1.1 * wn * wn * carr_err_cyc)
        out_gain = 2.4 * wn
    else:
        wn = jnp.float32(pll_bw / 0.53)
        pll_acc = state.pll.acc
        pll_vel = state.pll.vel + wn * wn * t_int * carr_err_cyc
        out_gain = 1.414213562 * wn
    # FLL assist during pull-in: nudge the frequency integrator directly
    # (reference FLL-assisted-PLL pull-in mode, run_dll_pll :1080-1099).
    # Channels with a secondary code only use it in decision-directed
    # mode: the every-epoch symbol flips corrupt ~half the four-quadrant
    # cross-dot pairs before sync, while the two-quadrant form is
    # flip-proof (conf.fll_decision_directed).
    if conf.enable_fll_pullin and apply_fll \
            and (conf.fll_decision_directed
                 or len(conf.secondary_code) == 0):
        fll_fn = (discriminators.fll_cross_dot_decision
                  if conf.fll_decision_directed
                  else discriminators.fll_cross_dot)
        freq_err = fll_fn(state.prompt_prev, prompt, t_int)
        in_pullin = (state.epoch > 0) & (state.epoch < conf.fll_pullin_epochs)
        pll_vel = jnp.where(
            in_pullin,
            pll_vel + 4.0 * jnp.float32(conf.fll_bw_hz) * t_int * freq_err,
            pll_vel)
    pll_new = lf.LoopFilterState(vel=pll_vel, acc=pll_acc)
    carrier_doppler = pll_vel + out_gain * carr_err_cyc
    # DLL with carrier aiding (:1126-1129)
    dll_new, dll_out = lf.second_order_step(
        state.dll, code_err_chips, jnp.float32(dll_bw), t_int)
    code_freq = (jnp.float32(conf.code_rate_cps)
                 * (1.0 + (carrier_doppler
                           - jnp.float32(conf.doppler_bias_hz))
                    / jnp.float32(conf.carrier_freq_hz))
                 + dll_out)
    return carrier_doppler, code_freq, pll_new, dll_new


def _kf_update(conf: TrackingConf, state: TrackState, prompt,
               carr_err_cyc, code_err_chips, t_int,
               r_code=None, r_carr=None):
    """Joint code/carrier error-state Kalman tracker (reference kf_tracking,
    state [code phase err (chips), carrier phase err (cycles), Doppler
    (Hz), Doppler rate (Hz/s)], kf_tracking.h:128-176), vectorized over
    channels with the covariance carried through the scan.

    Phase errors are fed back into the NCO remnants every epoch and
    re-zeroed (feedback form), so the filter state reduces to
    (Doppler, Doppler rate) + the 4x4 covariance."""
    beta = jnp.float32(conf.code_rate_cps / conf.carrier_freq_hz)
    dt = t_int
    c = dt.shape[0]
    eye4 = jnp.eye(4, dtype=jnp.float32)
    f = jnp.tile(eye4[None], (c, 1, 1))
    f = f.at[:, 0, 2].set(beta * dt)
    f = f.at[:, 0, 3].set(beta * dt * dt / 2.0)
    f = f.at[:, 1, 2].set(dt)
    f = f.at[:, 1, 3].set(dt * dt / 2.0)
    f = f.at[:, 2, 3].set(dt)
    q = jnp.diag(jnp.asarray([conf.kf_q_code_chips2, conf.kf_q_phase_cyc2,
                              conf.kf_q_dop_hz2, conf.kf_q_doprate_hz2s2],
                             jnp.float32))
    p_pred = jnp.einsum("cij,cjk,clk->cil", f, state.kf_p, f) + q[None]
    # H = [[1,0,0,0],[0,1,0,0]] -> S = P[:2,:2] + R (2x2 explicit inverse)
    r0 = (jnp.float32(conf.kf_r_code_chips2) if r_code is None
          else r_code)
    r1 = (jnp.float32(conf.kf_r_phase_cyc2) if r_carr is None
          else r_carr)
    s00 = p_pred[:, 0, 0] + r0
    s01 = p_pred[:, 0, 1]
    s11 = p_pred[:, 1, 1] + r1
    det = jnp.maximum(s00 * s11 - s01 * s01, 1e-20)
    si00 = s11 / det
    si01 = -s01 / det
    si11 = s00 / det
    ph = p_pred[:, :, :2]                                    # [C,4,2]
    k0 = ph[:, :, 0] * si00[:, None] + ph[:, :, 1] * si01[:, None]
    k1 = ph[:, :, 0] * si01[:, None] + ph[:, :, 1] * si11[:, None]
    k = jnp.stack([k0, k1], axis=-1)                         # [C,4,2]
    # innovation = measurements (predicted phase errors are zero after
    # feedback)
    dx = k[:, :, 0] * code_err_chips[:, None] \
        + k[:, :, 1] * carr_err_cyc[:, None]                 # [C,4]
    # P = (I - K H) P'
    kh = jnp.zeros((c, 4, 4), jnp.float32)
    kh = kh.at[:, :, 0].set(k[:, :, 0])
    kh = kh.at[:, :, 1].set(k[:, :, 1])
    p_new = jnp.einsum("cij,cjk->cik", eye4[None] - kh, p_pred)
    dtau = dx[:, 0]
    dphi = dx[:, 1]
    doppler = state.carrier_doppler + state.kf_fdot * dt + dx[:, 2]
    fdot = state.kf_fdot + dx[:, 3]
    # FLL assist during pull-in, same as the scalar loops
    if conf.enable_fll_pullin:
        fll_fn = (discriminators.fll_cross_dot_decision
                  if conf.fll_decision_directed
                  else discriminators.fll_cross_dot)
        freq_err = fll_fn(state.prompt_prev, prompt, t_int)
        in_pullin = (state.epoch > 0) & (state.epoch < conf.fll_pullin_epochs)
        doppler = jnp.where(
            in_pullin,
            doppler + 4.0 * jnp.float32(conf.fll_bw_hz) * t_int * freq_err,
            doppler)
    code_freq = (jnp.float32(conf.code_rate_cps)
                 * (1.0 + (doppler - jnp.float32(conf.doppler_bias_hz))
                    / jnp.float32(conf.carrier_freq_hz)))
    return doppler, code_freq, dtau, dphi, p_new, fdot


def _epoch_step(conf: TrackingConf, codes: jax.Array, taps: jax.Array,
                x_chunk: jax.Array, state: TrackState,
                data_codes: jax.Array | None = None):
    """Advance every channel by one code epoch. Returns (state', outputs)."""
    fs = conf.fs
    code_len = jnp.float32(conf.code_length_chips)

    # --- epoch length from current code NCO (update_tracking_vars :1189) ---
    n_c = jnp.round((code_len - state.rem_code_phase)
                    / state.code_freq * fs).astype(jnp.int32)
    n_c = jnp.clip(n_c, 1, conf.block_size)
    t_int = n_c.astype(jnp.float32) / jnp.float32(fs)

    # --- correlate (do_correlation_step :1037) -----------------------------
    # table oversample inferred from the table: raw +-1 chip tables -> 1;
    # band-limited sub-chip tables (bandlimited_table_normalized) -> K
    k_ovs = codes.shape[1] // conf.code_length_chips
    blocks = correlator.gather_blocks(x_chunk, state.pos, conf.block_size)
    corr = correlator.correlate_multitap(
        blocks, codes, taps, state.rem_code_phase, state.code_freq,
        state.rem_carr_phase, state.carrier_doppler, n_c, fs,
        table_oversample=k_ovs)
    # track_pilot: separate data-prompt correlator on the data code (the
    # loops and lock detectors below stay on the pilot correlators)
    data_prompt = None
    if conf.track_pilot and data_codes is not None:
        zero_tap = jnp.zeros(1, jnp.float32)
        dcorr = correlator.correlate_multitap(
            blocks, data_codes, zero_tap, state.rem_code_phase,
            state.code_freq, state.rem_carr_phase, state.carrier_doppler,
            n_c, fs,
            table_oversample=data_codes.shape[1] // conf.code_length_chips)
        data_prompt = dcorr[:, 0]
    veml = conf.very_early_late_space_chips > 0.0
    if veml:   # taps = [VE, E, P, L, VL]
        v_early, early, prompt, late, v_late = (corr[:, 0], corr[:, 1],
                                                corr[:, 2], corr[:, 3],
                                                corr[:, 4])
    else:
        early, prompt, late = corr[:, 0], corr[:, 1], corr[:, 2]

    # --- secondary-code sync + wipeoff (pilot channels; reference
    # acquire_secondary(), dll_pll_veml_tracking.cc:925-969) ----------------
    if len(conf.secondary_code) > 0:
        n_sec = len(conf.secondary_code)
        assert n_sec <= N_SEC_MAX, \
            f"secondary code longer than N_SEC_MAX={N_SEC_MAX}"
        sec_np = (np.array(conf.secondary_code, np.float32) * 2.0 - 1.0
                  if set(conf.secondary_code) <= {0, 1}
                  else np.array(conf.secondary_code, np.float32))
        sec_arr = jnp.asarray(sec_np)
        sign_now = jnp.where(jnp.real(prompt) >= 0.0, 1.0, -1.0)
        slot = jnp.mod(state.epoch, n_sec)
        slot_hot = (jnp.arange(N_SEC_MAX, dtype=jnp.int32)[None, :]
                    == slot[:, None])
        sec_buf = jnp.where(slot_hot, sign_now[:, None], state.sec_buf)
        # hard sign-match over all cyclic shifts: buf[i] must equal
        # polarity * sec[(i+off) % n] for exactly one off with |corr| == n
        shift_mat = np.zeros((n_sec, N_SEC_MAX), np.float32)
        for off in range(n_sec):
            shift_mat[off, :n_sec] = sec_np[(np.arange(n_sec) + off) % n_sec]
        corr_sec = sec_buf @ jnp.asarray(shift_mat).T          # [C, n_sec]
        best_off = jnp.argmax(jnp.abs(corr_sec), axis=-1).astype(jnp.int32)
        best = jnp.take_along_axis(corr_sec, best_off[:, None],
                                   axis=-1)[:, 0]
        hit = (~state.sec_synced) & (state.epoch >= n_sec) \
            & (jnp.abs(best) >= jnp.float32(n_sec) - 0.5)
        sec_synced = state.sec_synced | hit
        sec_off = jnp.where(hit, best_off, state.sec_off)
        sec_polarity = jnp.where(hit, jnp.sign(best), state.sec_polarity)
        # wipeoff: sec chip for this epoch
        chip_idx = jnp.mod(state.epoch + sec_off, n_sec)
        chip_hot = (jnp.arange(n_sec, dtype=jnp.int32)[None, :]
                    == chip_idx[:, None]).astype(jnp.float32)
        sec_chip = (chip_hot @ sec_arr) * sec_polarity
        wipe = jnp.where(sec_synced, sec_chip, 1.0)
        prompt_w = prompt * wipe
        early_w = early * wipe
        late_w = late * wipe
        sec_state_new = dict(sec_buf=sec_buf, sec_synced=sec_synced,
                             sec_off=sec_off, sec_polarity=sec_polarity)
    else:
        prompt_w, early_w, late_w = prompt, early, late
        sec_state_new = dict(sec_buf=state.sec_buf,
                             sec_synced=state.sec_synced,
                             sec_off=state.sec_off,
                             sec_polarity=state.sec_polarity)

    # --- loop closure (run_dll_pll :1065, or the kf_tracking KF) -----------
    carr_err_cyc = discriminators.pll_costas(prompt_w) / (2.0 * jnp.pi)
    if veml:
        code_err_chips = discriminators.dll_nc_vemlp_normalized(
            jnp.abs(v_early), jnp.abs(early), jnp.abs(late),
            jnp.abs(v_late), jnp.float32(conf.early_late_space_chips))
    else:
        code_err_chips = discriminators.dll_nc_e_minus_l_normalized(
            jnp.abs(early), jnp.abs(late),
            jnp.float32(conf.early_late_space_chips))
    bayes_new = (state.bayes_nu, state.bayes_psi_code,
                 state.bayes_psi_carr)
    if conf.tracking_mode in ("kf", "gaussian"):
        r_code = r_carr = None
        if conf.tracking_mode == "gaussian":
            # adaptive R from the NIW posterior (bayesian_estimation.cc
            # update_sequential with exponential forgetting); floors keep
            # the filter sane during transients
            denom = jnp.maximum(state.bayes_nu - 2.0, 1.0)
            r_code = jnp.maximum(state.bayes_psi_code / denom,
                                 jnp.float32(1e-5))
            r_carr = jnp.maximum(state.bayes_psi_carr / denom,
                                 jnp.float32(1e-6))
        (carrier_doppler, code_freq, dtau_chips, dphi_cyc, kf_p_new,
         kf_fdot_new) = _kf_update(conf, state, prompt_w, carr_err_cyc,
                                   code_err_chips, t_int,
                                   r_code=r_code, r_carr=r_carr)
        if conf.tracking_mode == "gaussian":
            lam = jnp.float32(conf.bayes_forgetting)
            bayes_new = (lam * state.bayes_nu + 1.0,
                         lam * state.bayes_psi_code
                         + code_err_chips * code_err_chips,
                         lam * state.bayes_psi_carr
                         + carr_err_cyc * carr_err_cyc)
        pll_new = lf.LoopFilterState(vel=carrier_doppler,
                                     acc=state.pll.acc)
        dll_new = state.dll
    else:
        dtau_chips = jnp.zeros_like(carr_err_cyc)
        dphi_cyc = jnp.zeros_like(carr_err_cyc)
        kf_p_new, kf_fdot_new = state.kf_p, state.kf_fdot
        carrier_doppler, code_freq, pll_new, dll_new = _dll_pll_update(
            conf, state, prompt_w, carr_err_cyc, code_err_chips, t_int)

    # --- extended coherent integration (states 2->3->4) --------------------
    k_ext = conf.extend_correlation_symbols
    if k_ext > 1 and conf.tracking_mode not in ("kf", "gaussian"):
        if len(conf.secondary_code) > 0:
            # pilot channel: the secondary code IS the symbol structure —
            # integration groups align to secondary-code boundaries after
            # wipeoff (reference state 3 for pilot signals)
            n_sec = len(conf.secondary_code)
            assert n_sec % k_ext == 0, \
                "extend_correlation_symbols must divide the secondary length"
            hist = state.bit_hist
            bit_synced = sec_state_new["sec_synced"]
            bit_phase = state.bit_phase
            sign = jnp.where(jnp.real(prompt_w) >= 0, 1.0, -1.0)
            ext_on = bit_synced & (state.epoch >= conf.fll_pullin_epochs)
            at_bit_start = jnp.mod(state.epoch + sec_state_new["sec_off"],
                                   n_sec) == 0
        else:
            assert 20 % k_ext == 0, \
                "extend_correlation_symbols must divide 20"
            # on-device bit sync: histogram of prompt-I sign transitions
            # over epoch%20 (the batched form of the reference's 20-symbol
            # pattern sync, dll_pll_veml_tracking.cc:1852-1867)
            sign = jnp.where(jnp.real(prompt) >= 0, 1.0, -1.0)
            flip = (state.prev_sign != 0.0) & (sign != state.prev_sign)
            idx20 = jnp.mod(state.epoch, 20)
            onehot = (jnp.arange(20, dtype=jnp.int32)[None, :]
                      == idx20[:, None]).astype(jnp.float32)
            hist = state.bit_hist + jnp.where(
                ((~state.bit_synced) & flip)[:, None], onehot, 0.0)
            peak = hist.max(axis=-1)
            arg = jnp.argmax(hist, axis=-1)
            peak_mask = (jnp.arange(20, dtype=jnp.int32)[None, :]
                         == arg[:, None])
            second = jnp.max(jnp.where(peak_mask, 0.0, hist), axis=-1)
            # dominance test: sign errors scatter spurious transitions
            # across all bins, so require the top bin to clearly dominate
            newly = (~state.bit_synced) \
                & (peak >= conf.bit_sync_min_transitions) \
                & (peak >= 4.0 * jnp.maximum(second, 1.0))
            bit_synced = state.bit_synced | newly
            bit_phase = jnp.where(newly, jnp.argmax(hist, axis=-1).astype(
                jnp.int32), state.bit_phase)
            ext_on = bit_synced & (state.epoch >= conf.fll_pullin_epochs)
            at_bit_start = idx20 == bit_phase
        restart = at_bit_start | (state.ext_n <= 0)
        ext_p = jnp.where(ext_on, jnp.where(restart, prompt_w,
                                            state.ext_p + prompt_w), 0.0)
        ext_e = jnp.where(ext_on, jnp.where(restart, early_w,
                                            state.ext_e + early_w), 0.0)
        ext_l = jnp.where(ext_on, jnp.where(restart, late_w,
                                            state.ext_l + late_w), 0.0)
        ext_n = jnp.where(ext_on,
                          jnp.where(restart, 1, state.ext_n + 1), 0)
        close_now = ext_on & (ext_n == k_ext)
        # narrow-bandwidth closure on the coherent sums
        carr_err_ext = discriminators.pll_costas(ext_p) / (2.0 * jnp.pi)
        code_err_ext = discriminators.dll_nc_e_minus_l_normalized(
            jnp.abs(ext_e), jnp.abs(ext_l),
            jnp.float32(conf.early_late_space_chips))
        dop_ext, cf_ext, pll_ext, dll_ext = _dll_pll_update(
            conf, state, prompt_w, carr_err_ext, code_err_ext,
            t_int * k_ext, pll_bw_hz=conf.pll_bw_narrow_hz,
            dll_bw_hz=conf.dll_bw_narrow_hz, apply_fll=False)
        # select per channel: wide (pre-sync) | closed-extended | hold
        def sel3(wide_v, ext_v, hold_v):
            return jnp.where(~ext_on, wide_v,
                             jnp.where(close_now, ext_v, hold_v))
        carrier_doppler = sel3(carrier_doppler, dop_ext,
                               state.carrier_doppler)
        code_freq = sel3(code_freq, cf_ext, state.code_freq)
        pll_new = jax.tree.map(sel3, pll_new, pll_ext, state.pll)
        dll_new = jax.tree.map(sel3, dll_new, dll_ext, state.dll)
        ext_state_new = dict(
            bit_hist=hist, prev_sign=sign, bit_synced=bit_synced,
            bit_phase=bit_phase,
            ext_p=jnp.where(close_now, 0.0, ext_p),
            ext_e=jnp.where(close_now, 0.0, ext_e),
            ext_l=jnp.where(close_now, 0.0, ext_l),
            ext_n=jnp.where(close_now, 0, ext_n))
    else:
        ext_state_new = dict(
            bit_hist=state.bit_hist, prev_sign=state.prev_sign,
            bit_synced=state.bit_synced, bit_phase=state.bit_phase,
            ext_p=state.ext_p, ext_e=state.ext_e, ext_l=state.ext_l,
            ext_n=state.ext_n)

    # --- NCO phase carry (with the freqs USED this epoch, for continuity;
    # the KF additionally feeds its phase-error estimates straight into the
    # NCO remnants — the error-state feedback form of kf_tracking) ---------
    rem_code = (state.rem_code_phase + state.code_freq * t_int - code_len
                + dtau_chips)
    carr_adv_cycles = state.carrier_doppler * t_int + dphi_cyc
    rem_carr = jnp.mod(state.rem_carr_phase
                       + 2.0 * jnp.pi * carr_adv_cycles, 2.0 * jnp.pi)
    # Kahan accumulation of total carrier cycles
    y = carr_adv_cycles - state.acc_phase_comp
    t_sum = state.acc_phase_cycles + y
    comp = (t_sum - state.acc_phase_cycles) - y
    pos_next = state.pos + n_c

    # --- C/N0 + lock detection every cn0_window epochs (:972-1035) ---------
    # C/N0 + lock accumulators use the secondary-wiped prompt (on pilots
    # the raw NB sums would be crushed by the NH sign flips)
    acc = cn0_ops.accumulate(state.cn0_acc, prompt_w)
    window_done = jnp.mod(state.epoch + 1, conf.cn0_window_epochs) == 0
    cn0_new = cn0_ops.cn0_m2m4_estimate(acc, t_int)
    # exponentially smoothed lock test (reference Exponential_Smoother on
    # d_carrier_lock_test, dll_pll_veml_tracking.cc:549-553)
    lock_new = (0.75 * state.carrier_lock
                + 0.25 * cn0_ops.carrier_lock_value(
                    acc, rectify=conf.lock_rectify))
    cn0_db = jnp.where(window_done, cn0_new, state.cn0_db_hz)
    carrier_lock = jnp.where(window_done, lock_new, state.carrier_lock)
    in_transitory = state.epoch < conf.fll_pullin_epochs
    locked = ((carrier_lock > conf.carrier_lock_threshold)
              & (cn0_db > conf.cn0_min_db_hz)) | in_transitory
    fail, lost = cn0_ops.update_lock_counters(
        state.lock_fail, locked, jnp.float32(conf.max_lock_fail))
    fail = jnp.where(window_done, fail, state.lock_fail)
    lost = jnp.where(window_done, lost | state.lock_lost, state.lock_lost)
    acc = jax.tree.map(
        lambda a: jnp.where(window_done, jnp.zeros_like(a), a), acc)

    # --- masked commit (inactive channels advance nominally) ---------------
    act = state.active
    nominal_n = jnp.int32(conf.nominal_epoch_samples)

    def sel(new, old):
        return jnp.where(act, new, old)

    new_state = TrackState(
        active=act & ~lost,
        pos=jnp.where(act, pos_next, state.pos + nominal_n),
        rem_code_phase=sel(rem_code, state.rem_code_phase),
        code_freq=sel(code_freq, state.code_freq),
        carrier_doppler=sel(carrier_doppler, state.carrier_doppler),
        rem_carr_phase=sel(rem_carr, state.rem_carr_phase),
        acc_phase_cycles=sel(t_sum, state.acc_phase_cycles),
        acc_phase_comp=sel(comp, state.acc_phase_comp),
        dll=jax.tree.map(sel, dll_new, state.dll),
        pll=jax.tree.map(sel, pll_new, state.pll),
        prompt_prev=sel(prompt_w, state.prompt_prev),
        epoch=jnp.where(act, state.epoch + 1, state.epoch),
        cn0_acc=jax.tree.map(sel, acc, state.cn0_acc),
        cn0_db_hz=sel(cn0_db, state.cn0_db_hz),
        carrier_lock=sel(carrier_lock, state.carrier_lock),
        lock_fail=sel(fail, state.lock_fail),
        lock_lost=sel(lost, state.lock_lost),
        kf_p=jnp.where(act[:, None, None], kf_p_new, state.kf_p),
        kf_fdot=sel(kf_fdot_new, state.kf_fdot),
        bit_hist=jnp.where(act[:, None], ext_state_new["bit_hist"],
                           state.bit_hist),
        prev_sign=sel(ext_state_new["prev_sign"], state.prev_sign),
        bit_synced=sel(ext_state_new["bit_synced"], state.bit_synced),
        bit_phase=sel(ext_state_new["bit_phase"], state.bit_phase),
        ext_p=sel(ext_state_new["ext_p"], state.ext_p),
        ext_e=sel(ext_state_new["ext_e"], state.ext_e),
        ext_l=sel(ext_state_new["ext_l"], state.ext_l),
        ext_n=sel(ext_state_new["ext_n"], state.ext_n),
        sec_buf=jnp.where(act[:, None], sec_state_new["sec_buf"],
                          state.sec_buf),
        sec_synced=sel(sec_state_new["sec_synced"], state.sec_synced),
        sec_off=sel(sec_state_new["sec_off"], state.sec_off),
        sec_polarity=sel(sec_state_new["sec_polarity"],
                         state.sec_polarity),
        bayes_nu=sel(bayes_new[0], state.bayes_nu),
        bayes_psi_code=sel(bayes_new[1], state.bayes_psi_code),
        bayes_psi_carr=sel(bayes_new[2], state.bayes_psi_carr),
    )
    outputs = {
        # telemetry consumes "prompt": in track_pilot mode that is the
        # DATA component's prompt; the pilot prompt stays available for
        # diagnostics
        "prompt": data_prompt if data_prompt is not None else prompt,
        "pilot_prompt": prompt,
        "early_mag": jnp.abs(early),
        "late_mag": jnp.abs(late),
        "carrier_doppler_hz": state.carrier_doppler,
        "code_freq_cps": state.code_freq,
        "rem_code_phase_chips": state.rem_code_phase,
        # accumulated carrier phase at epoch END (cycles; Kahan: the
        # compensation holds the EXCESS added, so true sum = t - c)
        "acc_phase_cycles": t_sum - comp,
        # replica chips past the code boundary at epoch end, in samples:
        # the exact (fractional) receiver sample of the boundary is
        # sample_counter - code_phase_samples (gnss_synchro.h
        # Code_phase_samples; used by observables' compute_T_rx_s)
        "code_phase_samples": rem_code * jnp.float32(fs) / state.code_freq,
        "pos_start": state.pos,
        "n_samples": n_c,
        "cn0_db_hz": cn0_db,
        "valid": act,
    }
    return new_state, outputs


@partial(jax.jit, static_argnames=("conf", "n_epochs"))
def track_chunk(conf: TrackingConf, n_epochs: int, codes: jax.Array,
                taps: jax.Array, x_chunk: jax.Array, state: TrackState,
                data_codes: jax.Array | None = None):
    """Scan `n_epochs` code epochs of every channel over one sample chunk."""
    def body(s, _):
        return _epoch_step(conf, codes, taps, x_chunk, s, data_codes)
    return jax.lax.scan(body, state, None, length=n_epochs)


# keys of the float32 part of the packed transfer, fixed order (prompt is
# split into real/imag rows because the transport may not carry complex64).
# The lean set is what the steady-state host pipeline (telemetry +
# observables + FSM) consumes; the full set adds the diagnostic planes for
# dumps / monitors / collect_track_outputs.
_PACK_F32_LEAN = ("prompt_re", "carrier_doppler_hz", "acc_phase_cycles",
                  "code_phase_samples", "cn0_db_hz", "valid")
_PACK_F32_FULL = _PACK_F32_LEAN + ("prompt_im", "early_mag", "late_mag",
                                   "code_freq_cps", "rem_code_phase_chips")
# int32 part: per-epoch sample bookkeeping + per-channel scan-state meta
_PACK_I32 = ("pos_start", "n_samples")


@partial(jax.jit, static_argnames=("conf", "n_epochs", "full_outputs"))
def track_chunk_packed(conf: TrackingConf, n_epochs: int, codes: jax.Array,
                       taps: jax.Array, x_chunk: jax.Array,
                       state: TrackState, full_outputs: bool = True,
                       data_codes: jax.Array | None = None):
    """track_chunk + on-device packing of every output the host needs into
    ONE dense array, so one chunk costs one device->host transfer
    instead of ~15.

    Returns (new_state, buf) where buf is ONE flat int32 array:
    the 11 float32 output planes bitcast to int32 ([11*T*C]), then
    pos_start/n_samples ([2*T*C]) and new_state.pos / active / lock_lost
    ([3*C]) — so the host FSM reads everything in a single pull.
    """
    new_state, outs = track_chunk(conf, n_epochs, codes, taps, x_chunk,
                                  state, data_codes)
    planes = dict(
        prompt_re=jnp.real(outs["prompt"]),
        prompt_im=jnp.imag(outs["prompt"]),
        early_mag=outs["early_mag"], late_mag=outs["late_mag"],
        carrier_doppler_hz=outs["carrier_doppler_hz"],
        code_freq_cps=outs["code_freq_cps"],
        rem_code_phase_chips=outs["rem_code_phase_chips"],
        acc_phase_cycles=outs["acc_phase_cycles"],
        code_phase_samples=outs["code_phase_samples"],
        cn0_db_hz=outs["cn0_db_hz"],
        valid=outs["valid"].astype(jnp.float32))
    keys = _PACK_F32_FULL if full_outputs else _PACK_F32_LEAN
    f32 = jnp.stack([planes[k] for k in keys])
    buf = jnp.concatenate([
        jax.lax.bitcast_convert_type(f32, jnp.int32).ravel(),
        outs["pos_start"].astype(jnp.int32).ravel(),
        outs["n_samples"].astype(jnp.int32).ravel(),
        new_state.pos.astype(jnp.int32),
        new_state.active.astype(jnp.int32),
        new_state.lock_lost.astype(jnp.int32)])
    return new_state, buf


# float planes pulled at the decimated (observable-tick) stride, fixed order
_DECIM_F32 = ("carrier_doppler_hz", "acc_phase_cycles",
              "code_phase_samples", "cn0_db_hz")


@partial(jax.jit, static_argnames=("win",))
def _window_slice(x, start, win: int):
    """Contiguous device-side window cut (traced start, static pow2
    length): every chunk's scan runs against a window barely larger than
    what it reads instead of the whole capture, and the pow2 length keeps
    the number of compiled window shapes small."""
    return jax.lax.dynamic_slice_in_dim(x, start, win)


@partial(jax.jit, static_argnames=("conf", "n_epochs", "decim"))
def track_chunk_packed_decim(conf: TrackingConf, n_epochs: int, decim: int,
                             codes: jax.Array, taps: jax.Array,
                             x_chunk: jax.Array, state: TrackState,
                             data_codes: jax.Array | None = None):
    """track_chunk with the device->host transfer cut to what the host
    pipeline actually consumes per rate class:

    - telemetry runs at SYMBOL rate: per-epoch prompt-I as int8 (scaled per
      channel; -128 = invalid epoch) — 1 byte instead of 32;
    - observables/PVT run at TICK rate: the float planes (_DECIM_F32) and
      the sample counter only every `decim`-th epoch (the observable
      interval, e.g. 20 x 1 ms).  The observables engine linearly
      interpolates at tick times anyway, and every plane is smooth on the
      20 ms scale (Doppler-rate curvature over 20 ms is ~1e-7 samples /
      3e-5 cycles), so nothing is lost;
    - the FSM runs at CHUNK rate: per-channel meta once per chunk.

    This is the steady-state transfer format: ~2.2 B/epoch/channel vs 32.

    Returns (new_state, sym_i8 [T, C], buf_i32) with buf_i32 =
    [4 f32 planes at rows (decim-1, 2*decim-1, ...) bitcast | sample
    counter i32 at rows | new pos C | active C | lock_lost C | scale C
    (f32 bitcast)].
    """
    new_state, outs = track_chunk(conf, n_epochs, codes, taps, x_chunk,
                                  state, data_codes)
    pre = jnp.real(outs["prompt"])                      # [T, C]
    valid = outs["valid"]
    scale = jnp.maximum(jnp.max(jnp.abs(pre), axis=0) / 126.0,
                        jnp.float32(1e-20))             # [C]
    q = jnp.clip(jnp.round(pre / scale), -126.0, 126.0).astype(jnp.int8)
    sym = jnp.where(valid, q, jnp.int8(-128))
    rows = jnp.arange(decim - 1, n_epochs, decim)
    f32 = jnp.stack([outs[k][rows] for k in _DECIM_F32])  # [4, Td, C]
    sc = (outs["pos_start"][rows]
          + outs["n_samples"][rows]).astype(jnp.int32)    # [Td, C]
    # pack the int8 symbol plane into the same int32 buffer (4 symbols
    # per word): ONE pull per chunk
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


class TrackingEngine:
    """Host-side wrapper: absolute sample bookkeeping + acq handoff.

    The caller feeds monotonically advancing sample arrays; the engine
    slices per-chunk windows, runs the jitted scan, and returns [T, C]
    epoch outputs with absolute sample counters (the
    Tracking_sample_counter of gnss_synchro.h).
    """

    def __init__(self, conf: TrackingConf, prns, code_provider=None,
                 data_code_provider=None):
        """code_provider(prn) -> +-1 sub-chip table of length
        conf.code_length_chips (defaults to GPS L1 C/A).  For BOC signals
        pass the sub-chip-expanded table (signals.subchip_table) with conf
        rates in sub-chip units.  With conf.track_pilot,
        data_code_provider supplies the DATA component's table for the
        separate data-prompt correlator."""
        self.conf = conf
        self.prns = [int(p) for p in prns]
        self.n_channels = len(self.prns)
        self.code_provider = code_provider or prn_codes.gps_l1_ca_code
        self.data_code_provider = data_code_provider
        # band-limited sub-chip replica tables: both kernels (per-epoch
        # gather and block-FFT) correlate against the SAME filtered
        # waveform, so amplitudes, lock points and therefore pseudorange
        # conventions agree across kernel handoffs (RTK DD cancellation;
        # see prn_codes.bandlimited_table)
        self.table_oversample = 8
        # prn <= 0 = unassigned channel (zero code row until reassignment)
        self.codes = jnp.asarray(np.stack([
            self._replica_table(self.code_provider, p)
            for p in self.prns]))
        self.data_codes = None
        if conf.track_pilot and data_code_provider is not None:
            self.data_codes = jnp.asarray(np.stack([
                self._replica_table(data_code_provider, p)
                for p in self.prns]))
        d = conf.early_late_space_chips
        dv = conf.very_early_late_space_chips
        if dv > 0.0:   # 5-tap VEML (reference very-early spacing, e.g. E1)
            tap_list = [+dv, +d / 2, 0.0, -d / 2, -dv]
        else:
            tap_list = [+d / 2, 0.0, -d / 2]
        self.taps = jnp.asarray(np.array(tap_list, np.float32))
        self.state = _init_state(self.n_channels)
        # full diagnostic output planes (prompt Q, early/late, code freq)
        # in the packed pull; the receiver enables this only for
        # collect_track_outputs / dump / monitor consumers
        self.full_outputs = True
        self._pos0 = jnp.zeros(self.n_channels, jnp.int32)  # cached rezero
        self.abs_start = np.zeros(self.n_channels, np.int64)  # abs sample of pos==0
        # --- chunk chaining / pipelining state --------------------------
        # After the first dispatch, state.pos is DEVICE-authoritative
        # (relative to _chain_base); process_begin rebases it with an
        # exact integer shift instead of overwriting from the host
        # mirror, so a second chunk can be dispatched BEFORE the first
        # chunk's pull (the receiver's pipelined batch mode).  abs_start
        # then holds code-frequency-aware PREDICTIONS, corrected to the
        # pulled exact positions as pulls drain.
        self._chain_base = None       # window base state.pos refers to
        self._armed_since: set = set()  # channels re-armed since last begin
        self._armed_seq = np.full(self.n_channels, -1, np.int64)
        self._abs_f = np.zeros(self.n_channels, np.float64)
        self._code_freq_host = np.full(self.n_channels,
                                       conf.code_rate_cps, np.float64)
        self._dispatch_seq = 0
        # host mirrors of the scan-state flags, refreshed from the packed
        # per-chunk transfer — the FSM never pulls device scalars
        self.active_host = np.zeros(self.n_channels, bool)
        self.lock_lost_host = np.zeros(self.n_channels, bool)
        # block-kernel tables (models.tracking_block), built lazily
        self._codes_fft = None
        self._data_codes_fft = None
        self._sec_code_dev = None

    def _replica_table(self, provider, prn: int) -> np.ndarray:
        if prn <= 0:
            return np.zeros(
                self.conf.code_length_chips * self.table_oversample,
                np.float32)
        return prn_codes.bandlimited_table_normalized(
            np.asarray(provider(prn), np.float32), self.conf.fs,
            self.conf.code_rate_cps, self.conf.nominal_epoch_samples,
            self.table_oversample)

    def set_channel_prn(self, ch: int, prn: int) -> None:
        """Re-point a channel at a different satellite (channel/satellite
        reassignment, gnss_flowgraph.cc apply_action): swaps the device
        code-table row."""
        self.prns[ch] = int(prn)
        self.codes = self.codes.at[ch].set(
            jnp.asarray(self._replica_table(self.code_provider, int(prn))))
        if self.data_codes is not None:
            self.data_codes = self.data_codes.at[ch].set(
                jnp.asarray(self._replica_table(self.data_code_provider,
                                                int(prn))))
        self._codes_fft = None          # block tables now stale
        self._data_codes_fft = None

    def stop_channel(self, ch: int) -> None:
        self.state = self.state._replace(
            active=self.state.active.at[ch].set(False))
        self.active_host[ch] = False

    def start_tracking(self, ch: int, doppler_hz: float,
                       abs_code_start_sample: int) -> None:
        """Arm channel `ch` from an acquisition result: first epoch starts
        at the absolute sample where a code period begins
        (acq samplestamp + delay), Doppler seeds the PLL integrator
        (reference start_tracking(), dll_pll_veml_tracking.cc:643-884)."""
        code_freq0 = (self.conf.code_rate_cps
                      * (1.0 + (doppler_hz - self.conf.doppler_bias_hz)
                         / self.conf.carrier_freq_hz))
        self.state = _arm_channel(self.state, ch, float(doppler_hz),
                                  float(code_freq0))
        self.abs_start[ch] = int(abs_code_start_sample)
        self._abs_f[ch] = float(abs_code_start_sample)
        self._code_freq_host[ch] = code_freq0
        self._armed_since.add(ch)
        self._armed_seq[ch] = self._dispatch_seq
        self.active_host[ch] = True
        self.lock_lost_host[ch] = False


    def max_position(self) -> int:
        """Largest absolute sample position over active channels (how far
        into the stream the next epoch would read).  Uses the host
        mirrors; state.pos is always rezeroed after a chunk."""
        active = self.active_host
        if not active.any():
            return 0
        return int(self.abs_start[active].max())

    def _read_margin(self) -> int:
        """Samples a chunk may read past its last epoch: the larger of
        the per-epoch correlator block and the block-FFT kernel's window
        (+guards).  Using the block-capable margin EVERYWHERE keeps chunk
        sizing identical between batch and streaming sessions, so the
        kernel choice (use_blocks) never flips on buffer-end proximity
        and the two modes stay numerically identical."""
        m = self.conf.block_size + 64
        if (self.conf.tracking_mode == "dll_pll"
                and self.conf.extend_correlation_symbols == 1):
            from gnss_sim_receiver_tpu.models import tracking_block as tb
            m = max(m, tb.block_fft_size(self.conf) + 256 + 64)
        return m

    def epochs_that_fit(self, stream_len: int) -> int:
        """How many epochs every active channel can run without reading
        past `stream_len` samples (worst-case epoch length nominal+2)."""
        return max(0, int((stream_len - self._read_margin()
                           - self.max_position())
                          // (self.conf.nominal_epoch_samples + 2)))

    def process(self, x: np.ndarray, x_abs_start: int, n_epochs: int):
        """Track `n_epochs` epochs using samples `x` (absolute start index
        `x_abs_start`).  Caller must supply enough samples:
        max(pos) + n_epochs*nominal + block_size within x.

        The whole chunk costs ONE device->host transfer
        (track_chunk_packed)."""
        return self.process_end(self.process_begin(x, x_abs_start,
                                                   n_epochs))

    def _ensure_block_tables(self):
        from gnss_sim_receiver_tpu.models import tracking_block as tb
        if self._codes_fft is not None:
            return
        # spectra from the SAME band-limited tables the per-epoch kernel
        # gathers from (one replica convention for both kernels)
        self._codes_fft = tb.code_spectra(self.conf, np.asarray(self.codes))
        if self.conf.track_pilot and self.data_codes is not None:
            self._data_codes_fft = tb.code_spectra(
                self.conf, np.asarray(self.data_codes))
        if len(self.conf.secondary_code) > 0:
            sec = np.asarray(self.conf.secondary_code, np.float32)
            if set(np.unique(sec)) <= {0.0, 1.0}:
                sec = 2.0 * sec - 1.0
            self._sec_code_dev = jnp.asarray(sec)

    @property
    def block_epochs(self) -> int:
        """Epochs per block for the block kernel: ~20 ms of signal (the
        reference's extended-integration cadence), so the loops close at
        a cadence set by the signal alone."""
        return max(2, int(round(0.02 / self.conf.t_epoch_nominal_s)))

    def block_mode_ok(self, n_epochs: int) -> bool:
        """Whether this chunk can run on the block kernel."""
        return (self.conf.tracking_mode == "dll_pll"
                and self.conf.extend_correlation_symbols == 1
                and not self.full_outputs
                and n_epochs % self.block_epochs == 0
                and n_epochs >= 2 * self.block_epochs)

    def process_begin(self, x: np.ndarray, x_abs_start: int,
                      n_epochs: int, decim: int | None = None,
                      use_blocks: bool = False):
        """Dispatch the chunk's device scan and START its async
        device->host copy; returns an opaque handle for process_end.
        Several engines' chunks can be in flight at once (their copies
        overlap on the transport), which the multi-chain receiver uses to
        pay ~one transfer latency per chunk instead of one per chain.

        `decim` > 1 selects the rate-split transfer format
        (track_chunk_packed_decim): int8 prompt symbols per epoch +
        observable planes every decim-th epoch.  process_end then returns
        the decimated planes under the usual keys ([Td, C] instead of
        [T, C]) plus full-rate "prompt"/"valid" ([T, C], expanded
        host-side from the symbols) and "rows" (the kept epoch indices
        within the chunk)."""
        active = self.active_host
        if not active.any():
            raise RuntimeError("no active channels")
        # chunk-relative positions: channel c's pos is relative to
        # abs_start[c]; rebase everything onto x's indexing
        rel = self.abs_start - x_abs_start
        if (rel[active] < 0).any():
            raise ValueError("sample array starts after a channel position")
        if int(rel.max()) + n_epochs * (self.conf.nominal_epoch_samples + 2) \
                >= 2 ** 31:
            raise ValueError(
                "chunk-relative position would overflow int32; feed the "
                "engine a windowed sample array with a larger x_abs_start")
        use_blk = (use_blocks and decim is not None and decim > 1
                   and self.block_mode_ok(n_epochs))
        # the block kernel reads a [pos-128, pos+e_block*s0+NFFT+256)
        # window per block — wider than the per-epoch kernel's
        # block_size; size `need` for whichever kernel runs so a tight
        # tail falls back to the per-epoch kernel instead of feeding the
        # gather clamped (= silently shifted) samples
        if use_blk:
            from gnss_sim_receiver_tpu.models import tracking_block as tb
            blk_extra = tb.block_fft_size(self.conf) + 256
        else:
            blk_extra = 0
        need0 = int(rel[active].max()) + n_epochs * (
            self.conf.nominal_epoch_samples + 2) + self.conf.block_size
        if use_blk and len(x) < need0 + blk_extra:
            use_blk = False
            blk_extra = 0
        need = need0 + blk_extra
        if len(x) < need:
            raise ValueError(f"need >= {need} samples, got {len(x)}")
        # window the capture down to what this chunk reads (see
        # _window_slice): inactive channels are parked on their own
        # positions, so rebase ALL rel onto the window start and mask
        # inactive ones to 0 (their rows are discarded anyway).  The
        # pre-position margin must cover the block kernel's 128-sample
        # guard (the in-kernel g_eff clamp keeps even margin-less
        # positions correct, at slightly reduced early-window context)
        rmin = int(rel[active].min())
        span = need - rmin + 384
        win_len = max(1 << (span - 1).bit_length(), 1 << 18)
        if len(x) > 2 * win_len:
            start0 = max(0, min(rmin - 256, len(x) - win_len))
            x = x[start0:start0 + win_len] if isinstance(x, np.ndarray) \
                else _window_slice(x, jnp.int32(start0), win_len)
            x_abs_start = x_abs_start + start0
            rel = np.where(active, rel - start0, 0)
        if self._chain_base is None:
            state = self.state._replace(pos=jnp.asarray(rel, jnp.int32))
        else:
            # exact device-side rebase from the previous window base;
            # only channels (re)armed since the last dispatch take the
            # host value (their abs_start was just set exactly)
            pos_dev = self.state.pos + jnp.int32(self._chain_base
                                                 - x_abs_start)
            if self._armed_since:
                mask = np.zeros(self.n_channels, bool)
                mask[list(self._armed_since)] = True
                pos_dev = jnp.where(jnp.asarray(mask),
                                    jnp.asarray(rel, jnp.int32), pos_dev)
            state = self.state._replace(pos=pos_dev)
        self._armed_since.clear()
        x_dev = jnp.asarray(x)
        if use_blk:
            from gnss_sim_receiver_tpu.models import tracking_block as tb
            self._ensure_block_tables()
            e_blk = self.block_epochs
            new_state, buf = tb.track_chunk_blocks_packed_decim(
                self.conf, n_epochs // e_blk, e_blk, int(decim),
                self._codes_fft, self.taps, x_dev, state,
                sec_code=self._sec_code_dev,
                data_codes_rep=self._data_codes_fft)
            meta = self._chain_dispatch(new_state, x_abs_start, n_epochs)
            return ("decim", new_state, buf, int(x_abs_start),
                    int(n_epochs), int(decim), meta)
        if decim is not None and decim > 1 and not self.full_outputs:
            new_state, buf = track_chunk_packed_decim(
                self.conf, int(n_epochs), int(decim), self.codes,
                self.taps, x_dev, state, data_codes=self.data_codes)
            # the pull is a blocking np.asarray in process_end (no
            # copy_to_host_async is started here)
            meta = self._chain_dispatch(new_state, x_abs_start, n_epochs)
            return ("decim", new_state, buf, int(x_abs_start),
                    int(n_epochs), int(decim), meta)
        new_state, buf = track_chunk_packed(
            self.conf, int(n_epochs), self.codes, self.taps, x_dev, state,
            full_outputs=self.full_outputs, data_codes=self.data_codes)
        # pulled by process_end, as in the decim branch
        meta = self._chain_dispatch(new_state, x_abs_start, n_epochs)
        return ("full", new_state, buf, int(x_abs_start), int(n_epochs),
                meta)

    def _chain_dispatch(self, new_state, x_abs_start: int,
                        n_epochs: int) -> dict:
        """Advance the engine to the just-dispatched chunk: state becomes
        the (lazy) post-chunk device state; abs_start advances by a
        code-frequency-aware prediction (exact-ified later by the pull).
        Returns the handle metadata process_end needs."""
        self.state = new_state            # pos stays window-relative
        self._chain_base = int(x_abs_start)
        self._dispatch_seq += 1
        act = self.active_host
        s_per = (self.conf.fs * self.conf.code_length_chips
                 / self._code_freq_host)
        self._abs_f = np.where(act, self._abs_f + n_epochs * s_per,
                               self._abs_f)
        self.abs_start = np.round(self._abs_f).astype(np.int64)
        return {"seq": self._dispatch_seq,
                "pred_end": self._abs_f.copy()}

    def process_end(self, handle):
        """Materialize a process_begin handle: one blocking pull, then the
        host-side unpacking/bookkeeping."""
        if handle[0] == "decim":
            return self._process_end_decim(handle)
        _, new_state, buf, x_abs_start, n_epochs, meta = handle
        t, c = int(n_epochs), self.n_channels
        raw = np.ascontiguousarray(np.asarray(buf))  # THE one transfer
        keys = _PACK_F32_FULL if self.full_outputs else _PACK_F32_LEAN
        nf = len(keys)
        fbuf = raw[: nf * t * c].view(np.float32).reshape(nf, t, c)
        ibuf = raw[nf * t * c:]
        outs = {k: fbuf[i] for i, k in enumerate(keys)}
        im = outs.pop("prompt_im") if self.full_outputs else 0.0
        outs["prompt"] = (outs.pop("prompt_re") + 1j * im
                          ).astype(np.complex64)
        outs["valid"] = outs["valid"] > 0.5
        pos_start = ibuf[: t * c].reshape(t, c).astype(np.int64)
        n_samples = ibuf[t * c: 2 * t * c].reshape(t, c).astype(np.int64)
        new_pos = ibuf[2 * t * c: 2 * t * c + c].astype(np.int64)
        # channels (re)armed AFTER this chunk's dispatch: the pulled
        # flags describe the channel's PREVIOUS life — keep the host's
        # post-arm values (else a stale pull deactivates a fresh channel
        # and the next window excludes it)
        _stale = self._armed_seq >= meta["seq"]
        self.active_host = np.where(
            _stale, self.active_host,
            ibuf[2 * t * c + c: 2 * t * c + 2 * c] > 0)
        self.lock_lost_host = np.where(
            _stale, self.lock_lost_host,
            ibuf[2 * t * c + 2 * c:] > 0)
        outs["pos_start"] = pos_start
        outs["n_samples"] = n_samples
        outs["sample_counter"] = pos_start + x_abs_start + n_samples
        outs["stale_channels"] = self._armed_seq >= meta["seq"]
        self._apply_pull(meta, new_pos + x_abs_start,
                         outs["carrier_doppler_hz"][-1]
                         if "carrier_doppler_hz" in outs else None)
        return outs

    def _process_end_decim(self, handle):
        """Materialize a decimated handle (track_chunk_packed_decim): ONE
        pull, then host-side unpacking."""
        _, new_state, buf, x_abs_start, n_epochs, decim, meta = handle
        t, c = int(n_epochs), self.n_channels
        rows = np.arange(decim - 1, t, decim)
        td = len(rows)
        raw = np.asarray(buf)                              # flat int32
        n_sym_words = (t * c + 3) // 4
        sym = raw[:n_sym_words].view(np.int8)[: t * c].reshape(t, c)
        raw = raw[n_sym_words:]
        nf = len(_DECIM_F32)
        fbuf = raw[: nf * td * c].view(np.float32).reshape(nf, td, c)
        ibuf = raw[nf * td * c:]
        sc = ibuf[: td * c].reshape(td, c).astype(np.int64)
        new_pos = ibuf[td * c: td * c + c].astype(np.int64)
        _stale = self._armed_seq >= meta["seq"]   # see process_end note
        self.active_host = np.where(
            _stale, self.active_host,
            ibuf[td * c + c: td * c + 2 * c] > 0)
        self.lock_lost_host = np.where(
            _stale, self.lock_lost_host,
            ibuf[td * c + 2 * c: td * c + 3 * c] > 0)
        scale = ibuf[td * c + 3 * c:].view(np.float32)
        outs = {k: fbuf[i] for i, k in enumerate(_DECIM_F32)}
        valid_full = sym != np.int8(-128)
        outs["prompt"] = np.where(valid_full, sym, 0).astype(
            np.float32) * scale[None, :]
        outs["symbols_i8"] = sym
        outs["sym_scale"] = scale
        outs["valid_full"] = valid_full                    # [T, C]
        outs["valid"] = valid_full[rows]                   # [Td, C]
        outs["rows"] = rows
        outs["sample_counter"] = sc + x_abs_start
        # channels (re)armed AFTER this chunk was dispatched: the rows
        # belong to the channel's PREVIOUS life — the consumer must
        # ignore them (pipelined mode arm race)
        outs["stale_channels"] = self._armed_seq >= meta["seq"]
        self._apply_pull(meta, new_pos + x_abs_start,
                         outs["carrier_doppler_hz"][-1] if td else None)
        return outs

    def _apply_pull(self, meta: dict, exact_end: np.ndarray,
                    last_doppler) -> None:
        """Fold one chunk's pulled exact end positions back into the
        prediction chain: the prediction error for THAT chunk shifts the
        whole accumulated prediction (later dispatched chunks advanced
        from it), and the code-frequency mirror refreshes for the next
        prediction.  self.state is NOT touched here — process_begin owns
        it (it may already be several chunks ahead)."""
        # a channel (re)armed AFTER this chunk was dispatched has a
        # freshly-set exact position — this (older) pull must not
        # "correct" it
        ok = self.active_host & (self._armed_seq < meta["seq"])
        err = np.where(ok, exact_end.astype(np.float64)
                       - meta["pred_end"], 0.0)
        self._abs_f = self._abs_f + err
        self.abs_start = np.round(self._abs_f).astype(np.int64)
        if last_doppler is not None:
            dop = np.asarray(last_doppler, np.float64)
            fresh = ok & np.isfinite(dop)
            self._code_freq_host = np.where(
                fresh,
                self.conf.code_rate_cps
                * (1.0 + (dop - self.conf.doppler_bias_hz)
                   / self.conf.carrier_freq_hz),
                self._code_freq_host)

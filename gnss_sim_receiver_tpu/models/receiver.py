"""Receiver driver: host-side orchestration of the full chain.

The framework's control plane — the role of the reference's
ControlThread + GNSSFlowgraph + per-channel FSM (src/core/receiver/
control_thread.cc, gnss_flowgraph.cc, channel_fsm): acquisition
scheduling with re-acquisition and satellite rotation, acquisition ->
tracking handoff, chunked tracking over the sample stream, telemetry,
observables ticks and PVT epochs.  Device code (acquisition grids,
tracking scans) is pure dataflow; everything here is sequencing, driven by
the AcquisitionManager event model (models.control).

Multi-constellation: the receiver runs one *signal chain* per configured
signal (GPS L1 C/A "1C", Galileo E1B "1B", ...) over the same conditioned
sample stream — the reference's per-signal channel groups
(Channels_1C.count / Channels_1B.count, gnss_flowgraph.cc
set_signals_list) — each with its own acquisition grid, tracking scan and
telemetry decoder, all feeding one observables engine and one PVT solver.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.models.acquisition import (AcqConf,
                                                      PcpsAcquisitionEngine)
from gnss_sim_receiver_tpu.models.control import (AcquisitionManager,
                                                  ChannelState)
from gnss_sim_receiver_tpu.models.observables import (ObsConf,
                                                      ObservablesEngine)
from gnss_sim_receiver_tpu.models.pvt import (PvtConf, solve_pvt,
                                              solve_pvt_raim)
from gnss_sim_receiver_tpu.models.telemetry import TelemetryDecoder
from gnss_sim_receiver_tpu.models.tracking import TrackingConf, TrackingEngine


@dataclasses.dataclass
class SignalChainConf:
    """One per-signal channel group (the reference's Channels_<sig> block +
    its Acquisition_<sig>/Tracking_<sig> engine parameters)."""
    signal: str = "1C"                 # "1C" (GPS L1 C/A) | "1B" (GAL E1B)
    system: str = "GPS"
    prns: tuple = tuple(range(1, 33))
    n_channels: int = 8
    max_acq_channels: int = 8
    acq: AcqConf | None = None
    trk: TrackingConf | None = None
    code_provider: object = None       # prn -> +-1 sub-chip table
    sc_rate: float | None = None       # sub-chip rate for acquisition
    # track_pilot chains: the DATA component's sub-chip table (telemetry
    # prompt correlator; conf.trk.track_pilot selects the mode)
    data_code_provider: object = None

    # multi-band front end: which RF channel's conditioned stream this
    # chain consumes (Channels_<sig>.RF_channel_ID, gnss_flowgraph.cc
    # :1018-1019); each RF channel may run at its own fs (spec.trk.fs /
    # spec.acq.fs_in must match ReceiverConf.rf_fs[rf_channel_id])
    rf_channel_id: int = 0
    # acquisition-only resampler: integer decimation of this chain's
    # stream for the ACQUISITION path only
    # (GNSS-SDR.use_acquisition_resampler, gnss_flowgraph.cc:1028-1121 +
    # pcps_acquisition.cc:683-696 delay rescaling); tracking stays at
    # full fs.  1 = off.
    acq_decim: int = 1

    freq_slot: int = 0                 # GLONASS FDMA slot k (signal "1G")
    day_base_s: float = 0.0            # GLONASS day base for tk anchoring
    # chain-local channel index -> PRN pinning (Channel<i>.satellite)
    pinned: dict = dataclasses.field(default_factory=dict)
    # secondary-band behavior: when another chain of the same system (a
    # different carrier) exists, defer each PRN's acquisition until that
    # primary band has locked it and search only the Doppler-projected
    # narrow grid (gnss_flowgraph.cc:2615-2750 secondary-channel
    # dispatch + project_doppler).  Without a primary chain the gate is
    # inactive and the chain cold-starts normally.
    assist_wait: bool = False

    def telemetry_decoder(self, prns):
        if self.signal in ("B1", "B3"):
            # B3I carries the same D1 NAV / NH20 structure as B1I
            from gnss_sim_receiver_tpu.models.telemetry import \
                BeidouB1iTelemetryDecoder
            return BeidouB1iTelemetryDecoder(prns)
        if self.signal in ("1G", "2G"):
            from gnss_sim_receiver_tpu.models.telemetry import \
                GlonassTelemetryDecoder
            return GlonassTelemetryDecoder(
                prns, freq_slots={p: self.freq_slot for p in self.prns},
                day_base_s=self.day_base_s)
        if self.signal == "5X":
            from gnss_sim_receiver_tpu.models.telemetry import \
                GalileoE5aTelemetryDecoder
            return GalileoE5aTelemetryDecoder(prns)
        if self.signal == "7X":
            from gnss_sim_receiver_tpu.models.telemetry import \
                GalileoE5bTelemetryDecoder
            return GalileoE5bTelemetryDecoder(prns)
        if self.signal == "1B":
            from gnss_sim_receiver_tpu.models.telemetry import \
                GalileoE1bTelemetryDecoder
            return GalileoE1bTelemetryDecoder(prns)
        if self.signal in ("2S", "L5"):
            from gnss_sim_receiver_tpu.models.telemetry import \
                GpsCnavTelemetryDecoder
            return GpsCnavTelemetryDecoder(prns, signal=self.signal)
        if self.signal == "E6":
            from gnss_sim_receiver_tpu.models.telemetry import \
                GalileoE6bTelemetryDecoder
            return GalileoE6bTelemetryDecoder(prns)
        if self.signal == "S1":
            from gnss_sim_receiver_tpu.models.telemetry import \
                SbasL1TelemetryDecoder
            return SbasL1TelemetryDecoder(prns)
        return TelemetryDecoder(prns)


def galileo_e1b_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      track_pilot: bool = False,
                      **trk_overrides) -> SignalChainConf:
    """Convenience Galileo E1 chain: BOC(1,1) sub-chip engines, 4 ms
    coherent acquisition, PLL-only pull-in (the reference disables FLL for
    E1 for the same symbol-corruption reason).

    track_pilot=True mirrors the reference's default E1 configuration
    (Tracking_1B.track_pilot=true): the loops track the E1-C PILOT
    (CS25 secondary sync + wipeoff) while a separate data-prompt
    correlator taps E1-B for I/NAV telemetry
    (dll_pll_veml_tracking.cc:1050-1061)."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.GALILEO_E1B
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.sc_rate, code_length_chips=sig.sc_length,
        carrier_freq_hz=sig.carrier_freq_hz, early_late_space_chips=0.5,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    data_provider = None
    if track_pilot:
        trk_kw.update(
            track_pilot=True,
            secondary_code=tuple(
                int(v) for v in (signals.e1c_secondary_code() > 0)))
        code_provider = lambda p: signals.boc11_expand(
            signals.galileo_e1_code(p, "C"))
        data_provider = lambda p: signals.subchip_table(sig, p)
    else:
        code_provider = lambda p: signals.subchip_table(sig, p)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        signal="1B", system="Galileo", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=4, doppler_step=125.0,
                    max_dwells=2, make_two_steps=True, doppler_step2=31.25),
        trk=TrackingConf(**trk_kw),
        code_provider=code_provider,
        data_code_provider=data_provider,
        sc_rate=sig.sc_rate)


def gps_l2c_chain(fs: float, prns=tuple(range(1, 33)), n_channels=4,
                  **trk_overrides) -> SignalChainConf:
    """GPS L2C CM chain: 20 ms code epochs carrying one 50-sps CNAV
    symbol each (the GPS_L2_M_* blocks of the reference)."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.GPS_L2C_CM
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=8.0, dll_bw_hz=0.75,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=25, cn0_window_epochs=20)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="2S", system="GPS", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=20, doppler_max=5000.0,
                    doppler_step=60.0, max_dwells=1,
                    make_two_steps=True, doppler_step2=15.0,
                    bit_transition_flag=True),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)


def gps_l5_chain(fs: float, prns=tuple(range(1, 33)), n_channels=4,
                 **trk_overrides) -> SignalChainConf:
    """GPS L5I chain: 10.23 Mcps, 1 ms epochs, NH10-spread 100-sps CNAV
    symbols (GPS_L5_* blocks)."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.GPS_L5I
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=50.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="L5", system="GPS", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)


def galileo_e5a_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      **trk_overrides) -> SignalChainConf:
    """Galileo E5a-I chain: 10.23 Mcps, 1 ms epochs, CS20-spread 50-sps
    F/NAV symbols (the GALILEO_E5A_* blocks)."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.GALILEO_E5A_I
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=50.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="5X", system="Galileo", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)


def beidou_b3i_chain(fs: float, prns=tuple(range(6, 31)), n_channels=4,
                     **trk_overrides) -> SignalChainConf:
    """BeiDou B3I (MEO/IGSO, D1) chain: 10.23 Mcps, 1 ms epochs, NH20-spread
    50-bps D1 bits (the BEIDOU_B3I_* blocks of the reference factory)."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.BEIDOU_B3I
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=40.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="B3", system="BeiDou", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5,
                    bit_transition_flag=True),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)


def galileo_e5b_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      **trk_overrides) -> SignalChainConf:
    """Galileo E5b-I chain: 10.23 Mcps, 1 ms epochs, CS4-spread 250-sps
    I/NAV symbols (the GALILEO_E5B_* blocks of the reference factory,
    gnss_block_factory.cc signal '7X')."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.GALILEO_E5B_I
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=50.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="7X", system="Galileo", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)


def galileo_e6b_chain(fs: float, prns=tuple(range(1, 37)), n_channels=4,
                      **trk_overrides) -> SignalChainConf:
    """Galileo E6-B (HAS) chain: 5.115 Mcps memory codes, 1 ms epochs, one
    1000-sps C/NAV symbol per epoch (the reference's
    Galileo_E6_PCPS_Acquisition / Galileo_E6_DLL_PLL_Tracking /
    Galileo_E6 telemetry blocks, gnss_block_factory.cc:1012,1150)."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.GALILEO_E6B
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=50.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        # E6-B is a DATA component with one symbol per epoch: the coherent
        # NBD/NBP lock test zero-means over any window; use the rectified
        # detector (the reference instead tracks the E6-C pilot)
        lock_rectify=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="E6", system="Galileo", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)


def sbas_l1_chain(fs: float, prns=tuple(range(120, 139)), n_channels=2,
                  **trk_overrides) -> SignalChainConf:
    """SBAS L1 chain: GPS C/A chip plan on PRN 120-138, 500-sps conv-coded
    symbols (2 epochs each) — the reference's SBAS_L1_* blocks
    (sbas_l1_telemetry_decoder.cc adapter).  Data flips every 2 epochs at
    worst, so FLL pull-in stays off and the rectified lock test handles
    the zero-mean symbol stream."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.SBAS_L1
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=40.0,
        lock_rectify=True, enable_fll_pullin=True,
        fll_decision_directed=True)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        signal="S1", system="SBAS", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2, make_two_steps=True,
                    doppler_step2=62.5, bit_transition_flag=True),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)


def glonass_l1_chain(fs: float, prns, freq_slot: int = 0,
                     n_channels: int | None = None, day_base_s: float = 0.0,
                     **trk_overrides) -> SignalChainConf:
    """GLONASS L1 C/A chain for ONE frequency slot (FDMA: satellites on
    slot k acquire around doppler_center = k*562.5 kHz and track on the
    offset carrier; build one chain per occupied slot — the reference's
    per-PRN d_doppler_bias, pcps_acquisition.cc:211-230).  FLL pull-in
    stays ON (10 ms symbols corrupt only 1 in 10 FLL pairs) and the
    rectified lock test handles the zero-mean meander data."""
    from gnss_sim_receiver_tpu import constants, signals
    sig = signals.GLONASS_L1_CA
    df = constants.GLONASS_L1_DFREQ_HZ
    prns = tuple(prns)
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz + freq_slot * df,
        doppler_bias_hz=freq_slot * df,
        early_late_space_chips=0.5, lock_rectify=True,
        # 400-epoch FLL blend: the meander's 100 Hz data lines sit inside
        # the Costas capture range — a short FLL hand-over can leave a
        # ~100 Hz residual that false-locks onto a line (r4 regression
        # test: tests/test_glonass_chain.py)
        enable_fll_pullin=True, fll_pullin_epochs=400)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        signal="1G", system="GLONASS", prns=prns,
        n_channels=n_channels or len(prns),
        max_acq_channels=n_channels or len(prns),
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, doppler_center=freq_slot * df,
                    max_dwells=2, make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps,
        freq_slot=freq_slot, day_base_s=day_base_s)


def glonass_l2_chain(fs: float, prns, freq_slot: int = 0,
                     n_channels: int | None = None, day_base_s: float = 0.0,
                     **trk_overrides) -> SignalChainConf:
    """GLONASS L2 C/A chain ("2G"): the same 511-chip C/A code and GNAV
    stream on the 1246 MHz FDMA carrier (slot spacing 437.5 kHz) — the
    reference's GLONASS_L2_CA blocks (glonass_l2_ca_pcps_acquisition.cc /
    glonass_l2_ca_dll_pll_tracking.cc).  assist_wait lets an L1 lock
    project Doppler by the 7/9 carrier ratio."""
    from gnss_sim_receiver_tpu import constants, signals
    sig = signals.GLONASS_L2_CA
    df = constants.GLONASS_L2_DFREQ_HZ
    prns = tuple(prns)
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz + freq_slot * df,
        doppler_bias_hz=freq_slot * df,
        early_late_space_chips=0.5, lock_rectify=True,
        # 400-epoch FLL blend: the meander's 100 Hz data lines sit inside
        # the Costas capture range — a short FLL hand-over can leave a
        # ~100 Hz residual that false-locks onto a line (r4 regression
        # test: tests/test_glonass_chain.py)
        enable_fll_pullin=True, fll_pullin_epochs=400)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        assist_wait=True,
        signal="2G", system="GLONASS", prns=prns,
        n_channels=n_channels or len(prns),
        max_acq_channels=n_channels or len(prns),
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, doppler_center=freq_slot * df,
                    max_dwells=2, make_two_steps=True, doppler_step2=62.5),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps,
        freq_slot=freq_slot, day_base_s=day_base_s)


@dataclasses.dataclass
class ReceiverConf:
    fs: float = 2_000_000.0
    prns: tuple = tuple(range(1, 33))
    max_channels: int = 12
    max_acq_channels: int = 8         # Channels.in_acquisition
    acq: AcqConf | None = None
    trk: TrackingConf | None = None
    obs: ObsConf | None = None
    pvt: PvtConf | None = None
    chunk_epochs: int = 1000          # 1 ms epochs per chunk (chunk ~ 1 s)
    output_rate_ms: int = 20
    # PVT solve cadence (reference PVT.output_rate_ms vs
    # Observables.observable_interval_ms split): observable epochs form
    # every output_rate_ms; the solver runs only on epochs aligned to
    # pvt_rate_ms.  0 = solve on every observable epoch.
    pvt_rate_ms: int = 0
    enable_pvt_kf: bool = False        # PVT.enable_pvt_kf (Pvt_Kf analogue)
    # fork orbital-dynamics EKF (PVT.enable_pvt_ekf ->
    # models.pvt_ekf_orbital.PvtEkfOrbital, rtklib_pvt.cc:491-515 hook);
    # pvt_ekf holds an optional PvtEkfConf
    enable_pvt_ekf: bool = False
    pvt_ekf: object = None
    # telemetry fail-safe: drop a TRACKING channel that produced no valid
    # TOW for this long (gps_l1_ca_telemetry_decoder_gs.cc:448-460 +
    # the bit-sync time limit, dll_pll_veml_tracking.cc:1808-1815).
    # 0 disables.
    tlm_timeout_s: float = 30.0
    # multi-band front end: rf_channel_id -> sampling rate of that RF
    # channel's stream (attach_arrays / Multichannel_File_Signal_Source
    # role); unlisted RF channels run at `fs`
    rf_fs: dict = dataclasses.field(default_factory=dict)
    chains: tuple = ()                # extra SignalChainConfs beyond GPS L1;
    # set gps_chain=False to drop the implicit GPS L1 chain entirely
    gps_chain: bool = True
    # hybrid GNSS + pseudolite navigation (GNSS-SDR.hybrid_mode /
    # GNSS-SDR.pseudo_sat_ch_id): the designated global channel is a
    # pseudolite tracker whose observable feeds AOWR time transfer instead
    # of the position solution
    hybrid_mode: bool = False
    # GNSS-SDR.pre_2009_file (control_thread.cc:161): resolve the LNAV
    # 10-bit week into the 1999-2019 rollover era instead of aligning to
    # the current receiver date (old captures would otherwise mis-date)
    pre_2009_file: bool = False
    ps_channel: int = -1
    ps_range_m: float = 0.4           # known rx<->pseudolite range
    # rx clock handling (fork: rtklib_pvt.cc:910-917)
    enable_rx_clock_propagation: bool = False
    clk_prop_after_n_fixes: int = 10
    share_rx_clock_bias: bool = False
    # GPS-chain channel index -> PRN pinning (Channel<i>.satellite)
    pinned_channels: dict = dataclasses.field(default_factory=dict)
    # RTK relative positioning (PVT.positioning_mode = RTK_*): engine conf
    # (models.rtk.RtkConf) + known base position; the base observables
    # stream is passed to process_array (rtklib_rtkpos.cc relpos roles)
    rtk: object = None
    rtk_base_ecef_m: tuple = None

    def __post_init__(self):
        if self.acq is None:
            self.acq = AcqConf(fs_in=self.fs, max_dwells=2)
        if self.trk is None:
            self.trk = TrackingConf(fs=self.fs)
        if self.obs is None:
            self.obs = ObsConf(fs=self.fs, interval_ms=self.output_rate_ms)
        if self.hybrid_mode and self.obs.ps_channel != self.ps_channel:
            self.obs = dataclasses.replace(self.obs,
                                           ps_channel=self.ps_channel)
        if self.pvt is None:
            self.pvt = PvtConf()
        # observables history must out-span a tracking chunk (ticks are
        # pulled once per chunk)
        if self.obs.history_len < self.chunk_epochs + 128:
            self.obs = dataclasses.replace(
                self.obs, history_len=self.chunk_epochs + 128)

    def all_chains(self) -> list[SignalChainConf]:
        out = []
        if self.gps_chain:
            out.append(SignalChainConf(
                signal="1C", system="GPS", prns=tuple(self.prns),
                n_channels=self.max_channels,
                max_acq_channels=self.max_acq_channels,
                acq=self.acq, trk=self.trk,
                pinned=dict(self.pinned_channels)))
        out.extend(self.chains)
        if not out:
            raise ValueError("receiver configured with no signal chains")
        return out


@dataclasses.dataclass
class ReceiverRun:
    solutions: list            # [PvtSolution]
    observation_epochs: list   # [ObservationEpoch]
    channel_prns: list[int]    # final PRN per (global) channel (0 = idle)
    channel_states: list       # final ChannelState per channel
    ephemerides: dict          # prn (GPS) | (system, prn) -> GpsEphemeris
    events: list               # [(channel, ChannelEvent)]
    track_outputs: dict | None = None
    channel_systems: list = () # constellation per channel
    # decoded Galileo HAS messages (nav.has.HasData), E6-B chains only
    has_messages: list = dataclasses.field(default_factory=list)
    # hybrid-mode AOWR products: [(est_tx_tow_s, clock_diff_s)] per fix
    clock_differences: list = dataclasses.field(default_factory=list)
    # rx clock sharing records: [(rx_time_s, tag_tow_s, bias_s, prn)]
    rx_clock_bias_log: list = dataclasses.field(default_factory=list)
    # RTK products: [(rx_time_s, models.rtk.RtkSolution)] when
    # PVT.positioning_mode = RTK_* and a base stream was provided
    rtk_solutions: list = dataclasses.field(default_factory=list)
    # fork orbital EKF products: [(rx_time_s, pos_ecef, vel_ecef,
    # clock_bias_s, clock_drift_ss)] when PVT.enable_pvt_ekf
    ekf_solutions: list = dataclasses.field(default_factory=list)
    # PPP float-filter products: [(rx_time_s, models.ppp.PppSolution)]
    # when PVT.positioning_mode = PPP_*
    ppp_solutions: list = dataclasses.field(default_factory=list)
    # broadcast assistance decoded from LNAV subframes 4/5
    almanac: dict = dataclasses.field(default_factory=dict)
    iono_utc: object = None


class _ChainRt:
    """Runtime state of one signal chain."""

    def __init__(self, spec: SignalChainConf, obs_offset: int):
        self.spec = spec
        self.offset = obs_offset      # global channel index of channel 0
        n = spec.n_channels
        self.mgr = AcquisitionManager(spec.prns, n,
                                      max_acq_channels=spec.max_acq_channels,
                                      pinned=spec.pinned)
        self.trk = TrackingEngine(
            spec.trk, prns=[0] * n, code_provider=spec.code_provider,
            data_code_provider=spec.data_code_provider)
        self.tlm = spec.telemetry_decoder([0] * n)
        self.nominal = spec.trk.nominal_epoch_samples
        self.margin = self.trk._read_margin()
        self.epoch_base = [0] * n
        self.acq_engines = {}
        self.done = 0
        self.total = 0
        self.decim = 1                # set by the receiver (tick stride)
        self.sbas_consumed = 0        # messages already fed to corrections
        self.pending_resets = []      # (channel, prn) TLM/obs resets to
        #                               apply after the in-flight chunk
        #                               drains (pipelined arm ordering)
        # per-channel epochs since start_tracking (block-kernel gate:
        # pull-in must finish on the per-epoch kernel)
        self.epochs_run = np.zeros(n, np.int64)

    def eph_key(self, prn: int):
        return prn if self.spec.system == "GPS" else (self.spec.system, prn)


def _expand_sc(sc_dec: np.ndarray, rows: np.ndarray, n_epochs: int,
               nominal: int) -> np.ndarray:
    """Reconstruct the per-epoch sample counter [T, C] from the decimated
    one [Td, C]: linear interpolation over epoch index (the counter drifts
    from linear only by the Doppler rate — ~1e-7 samples over a tick)."""
    t = np.arange(n_epochs, dtype=np.float64)
    out = np.empty((n_epochs, sc_dec.shape[1]), np.float64)
    for c in range(sc_dec.shape[1]):
        out[:, c] = np.interp(t, rows.astype(np.float64),
                              sc_dec[:, c].astype(np.float64))
    # extrapolate the ends with the nominal epoch length
    first, last = rows[0], rows[-1]
    if first > 0:
        out[:first] = out[first] - (first - t[:first, None]) * nominal
    if last < n_epochs - 1:
        out[last + 1:] = out[last] + (t[last + 1:, None] - last) * nominal
    return out


def _channel_maps(chains, n_total):
    prn_map = [0] * n_total
    sys_map = ["GPS"] * n_total
    for rt in chains:
        for c in range(rt.spec.n_channels):
            prn_map[rt.offset + c] = rt.mgr.channels[c].prn
            sys_map[rt.offset + c] = rt.spec.system
    return prn_map, sys_map


class ReceiverSession:
    """Live receiver instance: the ControlThread + flowgraph event-loop
    role (control_thread.cc:373 run / gnss_flowgraph.cc wiring), made
    incremental.  Two input modes:

    - `attach_array(x)` + `run_to_end()`: the whole capture is known (the
      one-shot batch path process_array wraps);
    - `feed(samples)` repeatedly (+ `run_to_end()` at EOF): a streaming
      chunk-feed — samples accumulate in a host ring buffer, the engine
      processes as many chunks as the buffered data allows on every feed,
      and consumed samples are trimmed.  This is the live front-end path
      (File_Signal_Source -> flowgraph streaming in the reference).

    `result()` snapshots a ReceiverRun at any time.

    Control-plane commands (the TcpCmdInterface function set,
    tcp_cmd_interface.cc:46-176): `standby()` parks every channel and
    discards inflow; `coldstart()` also drops assistance;
    `warmstart()` keeps ephemerides; `hotstart()` keeps ephemerides and
    the last fix; `status_text()` reports channels + last PVT.  Use
    `on_command(name)` for the wire-protocol names.

    Fail-safes: a channel TRACKING longer than `conf.tlm_timeout_s`
    without ever producing a valid TOW is dropped back to acquisition —
    the telemetry-timeout + bit-sync-time-limit roles
    (gps_l1_ca_telemetry_decoder_gs.cc:448-460,
    dll_pll_veml_tracking.cc:1808-1815; no TOW subsumes no bit sync).
    """

    def __init__(self, conf: ReceiverConf, collect_track_outputs=False,
                 ephemerides=None, base_observations=None):
        mode = conf.pvt.positioning_mode
        if mode == "DGPS":
            # a mode the framework does not implement must fail loudly at
            # run time, not silently fall through to single-point LS
            # (round-2 verdict: validate-then-ignore).  Parsing a conf
            # naming it stays legal.
            raise NotImplementedError(
                f"PVT.positioning_mode {mode} is not implemented")
        self.conf = conf
        self.collect = bool(collect_track_outputs)
        # full-outputs mode pushes every epoch into the observables
        # history, so cap chunk growth lower there; decimated mode pushes
        # one row per tick
        self.max_mult = 8 if self.collect else 128
        chains = []
        n_total = 0
        for spec in conf.all_chains():
            chains.append(_ChainRt(spec, n_total))
            n_total += spec.n_channels
            # lean packed pulls (hot-path planes only) unless the caller
            # wants the full diagnostic set
            chains[-1].trk.full_outputs = self.collect
        self.chains = chains
        self.n_total = n_total
        # cross-band Galileo TOW sharing: E6-B C/NAV is timeless, its
        # channels stamp TOW published by the other Galileo bands
        # (galileo_tow_map.cc role)
        self.tow_map = None
        if any(rt.spec.signal == "E6" for rt in chains):
            from gnss_sim_receiver_tpu.models.telemetry import GalileoTowMap
            self.tow_map = GalileoTowMap(conf.fs)
            for rt in chains:
                if rt.spec.signal == "E6":
                    rt.tlm.tow_map = self.tow_map
        self.freq_map = np.concatenate(
            [np.full(rt.spec.n_channels, rt.spec.trk.carrier_freq_hz)
             for rt in chains])
        # the observables history must hold everything ONE chunk can push
        # before ticks are pulled — at the largest adaptive chunk
        def _fs_of(spec):
            return float(conf.rf_fs.get(spec.rf_channel_id, conf.fs))
        for rt in chains:
            epoch_ms = rt.nominal / _fs_of(rt.spec) * 1000.0
            decim = (1 if self.collect else
                     max(1, int(min(conf.obs.interval_ms, 90.0)
                                // epoch_ms)))
            rows = int(conf.chunk_epochs * self.max_mult // decim) + 256
            if conf.obs.history_len < rows:
                conf.obs.history_len = rows
        fs_map = np.concatenate(
            [np.full(rt.spec.n_channels, _fs_of(rt.spec))
             for rt in chains])
        self.obs_eng = ObservablesEngine(conf.obs, n_channels=n_total,
                                         carrier_freq_hz=self.freq_map,
                                         fs_per_channel=fs_map)
        self.ephemerides = dict(ephemerides or {})
        self.solutions = []
        self.obs_epochs = []
        # live UDP monitor taps (monitor.sinks.Monitors); attached via
        # attach_monitors, streamed during _iterate/_solve like the
        # reference's flowgraph-wired gnss_synchro/nav/PVT monitors
        self.monitors = None
        self.pvt_kf = None
        if conf.enable_pvt_kf:
            from gnss_sim_receiver_tpu.models.pvt_kf import PvtKf
            self.pvt_kf = PvtKf()
        self.collected = [] if self.collect else None

        self.aowr = None
        if conf.hybrid_mode and conf.ps_channel >= 0:
            from gnss_sim_receiver_tpu.models.hybrid import (AowrConf,
                                                             AowrTimeTransfer)
            # carrier-phase aiding scales by the ps channel's actual signal
            # frequency (the reference's SIGNAL_FREQ_MAP lookup,
            # rtklib_pvt_gs.cc) — not the L1 default, in case the ps
            # channel lives on a non-L1 chain
            ps_freq = constants.GPS_L1_FREQ_HZ
            for rt in chains:
                if rt.offset <= conf.ps_channel < (rt.offset
                                                   + rt.spec.n_channels):
                    ps_freq = rt.spec.trk.carrier_freq_hz
                    break
            self.aowr = AowrTimeTransfer(
                AowrConf(r_ps_true_m=conf.ps_range_m,
                         carrier_freq_hz=ps_freq))
        self.clock_differences = []
        self.rx_clock_bias_log = []
        self.n_fixes = 0
        self.last_fix = None
        self.last_fix_time = None

        # RTK relative positioning (PVT.positioning_mode = RTK_*)
        self.base_observations = base_observations
        self.rtk_eng = None
        self.rtk_solutions = []
        if conf.pvt.positioning_mode.startswith("RTK"):
            if base_observations is None:
                raise ValueError(
                    "PVT.positioning_mode is RTK_* but no "
                    "base_observations stream was provided")
            from gnss_sim_receiver_tpu.models.rtk import RtkConf, RtkEngine
            base_ecef = (np.asarray(conf.rtk_base_ecef_m, np.float64)
                         if conf.rtk_base_ecef_m is not None
                         else np.asarray(base_observations.base_ecef_m,
                                         np.float64))
            rtk_conf = conf.rtk if conf.rtk is not None else RtkConf(
                mode=("kinematic"
                      if conf.pvt.positioning_mode == "RTK_Kinematic"
                      else "static"))
            self.rtk_eng = RtkEngine(rtk_conf, base_ecef_m=base_ecef)

        # PPP float filter (PVT.positioning_mode = PPP_*): undifferenced
        # code+carrier EKF (models.ppp, rtklib_ppp.cc pppos role), seeded
        # from the first LS fix
        self.ppp_eng = None
        self.ppp_solutions = []
        if mode.startswith("PPP"):
            from gnss_sim_receiver_tpu.models.ppp import PppConf, PppEngine
            self.ppp_eng = PppEngine(PppConf(
                mode=("kinematic" if mode == "PPP_Kinematic"
                      else "static")))

        # fork orbital-dynamics EKF (PVT.enable_pvt_ekf,
        # rtklib_pvt.cc:491-515 hook -> models.pvt_ekf_orbital)
        self.pvt_ekf = None
        if getattr(conf, "enable_pvt_ekf", False):
            from gnss_sim_receiver_tpu.models.pvt_ekf_orbital import (
                PvtEkfConf, PvtEkfOrbital)
            ekf_conf = conf.pvt_ekf if conf.pvt_ekf is not None \
                else PvtEkfConf()
            self.pvt_ekf = PvtEkfOrbital(ekf_conf)
        self.ekf_solutions = []

        # input state: absolute sample indexing is shared by both modes.
        # Multi-band: one stream per RF channel (attach_arrays), each at
        # conf.rf_fs[rf] (default conf.fs); chains read the stream named
        # by spec.rf_channel_id.  Cursor/tick bookkeeping runs in the
        # PRIMARY (conf.fs) sample domain and converts per chain.
        self._array_mode = False
        self._x_rf = {}               # array mode: rf id -> capture
        self._len_rf = {}             # rf id -> length (samples @ rf fs)
        self._buf = np.zeros(0, np.complex64)   # streaming ring buffer
        self._base = 0                # absolute index of _buf[0]
        self._end_abs = 0             # absolute capture length so far
        #                               (PRIMARY-fs samples)
        self.cursor = 0               # acquisition head (abs PRIMARY
        #                               sample)
        self.chunk_mult = 1
        self._standby = False
        # pipelined batch mode: each iterate DISPATCHES its chunks, then
        # pulls + host-processes the PREVIOUS iterate's — the transfer
        # latency and host work of chunk k hide behind chunk k+1's
        # device execution (the tracking engines chain state on-device,
        # see TrackingEngine._chain_dispatch).  Event handling
        # (lock loss, re-acquisition, ramp) lags one chunk, which only
        # delays reactions by one chunk boundary.  Streaming sessions
        # stay synchronous (reaction latency matters there).
        self._pipeline = False
        self._inflight = []
        # per-channel telemetry fail-safe state (global channel index)
        self._trk_start_abs = np.full(n_total, -1, np.int64)
        self._tow_seen = np.zeros(n_total, bool)
        # cross-band Doppler assistance: (system, prn) -> (doppler_hz,
        # carrier_freq_hz) from any chain currently tracking that
        # satellite (the flowgraph's project_doppler share,
        # gnss_flowgraph.cc:1774-1795); secondary-band acquisitions of a
        # primary-locked PRN search only a narrow scaled grid
        self.doppler_map: dict = {}
        self.assist_log: list = []    # (signal, prn, center_hz, detected)
        # SBAS corrections state, fed from S1-chain messages and applied
        # in PVT (rtklib_sbas.cc sbssatcorr/sbsioncorr roles); MT9 GEO
        # navigation becomes an ("SBAS", prn) ephemeris so the GEO itself
        # ranges like any satellite
        self.sbas_corr = None
        if any(rt.spec.signal == "S1" for rt in chains):
            from gnss_sim_receiver_tpu.nav.sbas import SbasCorrections
            self.sbas_corr = SbasCorrections()

        # chunk wall-duration from the (legacy) 1 ms-epoch count
        self.chunk_s = conf.chunk_epochs * 1e-3
        for rt in chains:
            # device->host decimation stride for the observable planes:
            # one kept epoch per observable tick (capped at 90 ms spacing
            # so the observables history interpolation stays bracketed)
            epoch_ms = rt.nominal / _fs_of(rt.spec) * 1000.0
            rt.decim = (1 if self.collect else
                        max(1, int(min(conf.obs.interval_ms, 90.0)
                                   // epoch_ms)))

    def _monitor_eph(self, rt, eph) -> None:
        m = self.monitors
        if m is not None and m.ephemeris is not None \
                and rt.spec.system == "GPS":
            m.ephemeris.send_ephemeris(eph)

    def _store_eph(self, rt, eph) -> None:
        """Adopt a freshly decoded ephemeris: resolve the GPS 10-bit
        week (adjgpsweek + GNSS-SDR.pre_2009_file role), store, stream
        to the ephemeris monitor."""
        if rt.spec.system == "GPS" and 0 <= eph.week <= 1023:
            from gnss_sim_receiver_tpu.nav.ephemeris import adj_gps_week
            eph = dataclasses.replace(eph, week=adj_gps_week(
                eph.week, self.conf.pre_2009_file))
        self.ephemerides[rt.eph_key(eph.prn)] = eph
        self._monitor_eph(rt, eph)

    def attach_monitors(self, monitors) -> None:
        """Stream live monitor taps during the run (reference
        gnss_flowgraph.cc:194-273 + :1278 wiring): a
        monitor.sinks.Monitors whose enabled sinks receive tracking
        epochs (synchro), PVT solutions, decoded subframes (nav), and
        new GPS ephemerides."""
        self.monitors = monitors
        if monitors is not None and monitors.nav is not None:
            sink = monitors.nav
            from gnss_sim_receiver_tpu.models.outputs import _SYS_RINEX
            for rt in self.chains:
                if not hasattr(rt.tlm, "ch"):
                    continue        # only LNAV-style decoders emit raw bits
                letter = _SYS_RINEX.get(rt.spec.system, "G")

                def _cb(c, prn, tow_ms, bits, _l=letter,
                        _s=rt.spec.signal):
                    sink.send_subframe(prn, tow_ms, bits, system=_l,
                                       signal=_s)
                rt.tlm.nav_monitor = _cb

    # -- input ----------------------------------------------------------------

    def attach_time_tags(self, samplecounts, weeks, tow_ms,
                         clock_offset_ms: float = 0.0) -> None:
        """File_Timestamp_Signal_Source side-channel: GnssTime tags in
        the PRIMARY RF channel's sample domain anchor the receiver clock
        to the capture's absolute time (utils.sample_io timetag files;
        gnss_sdr_timestamp.cc role)."""
        tow = np.asarray(tow_ms, np.float64) + float(clock_offset_ms)
        self.obs_eng.set_time_tags(np.asarray(samplecounts, np.float64),
                                   tow,
                                   week=int(np.asarray(weeks)[0]))

    def attach_array(self, x) -> None:
        """One-shot mode: the whole capture (host np.ndarray or a
        device-resident jax.Array, e.g. the device signal generator's
        output) on RF channel 0."""
        self.attach_arrays({0: x})

    def attach_arrays(self, streams: dict) -> None:
        """Multi-band one-shot mode: rf_channel_id -> capture, each at
        conf.rf_fs[rf] (the reference's Multichannel_File_Signal_Source /
        per-RF-channel conditioner, gnss_flowgraph.cc:1008-1136).  All
        streams must start at the same instant (coherent front end)."""
        import jax.numpy as jnp
        for rf, x in streams.items():
            if isinstance(x, np.ndarray):
                x = jnp.asarray(np.ascontiguousarray(x, dtype=np.complex64))
            self._x_rf[int(rf)] = x
            self._len_rf[int(rf)] = len(x)
        missing = {rt.spec.rf_channel_id for rt in self.chains} \
            - set(self._x_rf)
        if missing:
            raise ValueError(f"no stream for RF channel(s) {missing}")
        self._array_mode = True
        self._pipeline = True
        # primary-domain end: the shortest stream in TIME
        self._end_abs = int(min(
            self._len_rf[rf] / self._rf_fs(rf) for rf in self._x_rf)
            * self.conf.fs)
        self._recompute_totals()

    def _rf_fs(self, rf: int) -> float:
        return float(self.conf.rf_fs.get(rf, self.conf.fs))

    def _chain_fs(self, rt) -> float:
        return self._rf_fs(rt.spec.rf_channel_id)

    def _to_chain(self, rt, primary_sample: int) -> int:
        """PRIMARY-fs absolute sample -> this chain's sample domain."""
        f = self._chain_fs(rt)
        if f == self.conf.fs:
            return int(primary_sample)
        return int(primary_sample * (f / self.conf.fs))

    def _to_primary(self, rt, chain_sample: float) -> int:
        f = self._chain_fs(rt)
        if f == self.conf.fs:
            return int(chain_sample)
        return int(chain_sample * (self.conf.fs / f))

    def feed(self, samples: np.ndarray) -> None:
        """Streaming mode: append conditioned samples, process whatever
        full chunks the buffered data now allows."""
        if self._array_mode:
            raise RuntimeError("session is in array mode")
        samples = np.asarray(samples, np.complex64)
        if self._standby:
            # standby consumes and drops inflow (the reference's flowgraph
            # standby keeps the source draining, gnss_flowgraph.cc:1991)
            self._base += len(self._buf) + len(samples)
            self._buf = np.zeros(0, np.complex64)
            self._end_abs = self._base
            self.cursor = max(self.cursor, self._base)
            return
        self._buf = np.concatenate([self._buf, samples])
        self._end_abs = self._base + len(self._buf)
        self._recompute_totals()
        self._pump(final=False)
        self._trim()

    def run_to_end(self) -> None:
        """Process everything remaining (EOF in streaming mode)."""
        self._recompute_totals()
        self._pump(final=True)

    # -- control plane (TcpCmdInterface command set) ---------------------------

    def _reset_channels(self) -> None:
        for rt in self.chains:
            for c in range(rt.spec.n_channels):
                st = rt.mgr.channels[c]
                if st.state == ChannelState.TRACKING:
                    rt.trk.stop_channel(c)
                st.state = ChannelState.IDLE
                st.prn = 0
                rt.tlm.reset_channel(c, None, epoch_base=rt.epoch_base[c])
                self.obs_eng.reset_channel(rt.offset + c)
            # rebuild the PRN rotation pool
            rt.mgr.__init__(rt.spec.prns, rt.spec.n_channels,
                            max_acq_channels=rt.spec.max_acq_channels,
                            pinned=rt.spec.pinned)
        self._trk_start_abs[:] = -1
        self._tow_seen[:] = False
        self.chunk_mult = 1
        self._inflight = []   # device results of parked channels are moot

    def standby(self) -> None:
        """Park every channel; inflow is discarded until a *start."""
        self._reset_channels()
        self._standby = True

    def coldstart(self) -> None:
        """Drop assistance + fixes, restart acquisition from scratch."""
        self.ephemerides.clear()
        self.last_fix = None
        self.last_fix_time = None
        self.n_fixes = 0
        self._reset_channels()
        self._standby = False

    def warmstart(self) -> None:
        """Restart channels, keep ephemerides (assisted start)."""
        self._reset_channels()
        self._standby = False

    def hotstart(self) -> None:
        """Restart channels, keep ephemerides AND the last fix (PVT warm
        seed); predicted-visible satellites search first."""
        self._reset_channels()
        self.prioritize_visible()
        self._standby = False

    def status_text(self) -> str:
        prn_map, sys_map = _channel_maps(self.chains, self.n_total)
        states = []
        for rt in self.chains:
            states.extend(rt.mgr.channels[c].state.name
                          for c in range(rt.spec.n_channels))
        # single line (the TCP command protocol is line-based)
        parts = ["standby" if self._standby else "running"]
        parts += [f"ch{i}={s}:{p}:{st}" for i, (p, s, st)
                  in enumerate(zip(prn_map, sys_map, states))]
        if self.last_fix is not None:
            ecef = self.last_fix.rx_ecef_m
            parts.append("fix=%.3f,%.3f,%.3f nsats=%d"
                         % (ecef[0], ecef[1], ecef[2], self.last_fix.n_sats))
        else:
            parts.append("fix=none")
        return " ".join(parts)

    def broadcast_almanac(self) -> dict:
        alm = {}
        for rt in self.chains:
            alm.update(getattr(rt.tlm, "almanac", {}) or {})
        return alm

    def broadcast_iono_utc(self):
        for rt in self.chains:
            iono = getattr(rt.tlm, "iono_utc", None)
            if iono:
                return iono
        return None

    def prioritize_visible(self, rx_ecef=None, t_gps_s=None) -> list:
        """Reorder every chain's acquisition pool so satellites
        predicted visible (from almanac or held ephemerides at the last
        fix) search first — control_thread.cc:1011 get_visible_sats +
        gnss_flowgraph.cc:2012 priorize_satellites.  Returns the visible
        PRN list."""
        import collections

        from gnss_sim_receiver_tpu.nav.ephemeris import almanac_to_ephemeris
        from gnss_sim_receiver_tpu.utils import geodesy as geo
        if rx_ecef is None and self.last_fix is not None:
            rx_ecef = self.last_fix.rx_ecef_m
        if rx_ecef is None:
            return []
        if t_gps_s is None:
            t_gps_s = (self.last_fix_time
                       if self.last_fix_time is not None else 0.0)
        alm = self.broadcast_almanac()
        visible = []
        elevs = {}
        for rt in self.chains:
            if rt.spec.system != "GPS":
                continue
            for prn in rt.spec.prns:
                eph = self.ephemerides.get(prn)
                if eph is None and prn in alm:
                    eph = almanac_to_ephemeris(prn, alm[prn])
                if eph is None:
                    continue
                try:
                    pos, _ = eph.sat_pos_clock(t_gps_s)
                except Exception:
                    continue
                el, _ = geo.elevation_azimuth(np.asarray(rx_ecef), pos)
                elevs[prn] = float(np.degrees(el))
                if elevs[prn] >= 5.0:
                    visible.append(prn)
        for rt in self.chains:
            if rt.spec.system != "GPS":
                continue
            pool = list(rt.mgr.pool)
            pool.sort(key=lambda p: -elevs.get(p, -90.0))
            rt.mgr.pool = collections.deque(pool)
        return sorted(visible, key=lambda p: -elevs[p])

    def on_command(self, name: str) -> str:
        """Wire-protocol dispatch (tcp_cmd_interface.cc handler names)."""
        name = name.strip().lower()
        if name == "status":
            return self.status_text()
        if name == "standby":
            self.standby()
            return "OK standby"
        if name in ("reset", "coldstart"):
            self.coldstart()
            return f"OK {name}"
        if name == "warmstart":
            self.warmstart()
            return "OK warmstart"
        if name == "hotstart":
            self.hotstart()
            return "OK hotstart"
        return f"ERROR unknown command {name}"

    # -- core loop -------------------------------------------------------------

    def _recompute_totals(self) -> None:
        for rt in self.chains:
            if self._array_mode:
                end_rt = self._len_rf[rt.spec.rf_channel_id]
            else:
                end_rt = self._to_chain(rt, self._end_abs)
            rt.total = max((end_rt - rt.margin) // rt.nominal - 2, 0)

    def _chunk_n(self, rt) -> int:
        return int(round(self.chunk_s * self.chunk_mult
                         / (rt.nominal / self._chain_fs(rt))))

    def _ready(self, final: bool) -> bool:
        live = [rt for rt in self.chains if rt.done < rt.total]
        if not live:
            return False
        if final:
            return True
        # without EOF, only run when every live chain can take a FULL
        # chunk (tails wait for more data)
        return all(rt.total - rt.done >= self._chunk_n(rt) for rt in live)

    def _pump(self, final: bool) -> None:
        if self._standby:
            return
        while self._ready(final) or self._inflight:
            if not self._iterate(final):
                if self._inflight:
                    continue   # drain in-flight chunks before stopping
                break   # data-starved (a late-started channel needs more
                #         samples than the buffered totals suggest)

    def _acq_input(self, rt):
        """(array-like, base) for PcpsAcquisitionEngine.acquire_from,
        in the chain's own sample domain."""
        if self._array_mode:
            return self._x_rf[rt.spec.rf_channel_id], 0
        return self._buf, self._base

    def _window(self, rt):
        """(samples, x_abs_start) covering every active channel position
        for TrackingEngine.process_begin (chain sample domain)."""
        if self._array_mode:
            return self._x_rf[rt.spec.rf_channel_id], 0
        return self._buf, self._base

    def _trim(self) -> None:
        """Drop streamed samples no chain can still need."""
        if self._array_mode or not len(self._buf):
            return
        keep_from = self.cursor
        margin = max(rt.margin for rt in self.chains)
        for rt in self.chains:
            act = rt.trk.active_host
            if act.any():
                keep_from = min(keep_from, int(rt.trk.abs_start[act].min()))
        keep_from = max(self._base, keep_from - 4 * margin)
        drop = keep_from - self._base
        if drop > 0:
            self._buf = self._buf[drop:]
            self._base = keep_from

    def _iterate(self, final: bool) -> bool:
        """One FSM + chunk iteration.  Returns False when nothing could
        advance (caller should wait for more data)."""
        import os as _os
        import time as _time
        _dbg = _os.environ.get("GNSS_RX_TIMING")
        _t0 = _time.perf_counter()
        conf = self.conf
        chains = self.chains
        end_abs = self._end_abs
        tick_bounds = []      # per-chain "observables safe up to" sample
        progressed = False
        advanced = False      # any done/cursor movement at all
        quiet = True          # no FSM event this iteration
        staged = []           # (rt, tracking, n, in-flight chunk handle)
        # ---- phase 1: per-chain FSM + device dispatch ----------------------
        # every chain's chunk is dispatched (and its device->host copy
        # started) before ANY chunk is pulled, so the transfers of all
        # chains overlap — one transfer latency per chunk, not per chain
        for rt in chains:
            if rt.done >= rt.total:
                continue
            mgr, spec = rt.mgr, rt.spec
            # --- acquisition scheduling on idle channels --------------------
            mgr.schedule()
            acquiring = mgr.acquiring_channels()
            if acquiring:
                f_this = spec.trk.carrier_freq_hz
                # split into Doppler-assisted channels (satellite already
                # locked on another band: project its Doppler by the
                # carrier ratio, search a +-250 Hz grid in one dwell) and
                # cold full-grid channels
                assisted = []
                cold = []
                centers = []
                # assist gate active only when a same-system chain on a
                # different carrier exists to provide Doppler
                gate = spec.assist_wait and any(
                    r.spec.system == spec.system
                    and r.spec.trk.carrier_freq_hz != f_this
                    for r in chains)
                for c in acquiring:
                    hit = self.doppler_map.get(
                        (spec.system, mgr.channels[c].prn))
                    if hit is not None and hit[1] != f_this:
                        assisted.append(c)
                        centers.append(hit[0] * f_this / hit[1])
                    elif not gate:
                        cold.append(c)
                    # gated channels stay ACQUIRING, searched once their
                    # primary band locks
                for group, is_assist in ((cold, False), (assisted, True)):
                    if not group:
                        continue
                    prns_search = tuple(mgr.channels[c].prn for c in group)
                    acq_eng = rt.acq_engines.get(prns_search)
                    if acq_eng is None:
                        acq_eng = PcpsAcquisitionEngine(
                            spec.acq, prns=prns_search,
                            code_provider=spec.code_provider,
                            sc_rate=spec.sc_rate,
                            code_provider2=spec.data_code_provider)
                        rt.acq_engines[prns_search] = acq_eng
                    need = acq_eng.n_samples_needed
                    acq_x, acq_base = self._acq_input(rt)
                    dec = max(1, int(spec.acq_decim))
                    cur_rt = self._to_chain(rt, self.cursor)
                    end_rt = (self._len_rf[spec.rf_channel_id]
                              if self._array_mode
                              else self._to_chain(rt, end_abs))
                    if cur_rt + need * dec > end_rt:
                        continue
                    if dec > 1:
                        # acquisition-only resampler: mean-pool decimation
                        # of just the needed slice; tracking stays at the
                        # chain's full fs and delays rescale by `dec`
                        # (gnss_flowgraph.cc:1028-1121,
                        # pcps_acquisition.cc:683-696)
                        sl = acq_x[cur_rt - acq_base:
                                   cur_rt - acq_base + need * dec]
                        import jax.numpy as _jnp
                        xd = _jnp.mean(_jnp.asarray(sl).reshape(-1, dec),
                                       axis=1)
                        res = acq_eng.acquire(xd, samplestamp=0)
                    elif is_assist:
                        start = cur_rt - acq_base
                        res = acq_eng.acquire_assisted(
                            acq_x, start, np.asarray(centers))
                        for k, c in enumerate(group):
                            self.assist_log.append(
                                (spec.signal, mgr.channels[c].prn,
                                 centers[k], bool(res.detected[k])))
                    else:
                        # fused search: one dispatch, one packed pull
                        res = acq_eng.acquire_from(acq_x,
                                                   cur_rt - acq_base)
                    for k, c in enumerate(group):
                        mgr.on_acq_result(c, bool(res.detected[k]),
                                          float(res.doppler_hz[k]))
                        if mgr.channels[c].state == ChannelState.TRACKING:
                            # a NEW lock is an FSM event (failed
                            # re-searches of absent satellites are routine
                            # and must not block chunk growth)
                            quiet = False
                            prn = mgr.channels[c].prn
                            rt.trk.set_channel_prn(c, prn)
                            if dec > 1:
                                # decimated-grid delay -> full-rate chain
                                # samples (+ mean-pool group delay)
                                start_abs = int(round(
                                    cur_rt
                                    + res.delay_samples[k] * dec
                                    + 0.5 * (dec - 1)))
                            else:
                                start_abs = int(acq_base + res.samplestamp
                                                + res.delay_samples[k])
                            # arm at the CHAIN FRONT, not at the (possibly
                            # lagging) acquisition cursor: the acquisition
                            # fixes the code phase at its own samplestamp;
                            # advancing by an integer number of
                            # Doppler-corrected code periods places the
                            # same phase at the position the next chunk
                            # starts from.  Without this, a channel armed
                            # behind the front (pipelined batch mode lags
                            # the cursor by a whole chunk) trails every
                            # other channel FOREVER — its sample_counter
                            # caps the observables tick bound a chunk
                            # short and its unprocessed tail truncates
                            # telemetry (the r4 batch-vs-streaming fix
                            # divergence and the PRN 9/10 late-ephemeris
                            # e2e failure).  Extrapolation error is the
                            # code-Doppler uncertainty (~0.02 chips/s at
                            # a 31 Hz grid error) — absorbed by the DLL.
                            act_now = rt.trk.active_host
                            if act_now.any():
                                front = int(rt.trk.abs_start[act_now].max())
                                if front > start_abs:
                                    cf0 = (spec.trk.code_rate_cps
                                           * (1.0 + (float(res.doppler_hz[k])
                                                     - spec.trk.doppler_bias_hz)
                                              / spec.trk.carrier_freq_hz))
                                    s_per = (self._chain_fs(rt)
                                             * spec.trk.code_length_chips
                                             / cf0)
                                    kper = int(np.ceil(
                                        (front - start_abs) / s_per))
                                    start_abs = int(round(start_abs
                                                          + kper * s_per))
                            rt.trk.start_tracking(
                                c, float(res.doppler_hz[k]), start_abs)
                            # pipelined mode: a chunk dispatched BEFORE
                            # this arm is still in flight and its rows
                            # (masked for this channel) will be fed to
                            # the telemetry decoder first — the TLM/obs
                            # reset must happen AFTER those rows so the
                            # epoch_base snapshot aligns bit edges with
                            # the channel's real first rows
                            if any(frt is rt for frt, *_ in self._inflight):
                                rt.pending_resets.append((c, prn))
                            else:
                                rt.tlm.reset_channel(
                                    c, prn, epoch_base=rt.epoch_base[c])
                                self.obs_eng.reset_channel(rt.offset + c)
                            rt.epochs_run[c] = 0
                            g = rt.offset + c
                            self._trk_start_abs[g] = start_abs
                            self._tow_seen[g] = False

            # --- tracking chunk --------------------------------------------
            tracking = mgr.tracking_channels()
            chunk_n = self._chunk_n(rt)
            if not tracking:
                rt.done += min(chunk_n, rt.total - rt.done)
                advanced = True
                continue
            # late-acquired channels shift the chain's window: only as
            # many epochs as fit before the stream end
            end_rt = (self._len_rf[spec.rf_channel_id]
                      if self._array_mode
                      else self._to_chain(rt, end_abs))
            n = min(chunk_n, rt.total - rt.done,
                    rt.trk.epochs_that_fit(end_rt))
            if 0 < n < chunk_n:
                if not final:
                    continue   # wait for more data before eating the tail
                # eat the whole remaining tail in ONE block-aligned chunk
                # (+ one exact-size sub-block remainder next iterate).
                # The r4 power-of-two cascade kept the jitted shape set
                # bounded but cost a ~30 ms pull latency per step — 13
                # dribble iterations on a 120 s capture (~0.4 s, 15% of
                # the whole run).  The block kernel's n_blocks static
                # arg costs one compile per distinct tail length, paid
                # once per process (the warm/steady runs reuse it); the
                # final remainder is < 2*block_epochs, so its per-epoch
                # shape set is bounded by the block length anyway.
                q = rt.trk.block_epochs
                if n >= 2 * q:
                    n = (n // q) * q
            if n <= 0:
                if final:
                    rt.done = rt.total   # stream exhausted for this chain
                    advanced = True
                continue
            rt.done += n
            progressed = True
            advanced = True
            win, win_base = self._window(rt)
            # Chains whose block kernel carries an FLL (enable_fll_pullin)
            # run the block kernel from the very first chunk: its FLL
            # pull-in + wide-DLL staging absorb the acquisition handoff
            # errors directly (see
            # test_block_mode_pullin_from_acquisition_errors).  This now
            # covers secondary-code/every-epoch-symbol chains too — they
            # pull in with the flip-proof decision-directed cross-dot
            # (TrackingConf.fll_decision_directed; the E1 pilot's
            # sec-gated variant lives in the kernel) — so NO chain needs
            # the slow per-epoch pull-in phase unless FLL is disabled by
            # conf (then the per-epoch wide short-epoch PLL closes first).
            if rt.spec.trk.enable_fll_pullin:
                need = 0
            else:
                need = rt.spec.trk.fll_pullin_epochs + 1000
            use_blocks = all(rt.epochs_run[c] >= need for c in tracking)
            staged.append((rt, tracking, n,
                           rt.trk.process_begin(win, win_base, n,
                                                decim=rt.decim,
                                                use_blocks=use_blocks)))

        # ---- phase 2: pull + host-process every chain's chunk --------------
        # (pipelined mode: this iterate's dispatches go in flight and the
        # PREVIOUS iterate's chunks are consumed instead)
        _t1 = _time.perf_counter()
        if self._pipeline or self._inflight:
            staged, self._inflight = self._inflight, staged
        for rt, tracking, n, handle in staged:
            spec = rt.spec
            outs = rt.trk.process_end(handle)
            # pipelined arm race: a channel (re)armed after this chunk
            # was dispatched — its rows predate the arm; hide them from
            # telemetry/observables/cursor logic (the device state was
            # re-armed on top of the chained state, so the NEXT chunk is
            # correct)
            stale = outs.pop("stale_channels", None)
            if stale is not None and stale.any():
                outs = dict(outs)
                outs["valid"] = outs["valid"] & ~stale[None, :]
                if "valid_full" in outs:
                    outs["valid_full"] = (outs["valid_full"]
                                          & ~stale[None, :])
            if _dbg:
                print(f"[tim] n={n} dispatch={_t1 - _t0:.3f}s "
                      f"pull={_time.perf_counter() - _t1:.3f}s",
                      flush=True)
            for c in range(spec.n_channels):
                rt.epoch_base[c] += n
            if tracking:
                inc = [c for c in tracking
                       if stale is None or not stale[c]]
                rt.epochs_run[inc] += n
            if self.collected is not None:
                self.collected.append((spec.signal, outs))
            # a channel feeds OBSERVABLES only once its tracking loops
            # have settled after (re)acquisition — freshly handed-off
            # channels carry meter-level code transients that would
            # poison PVT/RTK (the reference gates on lock quality the
            # same way); telemetry still sees every epoch
            settle = rt.spec.trk.fll_pullin_epochs + 2500
            # per-channel epoch count BEFORE this chunk: gating below is
            # row-exact (epoch-index granular), so the release instant is
            # the same whatever the chunk sizes — batch (growing chunks)
            # and streaming (feed-sized chunks) stay tick-identical
            eb_settle = rt.epochs_run - n
            rows = outs.get("rows")
            if rows is not None and len(rows) == 0:
                # tail chunk shorter than one tick stride: feed the
                # telemetry symbols, nothing for observables this chunk
                tlm_res = rt.tlm.process({"prompt": outs["prompt"],
                                          "valid": outs["valid_full"]})
                for c, eph in tlm_res.new_ephemerides:
                    self._store_eph(rt, eph)
                quiet = self._handle_lock_loss(rt, tracking) and quiet
                continue
            if rows is not None:
                # decimated transfer: telemetry sees the full-rate symbol
                # planes, observables the tick-rate planes
                tlm_in = {"prompt": outs["prompt"],
                          "valid": outs["valid_full"]}
                if getattr(rt.tlm, "tow_map", None) is not None:
                    # E6 stamps TOW per symbol epoch: reconstruct the
                    # per-epoch sample counter from the decimated one
                    # (linear in epoch to ~1e-7 samples)
                    tlm_in["sample_counter"] = _expand_sc(
                        outs["sample_counter"], rows, n, rt.nominal)
                tlm_res = rt.tlm.process(tlm_in)
                tlm_obs = dataclasses.replace(
                    tlm_res,
                    tow_at_epoch_ms=tlm_res.tow_at_epoch_ms[rows],
                    tow_valid=tlm_res.tow_valid[rows])
            else:
                tlm_res = rt.tlm.process(outs)
                tlm_obs = tlm_res
            row_e = (rows if rows is not None
                     else np.arange(outs["valid"].shape[0]))
            gate = (row_e[:, None] + eb_settle[None, :]) < settle
            if (gate & outs["valid"]).any():
                # gate a COPY for the observables push only — the cursor /
                # tick-bound / Doppler-map logic below must keep seeing
                # the device's real validity or acquisition stalls on a
                # frozen cursor
                ov = outs["valid"] & ~gate
                outs = dict(outs, valid=ov, valid_ungated=outs["valid"])
            for c, eph in tlm_res.new_ephemerides:
                self._store_eph(rt, eph)
            if (self.tow_map is not None and rt.spec.system == "Galileo"
                    and rt.spec.signal != "E6"):
                # publish per-PRN TOW for the E6 channels (decimated rows
                # suffice: TOW is linear in epoch index)
                tv = tlm_obs.tow_valid
                for c in np.flatnonzero(tv.any(axis=0)):
                    e = int(np.flatnonzero(tv[:, c])[-1])
                    self.tow_map.update(rt.tlm.prns[c],
                                        tlm_obs.tow_at_epoch_ms[e, c],
                                        outs["sample_counter"][e, c])
            self.obs_eng.push_epochs(outs, tlm_obs,
                                     channel_offset=rt.offset)
            if self.monitors is not None and \
                    self.monitors.synchro is not None:
                from gnss_sim_receiver_tpu.models.outputs import _SYS_RINEX
                # decimated transfers: 'prompt' is full-rate, everything
                # else tick-rate — stream the tick-rate planes
                mouts = (outs if rows is None
                         else dict(outs, prompt=outs["prompt"][rows]))
                self.monitors.synchro.fs = self._chain_fs(rt)
                self.monitors.synchro.push_track_epochs(
                    mouts, tlm_obs, prns=rt.tlm.prns,
                    system=_SYS_RINEX.get(spec.system, "G"),
                    signal=spec.signal)

            # telemetry fail-safe bookkeeping
            tw = tlm_obs.tow_valid.any(axis=0)
            self._tow_seen[rt.offset:rt.offset + spec.n_channels] |= tw

            # decoded broadcast iono feeds the Klobuchar model
            # (gps_navigation_message iono -> rtklib ionocorr path)
            iono = getattr(rt.tlm, "iono_utc", None)
            if iono and conf.pvt.iono_model == "Broadcast":
                conf.pvt.iono_alpha = tuple(
                    iono.get(f"alpha{i}", 0.0) for i in range(4))
                conf.pvt.iono_beta = tuple(
                    iono.get(f"beta{i}", 0.0) for i in range(4))

            # publish per-satellite Doppler for cross-band assisted
            # acquisition (project_doppler source side)
            dop_last = outs["carrier_doppler_hz"][-1]
            valid_last = outs.get("valid_ungated", outs["valid"])[-1]
            for c in tracking:
                if valid_last[c]:
                    self.doppler_map[(spec.system, rt.mgr.channels[c].prn)] \
                        = (float(dop_last[c]), spec.trk.carrier_freq_hz)

            # SBAS: feed new messages into the correction state, publish
            # MT9 GEO navigation as a rangeable ephemeris
            if spec.signal == "S1" and self.sbas_corr is not None:
                from gnss_sim_receiver_tpu.nav.sbas import SbasGeoEphemeris
                msgs = rt.tlm.messages
                for c, prn, ev in msgs[rt.sbas_consumed:]:
                    if not ev.crc_ok:
                        continue
                    self.sbas_corr.push(ev)
                    if ev.msg_type == 9:
                        nav = rt.tlm.geo_nav(c)
                        if nav is not None:
                            self.ephemerides[("SBAS", prn)] = \
                                SbasGeoEphemeris(prn, nav)
                rt.sbas_consumed = len(msgs)

            # pipelined arm ordering: the stale chunk's rows are in —
            # NOW reset the decoders so their epoch reference matches
            # the channel's first post-arm rows (next chunk)
            if rt.pending_resets:
                for c, prn in rt.pending_resets:
                    rt.tlm.reset_channel(c, prn,
                                         epoch_base=rt.epoch_base[c])
                    self.obs_eng.reset_channel(rt.offset + c)
                rt.pending_resets = []

            # --- loss-of-lock events + TLM-timeout fail-safe ---------------
            quiet = self._handle_lock_loss(rt, tracking) and quiet
            if conf.tlm_timeout_s > 0:
                sc_last = outs["sample_counter"][-1]
                for c in tracking:
                    g = rt.offset + c
                    if (rt.mgr.channels[c].state == ChannelState.TRACKING
                            and not self._tow_seen[g]
                            and self._trk_start_abs[g] >= 0
                            and (sc_last[c] - self._trk_start_abs[g])
                            / self._chain_fs(rt) > conf.tlm_timeout_s):
                        # no TOW in time: telemetry never synced (covers
                        # the bit-sync limit too) — recycle the channel
                        quiet = False
                        rt.mgr.on_tracking_lost(c)
                        rt.trk.stop_channel(c)

            valid_cols = np.asarray(
                outs.get("valid_ungated", outs["valid"])[-1])
            if valid_cols.any():
                up_to = int(outs["sample_counter"][-1][valid_cols].min())
                tick_bounds.append(self._to_primary(rt, up_to))
                self.cursor = max(self.cursor,
                                  self._to_primary(rt, up_to - rt.margin))

        # --- observables + PVT ----------------------------------------------
        _t2 = _time.perf_counter()
        if tick_bounds:
            self._solve(min(tick_bounds))
        if _dbg:
            print(f"[tim] host={_time.perf_counter() - _t2:.3f}s "
                  f"iter_total={_time.perf_counter() - _t0:.3f}s",
                  flush=True)
        elif not progressed and final:
            self.cursor += int(self.chunk_s * conf.fs)
            advanced = True
        self.chunk_mult = (min(self.chunk_mult * 2, self.max_mult)
                           if quiet else 1)
        return advanced

    def _handle_lock_loss(self, rt, tracking) -> bool:
        quiet = True
        lost = rt.trk.lock_lost_host
        for c in tracking:
            if lost[c]:
                quiet = False
                rt.mgr.on_tracking_lost(c)
                rt.trk.stop_channel(c)
        return quiet

    def _solve(self, tick_bound: int) -> None:
        conf = self.conf
        prn_map, sys_map = _channel_maps(self.chains, self.n_total)
        freq_map = self.freq_map
        for epoch in self.obs_eng.pull_ticks(tick_bound):
            self.obs_epochs.append(epoch)
            # pseudolite channel: feed AOWR, exclude from PVT
            excl = ()
            if self.aowr is not None:
                ps = conf.ps_channel
                excl = (ps,)
                if 0 <= ps < self.n_total and epoch.valid[ps]:
                    self.aowr.update(
                        float(epoch.pseudorange_m[ps]),
                        float(epoch.carrier_phase_cycles[ps]))
            # PVT solve cadence (PVT.output_rate_ms decimation)
            if conf.pvt_rate_ms and int(round(
                    epoch.rx_time_s * 1000.0)) % conf.pvt_rate_ms:
                continue
            # rx clock propagation after enough fixes: hold the clock at
            # the last bias + drift extrapolation
            fixed_clk = None
            if (conf.enable_rx_clock_propagation
                    and self.last_fix is not None
                    and self.n_fixes >= conf.clk_prop_after_n_fixes):
                dt = epoch.rx_time_s - self.last_fix_time
                fixed_clk = (self.last_fix.rx_clock_bias_s
                             + self.last_fix.rx_clock_drift_ss * dt)
            _solver = (solve_pvt_raim if conf.pvt.raim_fde else solve_pvt)
            sol = _solver(epoch, prn_map, self.ephemerides, conf.pvt,
                            x0=None if self.last_fix is None
                            else self.last_fix.rx_ecef_m,
                            systems=sys_map,
                            carrier_freq_hz=freq_map,
                            exclude_channels=excl,
                            fixed_clock_bias_s=fixed_clk,
                            sbas_corrections=self.sbas_corr)
            if sol.valid:
                if self.pvt_kf is not None:
                    self.pvt_kf.update(sol)
                self.last_fix = sol
                self.last_fix_time = epoch.rx_time_s
                self.n_fixes += 1
                self.solutions.append(sol)
                if self.monitors is not None and \
                        self.monitors.pvt is not None:
                    self.monitors.pvt.send_solution(sol)
                if conf.share_rx_clock_bias:
                    # tag a GNSS channel's TOW/PRN, never the pseudolite's
                    # (the reference erases the ps channel from the
                    # observables map before write_rx_clock_bias,
                    # rtklib_pvt_gs.cc:2346)
                    cand = np.flatnonzero(epoch.valid)
                    cand = cand[~np.isin(cand, list(excl))]
                    ch0 = int(cand[0]) if cand.size else int(
                        np.flatnonzero(epoch.valid)[0])
                    self.rx_clock_bias_log.append(
                        (epoch.rx_time_s,
                         epoch.interp_tow_ms[ch0] / 1000.0,
                         sol.rx_clock_bias_s, prn_map[ch0]))
                if self.aowr is not None and self.aowr.observed:
                    self.clock_differences.append(self.aowr.clock_products(
                        sol.rx_clock_bias_s, epoch.rx_time_s))
                # fork orbital EKF (enable_pvt_ekf): seed from the first
                # LS fix, then measurement-update per solved epoch
                if self.pvt_ekf is not None:
                    t_gps = epoch.rx_time_s - sol.rx_clock_bias_s
                    if not self.pvt_ekf.initialized:
                        self.pvt_ekf.init_from_fix(sol, t_gps)
                    elif self.pvt_ekf.update(epoch, prn_map,
                                             self.ephemerides, t_gps,
                                             systems=sys_map,
                                             carrier_freq_hz=freq_map):
                        pos, vel, bias, drift = self.pvt_ekf.state_ecef()
                        self.ekf_solutions.append(
                            (epoch.rx_time_s, pos, vel, bias, drift))
            # PPP float filter: undifferenced update per epoch (the LS
            # fix seeds the first update; afterwards PPP runs even on
            # epochs where LS fails)
            if self.ppp_eng is not None and (sol.valid
                                             or self.ppp_eng.x is not None):
                psol = self.ppp_eng.update(
                    epoch, prn_map, self.ephemerides, systems=sys_map,
                    carrier_freq_hz=freq_map,
                    x0=sol.rx_ecef_m if sol.valid else None)
                if psol.valid:
                    self.ppp_solutions.append((epoch.rx_time_s, psol))
            # RTK: pair with the base epoch and run the DD engine
            if self.rtk_eng is not None:
                base_ep = self.base_observations.aligned_to(
                    epoch.rx_time_s, prn_map, sys_map)
                if base_ep is not None:
                    rsol = self.rtk_eng.update(
                        epoch, base_ep, prn_map, self.ephemerides,
                        systems=sys_map, carrier_freq_hz=freq_map)
                    if rsol.valid:
                        self.rtk_solutions.append((epoch.rx_time_s, rsol))

    # -- output ----------------------------------------------------------------

    def result(self) -> ReceiverRun:
        track_outputs = None
        if self.collected:
            track_outputs = {}
            for sig in {s for s, _ in self.collected}:
                parts = [o for s, o in self.collected if s == sig]
                track_outputs[sig] = {
                    k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
            if len(track_outputs) == 1:   # legacy single-chain shape
                track_outputs = next(iter(track_outputs.values()))
        prn_map, sys_map = _channel_maps(self.chains, self.n_total)
        states = []
        for rt in self.chains:
            states.extend(rt.mgr.channels[c].state
                          for c in range(rt.spec.n_channels))
        events = []
        for rt in self.chains:
            events.extend((rt.offset + c, ev) for c, ev in rt.mgr.events)
        has_messages = []
        for rt in self.chains:
            if rt.spec.signal == "E6":
                has_messages.extend(rt.tlm.has.messages)
        return ReceiverRun(
            solutions=self.solutions,
            observation_epochs=self.obs_epochs,
            channel_prns=prn_map, channel_states=states,
            channel_systems=sys_map,
            ephemerides=self.ephemerides, events=events,
            track_outputs=track_outputs,
            has_messages=has_messages,
            clock_differences=self.clock_differences,
            rx_clock_bias_log=self.rx_clock_bias_log,
            rtk_solutions=self.rtk_solutions,
            ekf_solutions=self.ekf_solutions,
            ppp_solutions=self.ppp_solutions,
            almanac=self.broadcast_almanac(),
            iono_utc=self.broadcast_iono_utc())


class Receiver:
    def __init__(self, conf: ReceiverConf):
        self.conf = conf

    def start_session(self, collect_track_outputs: bool = False,
                      ephemerides: dict | None = None,
                      base_observations=None) -> ReceiverSession:
        """Create a live streaming session (see ReceiverSession)."""
        return ReceiverSession(self.conf,
                               collect_track_outputs=collect_track_outputs,
                               ephemerides=ephemerides,
                               base_observations=base_observations)

    def process_array(self, x: np.ndarray,
                      collect_track_outputs: bool = False,
                      ephemerides: dict | None = None,
                      base_observations=None,
                      monitors=None) -> ReceiverRun:
        """Run the whole receiver over an in-memory sample array (host
        np.ndarray or device-resident jax.Array).

        `ephemerides` preloads assistance data for a warm start (the
        reference's AGNSS / XML-assisted start, control_thread.cc
        assist_GNSS + read_assistance_from_XML): PVT can fix as soon as
        TOW is decoded, without waiting for subframes 1-3.  Keys: PRN int
        for GPS, (system, prn) otherwise.

        `base_observations` (models.rtk.BaseObservations) enables RTK when
        PVT.positioning_mode is RTK_Static/RTK_Kinematic: each rover
        observable epoch is paired with the matching base epoch (by rx
        time, satellites matched by (system, prn)) and run through the DD
        carrier-phase EKF + LAMBDA engine; fixed/float solutions
        accumulate in ReceiverRun.rtk_solutions (rtklib_rtkpos.cc relpos
        role).

        Multi-constellation note: pseudoranges place every TOW on a common
        timescale — valid for the simulator (GGTO = 0) and within a single
        constellation; broadcast GGTO correction is a PVT extension hook.
        """
        s = self.start_session(collect_track_outputs=collect_track_outputs,
                               ephemerides=ephemerides,
                               base_observations=base_observations)
        if monitors is not None:
            s.attach_monitors(monitors)
        s.attach_array(x)
        s.run_to_end()
        return s.result()


def beidou_b1i_chain(fs: float, prns=tuple(range(6, 31)), n_channels=4,
                     **trk_overrides) -> SignalChainConf:
    """BeiDou B1I (MEO/IGSO, D1) chain: 2.046 Mcps, 1 ms epochs,
    NH20-spread 50-bps D1 bits (the BEIDOU_B1I_* blocks)."""
    from gnss_sim_receiver_tpu import signals
    sig = signals.BEIDOU_B1I
    trk_kw = dict(
        fs=fs, code_rate_cps=sig.chip_rate_cps,
        code_length_chips=sig.code_length_chips,
        carrier_freq_hz=sig.carrier_freq_hz,
        early_late_space_chips=0.5, pll_bw_hz=40.0,
        enable_fll_pullin=True, fll_decision_directed=True,
        fll_pullin_epochs=100)
    trk_kw.update(trk_overrides)
    return SignalChainConf(
        signal="B1", system="BeiDou", prns=tuple(prns),
        n_channels=n_channels, max_acq_channels=n_channels,
        acq=AcqConf(fs_in=fs, sampled_ms=1, doppler_max=5000.0,
                    doppler_step=250.0, max_dwells=2,
                    make_two_steps=True, doppler_step2=62.5,
                    bit_transition_flag=True),
        trk=TrackingConf(**trk_kw),
        code_provider=lambda p: signals.subchip_table(sig, p),
        sc_rate=sig.chip_rate_cps)

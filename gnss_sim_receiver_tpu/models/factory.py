"""Block factory: reference configuration strings -> engine configuration.

Equivalent of the reference GNSSBlockFactory
(src/core/receiver/gnss_block_factory.cc:639-1335): maps the
`Role.implementation` strings of a GNSS-SDR conf file onto this framework's
engines, so reference conf files drive this receiver unchanged.  Blocks
whose roles the batched design absorbs (channel adapters, msg queues,
sample counters) have no standalone object — their parameters land in the
corresponding engine conf.

All eleven implemented signal chains are reachable from conf files:
GPS L1 C/A (1C), Galileo E1B (1B), GPS L2C CM (2S), GPS L5I (L5),
Galileo E5a-I (5X), Galileo E5b-I (7X), Galileo E6-B (E6), GLONASS L1 C/A
(1G, one chain per occupied FDMA slot), BeiDou B1I (B1, D1 + D2 GEO),
BeiDou B3I (B3), SBAS L1 (S1) — matching the per-signal dispatch of
gnss_block_factory.cc:652-1335 (GetAcqBlock :1349, GetTrkBlock :1536).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.models.acquisition import AcqConf
from gnss_sim_receiver_tpu.models.observables import ObsConf
from gnss_sim_receiver_tpu.models.pvt import PvtConf
from gnss_sim_receiver_tpu.models.receiver import (Receiver, ReceiverConf,
                                                   SignalChainConf,
                                                   beidou_b1i_chain,
                                                   beidou_b3i_chain,
                                                   galileo_e1b_chain,
                                                   galileo_e5a_chain,
                                                   galileo_e5b_chain,
                                                   galileo_e6b_chain,
                                                   glonass_l1_chain,
                                                   glonass_l2_chain,
                                                   gps_l2c_chain,
                                                   gps_l5_chain,
                                                   sbas_l1_chain)
from gnss_sim_receiver_tpu.models.tracking import TrackingConf
from gnss_sim_receiver_tpu.utils.config import Configuration

# accepted Role.implementation strings per signal suffix (the reference
# factory's dispatch, gnss_block_factory.cc:652-1335).  Strings for
# hardware offload variants (FPGA/GPU/OpenCL) and the legacy/experimental
# engines that have no equivalent here raise NotImplementedError rather
# than silently aliasing.
_ACQ_IMPLS = {
    "1C": {"GPS_L1_CA_PCPS_Acquisition",
           "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler",
           "GPS_L1_CA_PCPS_Tong_Acquisition",
           "GPS_L1_CA_PCPS_QuickSync_Acquisition"},
    "1B": {"Galileo_E1_PCPS_Ambiguous_Acquisition",
           "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition",
           "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition"},
    "2S": {"GPS_L2_M_PCPS_Acquisition"},
    "L5": {"GPS_L5i_PCPS_Acquisition"},
    "5X": {"Galileo_E5a_Pcps_Acquisition",
           "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF"},
    "7X": {"Galileo_E5b_PCPS_Acquisition"},
    "1G": {"GLONASS_L1_CA_PCPS_Acquisition"},
    "2G": {"GLONASS_L2_CA_PCPS_Acquisition"},
    "B1": {"BEIDOU_B1I_PCPS_Acquisition"},
    "B3": {"BEIDOU_B3I_PCPS_Acquisition"},
    "E6": {"Galileo_E6_PCPS_Acquisition"},
    # SBAS L1 rides the GPS L1 C/A blocks in the reference (only the
    # telemetry decoder is SBAS-specific, gnss_block_factory.cc:1252)
    "S1": {"SBAS_L1_PCPS_Acquisition", "GPS_L1_CA_PCPS_Acquisition"},
}
_TRK_IMPLS = {
    "1C": {"GPS_L1_CA_DLL_PLL_Tracking", "GPS_L1_CA_KF_Tracking"},
    "1B": {"Galileo_E1_DLL_PLL_VEML_Tracking"},
    "2S": {"GPS_L2_M_DLL_PLL_Tracking"},
    "L5": {"GPS_L5_DLL_PLL_Tracking", "GPS_L5i_DLL_PLL_Tracking"},
    "5X": {"Galileo_E5a_DLL_PLL_Tracking"},
    "7X": {"Galileo_E5b_DLL_PLL_Tracking"},
    "1G": {"GLONASS_L1_CA_DLL_PLL_Tracking"},
    "2G": {"GLONASS_L2_CA_DLL_PLL_Tracking"},
    "B1": {"BEIDOU_B1I_DLL_PLL_Tracking"},
    "B3": {"BEIDOU_B3I_DLL_PLL_Tracking"},
    "E6": {"Galileo_E6_DLL_PLL_Tracking"},
    "S1": {"SBAS_L1_DLL_PLL_Tracking", "GPS_L1_CA_DLL_PLL_Tracking"},
}
_DEFAULT_ACQ = {
    "1C": "GPS_L1_CA_PCPS_Acquisition",
    "1B": "Galileo_E1_PCPS_Ambiguous_Acquisition",
    "2S": "GPS_L2_M_PCPS_Acquisition",
    "L5": "GPS_L5i_PCPS_Acquisition",
    "5X": "Galileo_E5a_Pcps_Acquisition",
    "7X": "Galileo_E5b_PCPS_Acquisition",
    "1G": "GLONASS_L1_CA_PCPS_Acquisition",
    "2G": "GLONASS_L2_CA_PCPS_Acquisition",
    "B1": "BEIDOU_B1I_PCPS_Acquisition",
    "B3": "BEIDOU_B3I_PCPS_Acquisition",
    "E6": "Galileo_E6_PCPS_Acquisition",
    "S1": "SBAS_L1_PCPS_Acquisition",
}
_DEFAULT_TRK = {
    "1C": "GPS_L1_CA_DLL_PLL_Tracking",
    "1B": "Galileo_E1_DLL_PLL_VEML_Tracking",
    "2S": "GPS_L2_M_DLL_PLL_Tracking",
    "L5": "GPS_L5_DLL_PLL_Tracking",
    "5X": "Galileo_E5a_DLL_PLL_Tracking",
    "7X": "Galileo_E5b_DLL_PLL_Tracking",
    "1G": "GLONASS_L1_CA_DLL_PLL_Tracking",
    "2G": "GLONASS_L2_CA_DLL_PLL_Tracking",
    "B1": "BEIDOU_B1I_DLL_PLL_Tracking",
    "B3": "BEIDOU_B3I_DLL_PLL_Tracking",
    "E6": "Galileo_E6_DLL_PLL_Tracking",
    "S1": "SBAS_L1_DLL_PLL_Tracking",
}
_CHAIN_BUILDERS = {
    "1B": galileo_e1b_chain,
    "2S": gps_l2c_chain,
    "L5": gps_l5_chain,
    "5X": galileo_e5a_chain,
    "7X": galileo_e5b_chain,
    "B1": beidou_b1i_chain,
    "B3": beidou_b3i_chain,
    "E6": galileo_e6b_chain,
    "S1": sbas_l1_chain,
}
# every signal group the factory recognises, reference order
ALL_SIGNALS = ("1C", "1B", "2S", "L5", "5X", "7X", "E6", "1G", "2G", "B1",
               "B3", "S1")


@dataclasses.dataclass
class SourceSpec:
    implementation: str
    filename: str
    item_type: str
    sampling_frequency: float
    samples: int
    # File_Timestamp_Signal_Source side-channel
    # (adapters/file_timestamp_signal_source.cc)
    timestamp_filename: str = ""
    timestamp_clock_offset_ms: float = 0.0


def source_from_config(config: Configuration) -> SourceSpec:
    return SourceSpec(
        implementation=config.property("SignalSource.implementation",
                                       "File_Signal_Source"),
        filename=config.property("SignalSource.filename", ""),
        item_type=config.property("SignalSource.item_type", "gr_complex"),
        sampling_frequency=float(
            config.property("SignalSource.sampling_frequency", 0)),
        samples=config.property("SignalSource.samples", 0),
        timestamp_filename=config.property(
            "SignalSource.timestamp_filename", ""),
        timestamp_clock_offset_ms=float(config.property(
            "SignalSource.timestamp_clock_offset_ms", 0.0)),
    )


def _check_impls(config: Configuration, sig: str) -> tuple[str, str]:
    acq_impl = config.property(f"Acquisition_{sig}.implementation",
                               _DEFAULT_ACQ[sig])
    if acq_impl not in _ACQ_IMPLS[sig]:
        raise NotImplementedError(f"acquisition {acq_impl}")
    trk_impl = config.property(f"Tracking_{sig}.implementation",
                               _DEFAULT_TRK[sig])
    if trk_impl not in _TRK_IMPLS[sig]:
        raise NotImplementedError(f"tracking {trk_impl}")
    return acq_impl, trk_impl


def _acq_from_config(config: Configuration, sig: str,
                     base: AcqConf, acq_impl: str) -> AcqConf:
    """Per-signal Acquisition_<sig>.* keys -> AcqConf, defaults from the
    chain builder (the reference adapters' Acq_Conf fill,
    e.g. gps_l1_ca_pcps_acquisition.cc)."""
    p = f"Acquisition_{sig}."
    pfa = config.property(p + "pfa", base.pfa)
    variant = ("fine_doppler" if acq_impl.endswith("Fine_Doppler")
               else "tong" if "Tong" in acq_impl
               else "quicksync" if "QuickSync" in acq_impl
               else "cccwsr" if "CCCWSR" in acq_impl
               else "8ms" if "_8ms_" in acq_impl
               else "iq_caf" if "Noncoherent_IQ" in acq_impl else "pcps")
    # E5a CAF Doppler smoothing window (total Hz -> boxcar half-width in
    # bins; galileo_e5a_noncoherent_iq_acquisition_caf_cc CAF_window_hz)
    caf_hz = float(config.property(p + "CAF_window_hz", 0.0))
    dstep = float(config.property(p + "doppler_step", base.doppler_step))
    caf_bins = int(caf_hz / (2.0 * dstep)) if caf_hz > 0 else 0
    return dataclasses.replace(
        base,
        doppler_max=float(config.property(p + "doppler_max",
                                          base.doppler_max)),
        doppler_step=float(config.property(p + "doppler_step",
                                           base.doppler_step)),
        sampled_ms=config.property(p + "coherent_integration_time_ms",
                                   base.sampled_ms),
        max_dwells=max(config.property(p + "max_dwells", base.max_dwells),
                       1),
        pfa=pfa,
        threshold=config.property(p + "threshold", base.threshold),
        use_cfar_algorithm=config.property(p + "use_CFAR_algorithm",
                                           base.use_cfar_algorithm),
        make_two_steps=config.property(p + "make_two_steps",
                                       base.make_two_steps),
        doppler_step2=float(config.property(p + "second_doppler_step",
                                            base.doppler_step2)),
        num_doppler_bins_step2=config.property(
            p + "second_nbins", base.num_doppler_bins_step2),
        bit_transition_flag=config.property(p + "bit_transition_flag",
                                            base.bit_transition_flag),
        variant=variant,
        caf_bins=caf_bins,
        tong_init=config.property(p + "tong_init_val", 1),
        tong_max=config.property(p + "tong_max_val", 2),
        tong_max_dwells=config.property(p + "tong_max_dwells", 10),
        quicksync_fold=config.property(p + "folding_factor", 4),
    )


def _trk_from_config(config: Configuration, sig: str, base: TrackingConf,
                     trk_impl: str) -> TrackingConf:
    """Per-signal Tracking_<sig>.* keys -> TrackingConf (the reference
    adapters' Dll_Pll_Conf fill, dll_pll_conf.h:42-80)."""
    p = f"Tracking_{sig}."
    # VEML spacing keys are in chips; sub-chip engines (E1 BOC) scale x2
    sc = 2.0 if sig == "1B" else 1.0
    ve = config.property(p + "very_early_late_space_chips",
                         base.very_early_late_space_chips / sc)
    return dataclasses.replace(
        base,
        tracking_mode=("kf" if trk_impl.endswith("KF_Tracking")
                       else base.tracking_mode),
        pll_bw_hz=config.property(p + "pll_bw_hz", base.pll_bw_hz),
        dll_bw_hz=config.property(p + "dll_bw_hz", base.dll_bw_hz),
        pll_filter_order=config.property(p + "order",
                                         base.pll_filter_order),
        enable_fll_pullin=config.property(p + "enable_fll_pullin",
                                          base.enable_fll_pullin),
        fll_bw_hz=config.property(p + "fll_bw_hz", base.fll_bw_hz),
        early_late_space_chips=sc * config.property(
            p + "early_late_space_chips", base.early_late_space_chips / sc),
        very_early_late_space_chips=sc * ve,
        cn0_min_db_hz=config.property(p + "cn0_min", base.cn0_min_db_hz),
        max_lock_fail=config.property(p + "max_lock_fail",
                                      base.max_lock_fail),
        extend_correlation_symbols=config.property(
            p + "extend_correlation_symbols",
            base.extend_correlation_symbols),
        pll_bw_narrow_hz=config.property(p + "pll_bw_narrow_hz",
                                         base.pll_bw_narrow_hz),
        dll_bw_narrow_hz=config.property(p + "dll_bw_narrow_hz",
                                         base.dll_bw_narrow_hz),
    )


def _pinned_channels(config: Configuration, offset: int, count: int) -> dict:
    """Channel<i>.satellite pinning for the chain occupying global channel
    indexes [offset, offset+count) (assign_channels,
    gnss_flowgraph.cc:1391-1415)."""
    pinned = {}
    for i in range(count):
        sat = config.property(f"Channel{offset + i}.satellite", 0)
        if sat:
            pinned[i] = sat
    return pinned


def chains_from_config(config: Configuration) -> list[SignalChainConf]:
    """All non-1C chains configured via Channels_<sig>.count.

    Multi-band keys: ``Channels_<sig>.RF_channel_ID`` selects which RF
    channel's stream the chain consumes (gnss_flowgraph.cc:1018-1019);
    ``SignalSource.sample_rate_rf<id>`` (framework key) declares that RF
    channel's fs, defaulting to internal_fs_sps.
    ``GNSS-SDR.use_acquisition_resampler=true`` decimates each chain's
    ACQUISITION path toward the per-signal optimal fs (~2 Msps for GPS
    L1 C/A, GPS_L1_CA.h:53) while tracking stays at full rate
    (gnss_flowgraph.cc:1028-1121)."""
    fs = float(config.property("GNSS-SDR.internal_fs_sps", 2_000_000))
    in_acq = config.property("Channels.in_acquisition", 0)
    use_acq_resampler = str(config.property(
        "GNSS-SDR.use_acquisition_resampler", "false")).lower() == "true"
    chains = []
    offset = config.property("Channels_1C.count", 0)
    for sig in ALL_SIGNALS[1:]:
        n = config.property(f"Channels_{sig}.count", 0)
        if n <= 0:
            continue
        rf_id = int(config.property(f"Channels_{sig}.RF_channel_ID", 0))
        rf_fs = float(config.property(f"SignalSource.sample_rate_rf{rf_id}",
                                      fs))
        acq_impl, trk_impl = _check_impls(config, sig)
        if sig in ("1G", "2G"):
            # FDMA: one chain per occupied frequency slot
            # (pcps_acquisition.cc:211-230 d_doppler_bias); PRN -> slot map
            # from the constellation table (GLONASS_L1_L2_CA.h:134)
            builder = glonass_l1_chain if sig == "1G" else glonass_l2_chain
            dfreq = (constants.GLONASS_L1_DFREQ_HZ if sig == "1G"
                     else constants.GLONASS_L2_DFREQ_HZ)
            by_slot: dict[int, list[int]] = {}
            for prn in range(1, 25):
                k = constants.GLONASS_PRN_SLOT.get(prn)
                if k is not None:
                    by_slot.setdefault(k, []).append(prn)
            remaining = n
            for k in sorted(by_slot):
                if remaining <= 0:
                    break
                prns = by_slot[k]
                nc = min(len(prns), remaining)
                chain = builder(fs, prns=prns, freq_slot=k,
                                n_channels=nc)
                chain.acq = _acq_from_config(config, sig, chain.acq,
                                             acq_impl)
                # keep the slot's carrier offset in the acquisition center
                chain.acq = dataclasses.replace(
                    chain.acq, doppler_center=k * dfreq)
                chain.trk = _trk_from_config(config, sig, chain.trk,
                                             trk_impl)
                chain.pinned = _pinned_channels(config, offset, nc)
                offset += nc
                remaining -= nc
                chains.append(chain)
            continue
        chain = _CHAIN_BUILDERS[sig](rf_fs, n_channels=n)
        chain.rf_channel_id = rf_id
        if in_acq:
            chain.max_acq_channels = min(in_acq, n)
        chain.acq = _acq_from_config(config, sig, chain.acq, acq_impl)
        chain.trk = _trk_from_config(config, sig, chain.trk, trk_impl)
        if chain.acq.variant == "cccwsr" and sig == "1B" \
                and chain.data_code_provider is None:
            # data-only E1 chain (track_pilot=false): CCCWSR still needs
            # the second (pilot E1C) replica family; the combining grid
            # is symmetric in data/pilot so the slot order is free
            from gnss_sim_receiver_tpu import signals as _sigs
            chain.data_code_provider = \
                lambda p: _sigs.boc11_expand(_sigs.galileo_e1_code(p, "C"))
        if chain.acq.variant == "iq_caf" and sig == "5X" \
                and chain.data_code_provider is None:
            # the I/Q variant correlates the E5a-I (data) AND E5a-Q
            # (pilot) primaries; the base chain only carries E5a-I
            from gnss_sim_receiver_tpu import signals as _sigs
            chain.data_code_provider = \
                lambda p: _sigs.galileo_e5a_code(p, "Q")
        if use_acq_resampler and sig == "1C":
            # decimate acquisition toward GPS_L1_CA_OPT_ACQ_FS (2 Msps)
            dec = max(1, int(rf_fs // 2_000_000))
            if dec > 1:
                chain.acq_decim = dec
                chain.acq = dataclasses.replace(chain.acq,
                                                fs_in=rf_fs / dec)
        chain.pinned = _pinned_channels(config, offset, n)
        offset += n
        chains.append(chain)
    return chains


def pvt_conf_from_config(config: Configuration) -> PvtConf:
    """PVT solver keys (the rtklib_pvt adapter's conf fill,
    rtklib_pvt.cc:78-917 — the solver-behavior subset; output printers are
    separate keys consumed by __main__._write_outputs)."""
    mode = config.property("PVT.positioning_mode", "Single")
    if mode not in ("Single", "Static", "Kinematic", "DGPS",
                    "PPP_Static", "PPP_Kinematic",
                    "RTK_Static", "RTK_Kinematic"):
        raise NotImplementedError(f"PVT.positioning_mode {mode}")
    return PvtConf(
        positioning_mode=mode,
        elevation_mask_deg=config.property("PVT.elevation_mask", 5.0),
        max_gdop=config.property("PVT.threshold_reject_GDOP", 30.0),
        iono_model=config.property("PVT.iono_model", "OFF"),
        trop_model=config.property("PVT.trop_model", "OFF"),
        raim_fde=config.property("PVT.raim_fde", False),
        raim_threshold_m=config.property("PVT.raim_threshold_m", 30.0),
        # fork receiver-antenna attitude (rtklib_pvt.cc:92-94)
        antenna_attitude_fix=config.property(
            "ReceiverAntennaAttitude.fix", True),
        antenna_az_rad=np.radians(config.property(
            "ReceiverAntennaAttitude.az_deg", 0.0)),
        antenna_el_rad=np.radians(config.property(
            "ReceiverAntennaAttitude.el_deg", 90.0)),
    )


def rtk_conf_from_config(config: Configuration):
    """RTK relative-positioning keys (rtklib_pvt.cc prcopt fill: AR mode,
    measurement sigmas) for PVT.positioning_mode = RTK_Static/RTK_Kinematic;
    the base station observables arrive out of band (two-receiver runs)."""
    from gnss_sim_receiver_tpu.models.rtk import RtkConf
    mode = config.property("PVT.positioning_mode", "Single")
    return RtkConf(
        mode="kinematic" if mode == "RTK_Kinematic" else "static",
        elevation_mask_deg=config.property("PVT.elevation_mask", 10.0),
        code_sigma_m=config.property("PVT.code_sigma_m", 0.5),
        carrier_sigma_m=config.property("PVT.carrier_sigma_m", 0.003),
        ratio_threshold=config.property("PVT.AR_ratio_threshold", 3.0),
    )


def receiver_conf_from_config(config: Configuration) -> ReceiverConf:
    """Build the full receiver configuration from reference-style keys for
    every implemented signal chain."""
    fs = float(config.property("GNSS-SDR.internal_fs_sps", 2_000_000))
    chains = chains_from_config(config)

    # GPS L1 C/A is the reference's default chain: 8 channels when nothing
    # else is configured, else exactly what Channels_1C.count says
    n_1c = config.property("Channels_1C.count", 0 if chains else 8)
    acq_impl, trk_impl = _check_impls(config, "1C")
    acq = _acq_from_config(
        config, "1C",
        AcqConf(fs_in=fs, doppler_max=5000, doppler_step=250, sampled_ms=1,
                max_dwells=2, pfa=0.01), acq_impl)
    trk = _trk_from_config(config, "1C", TrackingConf(fs=fs), trk_impl)

    obs = ObsConf(
        fs=fs,
        interval_ms=config.property("Observables.observable_interval_ms",
                                    20),
        smoothing_factor=config.property(
            "Observables.smoothing_factor", 0),
    )
    pvt = pvt_conf_from_config(config)
    rtk = None
    rtk_base = None
    if pvt.positioning_mode.startswith("RTK"):
        rtk = rtk_conf_from_config(config)
        base_str = config.property("PVT.rtk_base_position_ecef", "")
        if base_str:
            rtk_base = tuple(float(v) for v in base_str.split(","))
    in_acq = config.property("Channels.in_acquisition", 0)
    # multi-band: per-RF-channel sampling rates gathered from the chains
    rf_fs = {c.rf_channel_id: float(c.trk.fs) for c in chains
             if c.rf_channel_id != 0}
    return ReceiverConf(
        rf_fs=rf_fs,
        rtk=rtk, rtk_base_ecef_m=rtk_base,
        pinned_channels=_pinned_channels(config, 0, n_1c),
        fs=fs, prns=tuple(range(1, 33)), max_channels=max(n_1c, 1),
        max_acq_channels=(min(in_acq, n_1c) if in_acq and n_1c
                          else max(n_1c, 1)),
        acq=acq, trk=trk, obs=obs, pvt=pvt,
        output_rate_ms=config.property("Observables.observable_interval_ms",
                                       20),
        pvt_rate_ms=config.property("PVT.output_rate_ms", 0),
        enable_pvt_kf=config.property("PVT.enable_pvt_kf", False),
        chains=tuple(chains), gps_chain=(n_1c > 0),
        # fork hybrid/pseudolite + rx clock keys (rtklib_pvt.cc:910-917,
        # conf/gnss-sdr_GPS_L1_bladeRF2_micro_hybrid_nav.conf)
        hybrid_mode=config.property("GNSS-SDR.hybrid_mode", False),
        pre_2009_file=config.property("GNSS-SDR.pre_2009_file", False),
        ps_channel=config.property("GNSS-SDR.pseudo_sat_ch_id", -1),
        enable_rx_clock_propagation=config.property(
            "PVT.enable_rx_clock_propagation", False),
        share_rx_clock_bias=config.property("PVT.share_rx_clock_bias",
                                            False),
    )


def make_receiver(config: Configuration) -> Receiver:
    return Receiver(receiver_conf_from_config(config))

"""CLI: run the receiver from a GNSS-SDR-style configuration file.

Mirrors the reference binary's interface (src/main/main.cc:119):
  python -m gnss_sim_receiver_tpu --config_file=rx.conf [--duration_s=N]
                                  [--signal_file=...]  (override source)
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from gnss_sim_receiver_tpu.models.conditioner import SignalConditioner
from gnss_sim_receiver_tpu.models.factory import (make_receiver,
                                                  source_from_config)
from gnss_sim_receiver_tpu.utils import geodesy
from gnss_sim_receiver_tpu.utils.config import FileConfiguration
from gnss_sim_receiver_tpu.utils.sample_io import read_samples


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gnss_sim_receiver_tpu")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--signal_file", default=None,
                    help="override SignalSource.filename")
    ap.add_argument("--duration_s", type=float, default=0.0,
                    help="limit processed signal duration")
    ap.add_argument("--log_dir", default=None,
                    help="write a glog-style log file here")
    ap.add_argument("--v", type=int, default=None,
                    help="VLOG verbosity (glog --v)")
    args = ap.parse_args(argv)

    config = FileConfiguration(args.config_file)
    from gnss_sim_receiver_tpu.utils import glog
    glog.init(log_dir=args.log_dir,
              verbosity=args.v if args.v is not None
              else int(config.property("GNSS-SDR.log_verbosity", 0)))
    src = source_from_config(config)
    if args.signal_file:
        src.filename = args.signal_file
    if src.implementation not in ("File_Signal_Source",
                                  "File_Timestamp_Signal_Source",
                                  "Nsr_File_Signal_Source",
                                  "Spir_File_Signal_Source",
                                  "Labsat_Signal_Source"):
        print(f"signal source {src.implementation} not supported in this "
              "build; use File_Signal_Source", file=sys.stderr)
        return 2

    # A-GNSS assistance (control_thread.cc assist_GNSS order: local XML
    # first, then the network client)
    assist_ephs = None
    if str(config.property("GNSS-SDR.AGNSS_XML_enabled",
                           "false")).lower() == "true":
        from gnss_sim_receiver_tpu.nav.agnss_xml import \
            read_gps_ephemeris_xml
        xml_path = config.property("GNSS-SDR.AGNSS_gps_ephemeris_xml",
                                   "gps_ephemeris.xml")
        try:
            assist_ephs = read_gps_ephemeris_xml(xml_path)
            print(f"AGNSS: {len(assist_ephs)} ephemerides from "
                  f"{xml_path}")
        except Exception as e:
            print(f"AGNSS XML load failed: {e}", file=sys.stderr)
    if assist_ephs is None and str(config.property(
            "GNSS-SDR.SUPL_gps_enabled", "false")).lower() == "true":
        from gnss_sim_receiver_tpu.nav.supl_client import fetch_assistance
        host = config.property("GNSS-SDR.SUPL_gps_ephemeris_server",
                               "127.0.0.1")
        port = int(config.property("GNSS-SDR.SUPL_gps_ephemeris_port",
                                   7275))
        try:
            assist_ephs = fetch_assistance(host, port)
            print(f"AGNSS: {len(assist_ephs)} ephemerides from "
                  f"{host}:{port}")
        except Exception as e:
            print(f"network assistance failed: {e}", file=sys.stderr)

    count = -1
    if args.duration_s > 0:
        count = int(args.duration_s * src.sampling_frequency)
    print(f"Reading {src.filename} ({src.item_type}) ...")
    if src.implementation == "Nsr_File_Signal_Source":
        from gnss_sim_receiver_tpu.utils.sample_io import read_samples_nsr
        x = read_samples_nsr(src.filename, count=count)
    elif src.implementation == "Spir_File_Signal_Source":
        from gnss_sim_receiver_tpu.utils.sample_io import read_samples_spir
        x = read_samples_spir(src.filename, count=count)
    elif src.implementation == "Labsat_Signal_Source":
        from gnss_sim_receiver_tpu.utils.sample_io import \
            read_samples_labsat23
        x = read_samples_labsat23(src.filename)
        if count > 0:
            x = x[:count]
    else:
        x = read_samples(src.filename, src.item_type, count=count)
    print(f"  {len(x)} samples at {src.sampling_frequency/1e6:.3f} Msps")

    cond = SignalConditioner(config, fs_in=src.sampling_frequency)
    x = cond.process(x)
    print(f"  conditioned -> {len(x)} samples at {cond.fs_out/1e6:.3f} Msps")

    rx = make_receiver(config)
    # live UDP monitor taps (Monitor.* / NavDataMonitor.* / PVT.enable_
    # monitor* keys, gnss_flowgraph.cc:194-273 + rtklib_pvt.cc:886-898)
    from gnss_sim_receiver_tpu.monitor.sinks import build_monitors
    monitors = build_monitors(config)
    if not monitors.any():
        monitors = None
    else:
        print("Monitors: " + ", ".join(
            n for n in ("synchro", "pvt", "nav", "ephemeris")
            if getattr(monitors, n) is not None))
    # RTK: base observables from a RINEX obs file (PVT.rtk_base_rinex_obs)
    # + known base position (PVT.rtk_base_position_ecef = "x,y,z")
    base_obs = None
    if rx.conf.pvt.positioning_mode.startswith("RTK"):
        from gnss_sim_receiver_tpu.models import outputs as out
        from gnss_sim_receiver_tpu.models.rtk import BaseObservations
        base_path = config.property("PVT.rtk_base_rinex_obs", "")
        if not base_path:
            print("RTK mode needs PVT.rtk_base_rinex_obs", file=sys.stderr)
            return 2
        epochs, prns_b, sys_b = out.read_rinex_obs(base_path)
        base_pos = rx.conf.rtk_base_ecef_m
        if base_pos is None:
            print("RTK mode needs PVT.rtk_base_position_ecef",
                  file=sys.stderr)
            return 2
        base_obs = BaseObservations(epochs=epochs, prns=prns_b,
                                    systems=sys_b,
                                    base_ecef_m=np.asarray(base_pos))
    t0 = time.time()
    if (src.implementation == "File_Timestamp_Signal_Source"
            and src.timestamp_filename):
        from gnss_sim_receiver_tpu.utils.sample_io import read_timestamp_file
        sess = rx.start_session(base_observations=base_obs,
                                ephemerides=assist_ephs)
        if monitors is not None:
            sess.attach_monitors(monitors)
        sc, wk, tow = read_timestamp_file(src.timestamp_filename)
        sess.attach_time_tags(sc, wk, tow,
                              clock_offset_ms=src.timestamp_clock_offset_ms)
        sess.attach_array(x)
        sess.run_to_end()
        run = sess.result()
    else:
        run = rx.process_array(x, base_observations=base_obs,
                               ephemerides=assist_ephs,
                               monitors=monitors)
    dt = time.time() - t0
    if run.rtk_solutions:
        n_fix = sum(1 for _, s in run.rtk_solutions if s.fixed)
        _, last = run.rtk_solutions[-1]
        print(f"RTK: {len(run.rtk_solutions)} epochs, {n_fix} fixed; "
              f"last baseline {last.baseline_m} (ratio {last.ratio:.1f})")
    from gnss_sim_receiver_tpu.models.control import ChannelState
    tracked = [p for p, s in zip(run.channel_prns, run.channel_states)
               if s == ChannelState.TRACKING]
    print(f"Channels: PRNs {tracked}")
    # keys are PRN ints (GPS) or (system, prn) tuples — sort by string so
    # hybrid multi-constellation runs print cleanly
    print(f"Ephemerides decoded: {sorted(run.ephemerides, key=str)}")
    print(f"Processed {len(x)/cond.fs_out:.1f} s of signal in {dt:.1f} s "
          f"({len(x)/cond.fs_out/dt:.1f}x realtime)")
    _write_outputs(config, run)
    if not run.solutions:
        print("No position fix.")
        return 1
    for s in run.solutions[-5:]:
        lat, lon, h = geodesy.ecef_to_llh(s.rx_ecef_m)
        print(f"  t={s.rx_time_corrected_s:.2f}  "
              f"lat={np.degrees(lat):.7f} lon={np.degrees(lon):.7f} "
              f"h={h:.1f}  sats={s.n_sats} gdop={s.gdop:.1f}")
    mean = np.mean([s.rx_ecef_m for s in run.solutions], axis=0)
    lat, lon, h = geodesy.ecef_to_llh(mean)
    print(f"Mean position: lat={np.degrees(lat):.7f} "
          f"lon={np.degrees(lon):.7f} h={h:.2f} m "
          f"({len(run.solutions)} fixes)")
    return 0


def _write_outputs(config, run) -> None:
    """Config-driven output products (reference rtklib_pvt adapter flags:
    PVT.nmea_dump_filename, PVT.flag_kml/gpx/geojson, PVT.rinex_*;
    Observables.dump)."""
    from gnss_sim_receiver_tpu.models import outputs as out
    week = 0
    if run.ephemerides:
        week = next(iter(run.ephemerides.values())).week

    def _enabled(ref_key, legacy_key):
        # the reference adapter uses *_output_enabled names
        # (rtklib_pvt.cc:210-260); the flag_* spellings are kept for
        # compatibility with earlier confs of this framework
        return (config.property(ref_key, False)
                or config.property(legacy_key, False))

    def _rated(solutions, rate_key):
        """Subsample solutions to an output product's own rate
        (PVT.kml_rate_ms etc. vs the solver's output_rate_ms)."""
        rate_ms = float(config.property(rate_key, 0))
        base_ms = float(config.property("PVT.output_rate_ms", 20))
        if rate_ms <= base_ms or base_ms <= 0:
            return solutions
        step = max(1, int(round(rate_ms / base_ms)))
        return solutions[::step]

    if run.solutions:
        if config.property("PVT.flag_nmea_tty_port", False) or \
                config.property("PVT.nmea_output_file_enabled", False) or \
                config.is_present("PVT.nmea_dump_filename"):
            out.write_nmea(config.property(
                "PVT.nmea_output_file_path",
                config.property("PVT.nmea_dump_filename", "pvt.nmea")),
                _rated(run.solutions, "PVT.nmea_rate_ms"), week)
        if _enabled("PVT.kml_output_enabled", "PVT.flag_kml"):
            out.write_kml(config.property("PVT.kml_output_path", "pvt.kml"),
                          _rated(run.solutions, "PVT.kml_rate_ms"))
        if _enabled("PVT.gpx_output_enabled", "PVT.flag_gpx"):
            out.write_gpx(config.property("PVT.gpx_output_path", "pvt.gpx"),
                          _rated(run.solutions, "PVT.gpx_rate_ms"), week)
        if _enabled("PVT.geojson_output_enabled", "PVT.flag_geojson"):
            out.write_geojson(config.property("PVT.geojson_output_path",
                                              "pvt.geojson"),
                              _rated(run.solutions, "PVT.geojson_rate_ms"))
        if config.property("PVT.xml_output_enabled", False):
            out.write_pvt_xml(config.property("PVT.xml_output_path",
                                              "pvt.xml"),
                              run.solutions, week)
    # RTCM 3.x file output (rtklib_pvt.cc rtcm_printer role:
    # PVT.rtcm_output_file_enabled + rtcm_station_id; the rover's own
    # observables + decoded ephemerides as a station stream)
    if run.observation_epochs and run.solutions and config.property(
            "PVT.rtcm_output_file_enabled", False):
        from gnss_sim_receiver_tpu.models.rtcm import RtcmBaseEncoder
        enc = RtcmBaseEncoder(
            run.solutions[-1].rx_ecef_m,
            station_id=int(config.property("PVT.rtcm_station_id", 0)))
        frames = [enc.station_frame()]
        if run.ephemerides:
            frames += enc.ephemeris_frames(run.ephemerides)
        for ep in run.observation_epochs:
            frames += enc.epoch_frames(ep, run.channel_prns,
                                       run.channel_systems
                                       or ["GPS"] * len(run.channel_prns))
        rtcm_path = config.property("PVT.rtcm_output_file_path",
                                    "pvt.rtcm")
        with open(rtcm_path, "wb") as fh:
            fh.write(b"".join(frames))
        print(f"RTCM: {len(frames)} frames -> {rtcm_path}")
    if run.observation_epochs and (
            config.property("PVT.rinex_output_enabled", False)
            or config.property("PVT.flag_rinex", False)):
        rnx_ver = str(config.property("PVT.rinex_version", "3.02"))
        obs_path = config.property("PVT.rinex_output_path", "pvt.obs")
        nav_path = config.property("PVT.rinex_nav_output_path", "pvt.nav")
        if rnx_ver.startswith("2"):
            out.write_rinex2_obs(obs_path, run.observation_epochs,
                                 run.channel_prns, week)
            if run.ephemerides:
                out.write_rinex2_nav(nav_path, run.ephemerides, week)
        else:
            out.write_rinex_obs(obs_path, run.observation_epochs,
                                run.channel_prns, week,
                                systems=run.channel_systems or None)
            if run.ephemerides:
                out.write_rinex_nav(nav_path, run.ephemerides, week)


if __name__ == "__main__":
    sys.exit(main())

"""UDP monitor sinks (protobuf wire format).

Equivalents of the reference's gnss_synchro_monitor GR sink
(src/core/monitor/gnss_synchro_monitor.cc:73-90: every decimation_factor
epochs, serialize the channel vector and send to the configured UDP
endpoints) and monitor_pvt_udp_sink (PVT/libs/monitor_pvt_udp_sink.cc).

The generated protobuf modules are imported by the sink constructors, so a
receiver with no monitor configured never imports protobuf.
"""

from __future__ import annotations

import socket

import numpy as np

from gnss_sim_receiver_tpu.models.outputs import geohash, gps_time_to_utc
from gnss_sim_receiver_tpu.utils import geodesy


class _UdpSender:
    def __init__(self, addresses, port: int):
        self.targets = [(a, port) for a in addresses]
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, payload: bytes) -> None:
        for t in self.targets:
            self.sock.sendto(payload, t)


class GnssSynchroUdpSink:
    """Streams one Observables message per emitted epoch batch, decimated
    like the reference (one message every `decimation_factor` epochs)."""

    def __init__(self, addresses, port: int, prns, fs: float,
                 decimation_factor: int = 1):
        from gnss_sim_receiver_tpu.monitor import gnss_synchro_pb2
        self._pb = gnss_synchro_pb2
        self.sender = _UdpSender(addresses, port)
        self.prns = list(prns)
        self.fs = fs
        self.decim = max(int(decimation_factor), 1)
        self._count = 0

    def push_track_epochs(self, outs: dict, tlm_outs=None, prns=None,
                          system: str = "G", signal: str = "1C") -> int:
        """Send decimated tracking epochs from a [T, C] output batch.
        Returns number of datagrams sent.  `prns` overrides the
        constructor PRN list (live sessions rotate satellites)."""
        t_len = outs["prompt"].shape[0]
        prn_list = list(prns) if prns is not None else self.prns
        sent = 0
        for e in range(t_len):
            self._count += 1
            if self._count % self.decim:
                continue
            msg = self._pb.Observables()
            for c, prn in enumerate(prn_list):
                o = msg.observable.add()
                o.system = system
                o.signal = signal
                o.prn = int(prn)
                o.channel_id = c
                o.fs = int(self.fs)
                o.prompt_i = float(outs["prompt"][e, c].real)
                o.prompt_q = float(outs["prompt"][e, c].imag)
                o.cn0_db_hz = float(outs["cn0_db_hz"][e, c])
                o.carrier_doppler_hz = float(
                    outs["carrier_doppler_hz"][e, c])
                o.carrier_phase_rads = float(
                    outs["acc_phase_cycles"][e, c]) * 2.0 * np.pi
                o.code_phase_samples = float(
                    outs["code_phase_samples"][e, c])
                o.tracking_sample_counter = int(
                    outs["sample_counter"][e, c])
                o.flag_valid_symbol_output = bool(outs["valid"][e, c])
                o.correlation_length_ms = 1
                if tlm_outs is not None and tlm_outs.tow_valid[e, c]:
                    o.flag_valid_word = True
                    o.tow_at_current_symbol_ms = int(
                        tlm_outs.tow_at_epoch_ms[e, c])
            self.sender.send(msg.SerializeToString())
            sent += 1
        return sent


class MonitorPvtUdpSink:
    """Streams one MonitorPvt message per PVT solution."""

    def __init__(self, addresses, port: int, week: int = 0):
        from gnss_sim_receiver_tpu.monitor import monitor_pvt_pb2
        self._pb = monitor_pvt_pb2
        self.sender = _UdpSender(addresses, port)
        self.week = week

    def send_solution(self, sol) -> None:
        m = self._pb.MonitorPvt()
        m.tow_at_current_symbol_ms = int(sol.rx_time_corrected_s * 1000) \
            % 604800000
        m.week = self.week
        m.rx_time = float(sol.rx_time_corrected_s)
        m.user_clk_offset = float(sol.rx_clock_bias_s)
        m.pos_x, m.pos_y, m.pos_z = map(float, sol.rx_ecef_m)
        m.vel_x, m.vel_y, m.vel_z = map(float, sol.rx_vel_ecef_ms)
        lat, lon, h = geodesy.ecef_to_llh(sol.rx_ecef_m)
        m.latitude = float(np.degrees(lat))
        m.longitude = float(np.degrees(lon))
        m.height = float(h)
        m.valid_sats = int(sol.n_sats)
        m.gdop, m.pdop, m.hdop, m.vdop = (float(sol.gdop), float(sol.pdop),
                                          float(sol.hdop), float(sol.vdop))
        m.user_clk_drift_ppm = float(sol.rx_clock_drift_ss) * 1e6
        m.utc_time = gps_time_to_utc(self.week,
                                     sol.rx_time_corrected_s).isoformat()
        enu = geodesy.ecef_to_enu_matrix(lat, lon) @ np.asarray(
            sol.rx_vel_ecef_ms)
        m.vel_e, m.vel_n, m.vel_u = map(float, enu)
        m.geohash = geohash(np.degrees(lat), np.degrees(lon))
        self.sender.send(m.SerializeToString())


class MonitorEphemerisUdpSink:
    """Streams newly decoded GPS ephemerides as GpsEphemeris protobuf
    (reference monitor_ephemeris_udp_sink.cc, enabled by
    PVT.enable_monitor_ephemeris, rtklib_pvt.cc:896-898)."""

    def __init__(self, addresses, port: int):
        from gnss_sim_receiver_tpu.monitor import gps_ephemeris_pb2
        self._pb = gps_ephemeris_pb2
        self.sender = _UdpSender(addresses, port)

    def send_ephemeris(self, eph) -> None:
        sc = np.pi          # broadcast semicircle fields -> radians
        m = self._pb.GpsEphemeris()
        m.PRN = int(eph.prn)
        m.M_0 = float(eph.m0_sc) * sc
        m.delta_n = float(eph.delta_n_sc) * sc
        m.ecc = float(eph.ecc)
        m.sqrtA = float(eph.sqrt_a)
        m.OMEGA_0 = float(eph.omega0_sc) * sc
        m.i_0 = float(eph.i0_sc) * sc
        m.omega = float(eph.omega_sc) * sc
        m.OMEGAdot = float(eph.omega_dot_sc) * sc
        m.idot = float(eph.idot_sc) * sc
        m.Cuc, m.Cus = float(eph.cuc), float(eph.cus)
        m.Crc, m.Crs = float(eph.crc), float(eph.crs)
        m.Cic, m.Cis = float(eph.cic), float(eph.cis)
        m.toe = int(eph.toe)
        m.toc = int(eph.toc)
        m.af0, m.af1, m.af2 = (float(eph.af0), float(eph.af1),
                               float(eph.af2))
        m.WN = int(eph.week)
        m.TGD = float(eph.tgd)
        m.IODC = int(eph.iodc)
        m.IODE_SF2 = int(eph.iode)
        m.IODE_SF3 = int(eph.iode)
        self.sender.send(m.SerializeToString())


class NavMessageUdpSink:
    """Streams decoded navigation-message units (reference
    nav_message_monitor + nav_message_udp_sink, src/core/libs/): one navMsg
    datagram per decoded LNAV subframe, parseable by the reference's
    nav-listener utility."""

    def __init__(self, addresses, port: int):
        from gnss_sim_receiver_tpu.monitor import nav_message_pb2
        self._pb = nav_message_pb2
        self.sender = _UdpSender(addresses, port)

    def send_subframe(self, prn: int, tow_ms: float, bits,
                      system: str = "G", signal: str = "1C") -> None:
        m = self._pb.navMsg()
        m.system = system
        m.signal = signal
        m.prn = int(prn)
        m.tow_at_current_symbol_ms = int(tow_ms)
        m.nav_message = "".join("1" if int(b) else "0" for b in bits)
        self.sender.send(m.SerializeToString())


class Monitors:
    """The set of conf-enabled monitor taps a live session streams to
    (reference gnss_flowgraph.cc:194-273 wires up to three
    gnss_synchro_monitor taps plus nav/PVT monitors at flowgraph
    build)."""

    def __init__(self, synchro=None, pvt=None, nav=None, ephemeris=None):
        self.synchro = synchro
        self.pvt = pvt
        self.nav = nav
        self.ephemeris = ephemeris

    def any(self) -> bool:
        return any((self.synchro, self.pvt, self.nav, self.ephemeris))


def _addresses(config, key, default="127.0.0.1"):
    raw = str(config.property(key, default))
    return [a.strip() for a in raw.split(",") if a.strip()]


def build_monitors(config) -> Monitors:
    """Instantiate monitor sinks from the reference conf keys:

    - Monitor.enable_monitor / client_addresses / udp_port /
      decimation_factor            (gnss_flowgraph.cc:194-211)
    - NavDataMonitor.enable_monitor / client_addresses / port
                                    (gnss_flowgraph.cc:264-272)
    - PVT.enable_monitor / monitor_client_addresses / monitor_udp_port
                                    (rtklib_pvt.cc:886-888)
    - PVT.enable_monitor_ephemeris / monitor_ephemeris_client_addresses /
      monitor_ephemeris_udp_port    (rtklib_pvt.cc:896-898)
    """
    def _b(key):
        v = config.property(key, False)
        return v if isinstance(v, bool) else str(v).lower() == "true"

    mon = Monitors()
    if _b("Monitor.enable_monitor"):
        mon.synchro = GnssSynchroUdpSink(
            _addresses(config, "Monitor.client_addresses"),
            int(config.property("Monitor.udp_port", 1234)),
            prns=[], fs=0.0,
            decimation_factor=int(
                config.property("Monitor.decimation_factor", 1)))
    if _b("NavDataMonitor.enable_monitor"):
        mon.nav = NavMessageUdpSink(
            _addresses(config, "NavDataMonitor.client_addresses"),
            int(config.property("NavDataMonitor.port", 1237)))
    if _b("PVT.enable_monitor"):
        mon.pvt = MonitorPvtUdpSink(
            _addresses(config, "PVT.monitor_client_addresses"),
            int(config.property("PVT.monitor_udp_port", 1234)))
    if _b("PVT.enable_monitor_ephemeris"):
        mon.ephemeris = MonitorEphemerisUdpSink(
            _addresses(config, "PVT.monitor_ephemeris_client_addresses"),
            int(config.property("PVT.monitor_ephemeris_udp_port", 1234)))
    return mon

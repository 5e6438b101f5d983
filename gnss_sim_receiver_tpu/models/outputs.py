"""PVT output writers: NMEA-0183, KML, GPX, GeoJSON, geohash, RINEX.

Host-side equivalents of the reference PVT printer stack
(src/algorithms/PVT/libs/: nmea_printer.cc, kml_printer.cc,
gpx_printer.cc, geojson_printer.cc, rinex_printer.cc) — compact functional
writers over PvtSolution/ObservationEpoch streams instead of 13.8 kLoC of
stateful printer classes.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.utils import geodesy

# GPS epoch (1980-01-06) for week/TOW -> UTC conversion (ignoring leap
# seconds unless provided, like the reference before UTC params arrive)
GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)


def gps_time_to_utc(week: int, tow_s: float,
                    leap_s: float = 18.0) -> datetime.datetime:
    return GPS_EPOCH + datetime.timedelta(weeks=week,
                                          seconds=tow_s - leap_s)


# ---------------------------------------------------------------------------
# NMEA-0183 (nmea_printer.cc)
# ---------------------------------------------------------------------------

def _nmea_checksum(body: str) -> str:
    cs = 0
    for ch in body:
        cs ^= ord(ch)
    return f"{cs:02X}"


def _nmea_latlon(lat_deg: float, lon_deg: float):
    lat_h = "N" if lat_deg >= 0 else "S"
    lon_h = "E" if lon_deg >= 0 else "W"
    alat, alon = abs(lat_deg), abs(lon_deg)
    lat_s = f"{int(alat):02d}{(alat - int(alat)) * 60:010.7f}"
    lon_s = f"{int(alon):03d}{(alon - int(alon)) * 60:010.7f}"
    return lat_s, lat_h, lon_s, lon_h


def nmea_gga(sol, week: int = 0, leap_s: float = 18.0) -> str:
    lat, lon, h = geodesy.ecef_to_llh(sol.rx_ecef_m)
    t = gps_time_to_utc(week, sol.rx_time_corrected_s, leap_s)
    lat_s, lat_h, lon_s, lon_h = _nmea_latlon(np.degrees(lat),
                                              np.degrees(lon))
    body = (f"GPGGA,{t:%H%M%S}.{t.microsecond // 10000:02d},"
            f"{lat_s},{lat_h},{lon_s},{lon_h},1,{sol.n_sats:02d},"
            f"{sol.hdop:.1f},{h:.1f},M,0.0,M,,")
    return f"${body}*{_nmea_checksum(body)}"


def nmea_rmc(sol, week: int = 0, leap_s: float = 18.0) -> str:
    lat, lon, _ = geodesy.ecef_to_llh(sol.rx_ecef_m)
    t = gps_time_to_utc(week, sol.rx_time_corrected_s, leap_s)
    lat_s, lat_h, lon_s, lon_h = _nmea_latlon(np.degrees(lat),
                                              np.degrees(lon))
    v = np.asarray(sol.rx_vel_ecef_ms)
    speed_kt = float(np.linalg.norm(v[:2])) * 1.9438445
    body = (f"GPRMC,{t:%H%M%S}.{t.microsecond // 10000:02d},A,"
            f"{lat_s},{lat_h},{lon_s},{lon_h},{speed_kt:.2f},0.0,"
            f"{t:%d%m%y},,,A")
    return f"${body}*{_nmea_checksum(body)}"


def write_nmea(path, solutions, week: int = 0) -> None:
    with open(path, "w") as fh:
        for s in solutions:
            fh.write(nmea_gga(s, week) + "\r\n")
            fh.write(nmea_rmc(s, week) + "\r\n")


# ---------------------------------------------------------------------------
# KML / GPX / GeoJSON (kml_printer.cc, gpx_printer.cc, geojson_printer.cc)
# ---------------------------------------------------------------------------

def write_kml(path, solutions, name: str = "gnss_sim_receiver_tpu") -> None:
    coords = []
    for s in solutions:
        lat, lon, h = geodesy.ecef_to_llh(s.rx_ecef_m)
        coords.append(f"{np.degrees(lon):.9f},{np.degrees(lat):.9f},{h:.2f}")
    Path(path).write_text(
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<kml xmlns="http://www.opengis.net/kml/2.2">\n'
        f"<Document><name>{name}</name><Placemark><LineString>\n"
        "<coordinates>\n" + "\n".join(coords) + "\n</coordinates>\n"
        "</LineString></Placemark></Document></kml>\n")


def write_gpx(path, solutions, week: int = 0) -> None:
    pts = []
    for s in solutions:
        lat, lon, h = geodesy.ecef_to_llh(s.rx_ecef_m)
        t = gps_time_to_utc(week, s.rx_time_corrected_s)
        pts.append(f'<trkpt lat="{np.degrees(lat):.9f}" '
                   f'lon="{np.degrees(lon):.9f}"><ele>{h:.2f}</ele>'
                   f"<time>{t:%Y-%m-%dT%H:%M:%S}Z</time></trkpt>")
    Path(path).write_text(
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<gpx version="1.1" xmlns="http://www.topografix.com/GPX/1/1">\n'
        "<trk><trkseg>\n" + "\n".join(pts) + "\n</trkseg></trk></gpx>\n")


def write_geojson(path, solutions) -> None:
    import json
    coords = []
    for s in solutions:
        lat, lon, h = geodesy.ecef_to_llh(s.rx_ecef_m)
        coords.append([round(float(np.degrees(lon)), 9),
                       round(float(np.degrees(lat)), 9), round(h, 2)])
    Path(path).write_text(json.dumps({
        "type": "Feature",
        "geometry": {"type": "LineString", "coordinates": coords},
        "properties": {"name": "gnss_sim_receiver_tpu track"},
    }))


_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash(lat_deg: float, lon_deg: float, precision: int = 12) -> str:
    """Geohash encoder (reference geohash.cc)."""
    lat_rng = [-90.0, 90.0]
    lon_rng = [-180.0, 180.0]
    bits = []
    even = True
    while len(bits) < precision * 5:
        rng, val = (lon_rng, lon_deg) if even else (lat_rng, lat_deg)
        mid = (rng[0] + rng[1]) / 2
        if val >= mid:
            bits.append(1)
            rng[0] = mid
        else:
            bits.append(0)
            rng[1] = mid
        even = not even
    out = []
    for i in range(precision):
        idx = 0
        for b in bits[5 * i:5 * i + 5]:
            idx = (idx << 1) | b
        out.append(_GEOHASH32[idx])
    return "".join(out)


# ---------------------------------------------------------------------------
# RINEX 3.02 (rinex_printer.cc — functional multi-GNSS subset)
# ---------------------------------------------------------------------------

def _band_code(system: str, freq_hz: float | None) -> str:
    """RINEX 3 band digit + attribute for a (system, carrier) pair —
    the observation-code mapping of rinex_printer.cc signalStrength /
    obs-type tables."""
    if freq_hz is None:
        return {"GPS": "1C", "Galileo": "1B", "GLONASS": "1C",
                "BeiDou": "2I", "SBAS": "1C"}.get(system, "1C")
    mhz = freq_hz / 1e6
    table = {
        "GPS": [(1575.42, "1C"), (1227.60, "2S"), (1176.45, "5I")],
        "Galileo": [(1575.42, "1B"), (1176.45, "5I"), (1207.14, "7I"),
                    (1278.75, "6B")],
        "GLONASS": [(1602.0, "1C"), (1246.0, "2C")],
        "BeiDou": [(1561.098, "2I"), (1268.52, "6I")],
        "SBAS": [(1575.42, "1C")],
    }.get(system, [(1575.42, "1C")])
    return min(table, key=lambda kv: abs(kv[0] - mhz))[1]


def write_rinex_obs(path, epochs, prns, week: int, *,
                    systems=None, carrier_freq_hz=None,
                    marker: str = "GNSS0") -> None:
    """RINEX 3.02 multi-GNSS observation file: per-system observation
    types (C/L/D/S per band actually present), one satellite line per
    epoch with same-satellite multi-band channels merged onto one record
    (rinex_printer.cc log_rinex_obs multi-system path).  Carrier phase is
    negated into the RINEX sign convention (chain phase grows as
    -range/lambda)."""
    n = len(prns)
    systems = list(systems) if systems is not None else ["GPS"] * n
    freqs = (np.asarray(carrier_freq_hz, np.float64)
             if carrier_freq_hz is not None else [None] * n)
    bands = [_band_code(systems[c], None if freqs[c] is None
                        else float(freqs[c])) for c in range(n)]
    sys_letters = [_SYS_RINEX.get(systems[c], "G") for c in range(n)]
    # per-system ordered band list
    sys_bands: dict = {}
    for c in range(n):
        sys_bands.setdefault(sys_letters[c], [])
        if bands[c] not in sys_bands[sys_letters[c]]:
            sys_bands[sys_letters[c]].append(bands[c])
    lines = []
    ftype = ("G: GPS" if set(sys_letters) == {"G"} else "M: MIXED")
    lines.append(f"{'3.02':>9}{'':11}{'OBSERVATION DATA':<20}"
                 f"{ftype:<20}{'RINEX VERSION / TYPE'}")
    lines.append(f"{'gnss_sim_receiver_tpu':<20}{'':40}"
                 f"{'PGM / RUN BY / DATE'}")
    lines.append(f"{marker:<60}{'MARKER NAME'}")
    for letter in sorted(sys_bands):
        obs = " ".join(f"C{b} L{b} D{b} S{b}" for b in sys_bands[letter])
        n_obs = 4 * len(sys_bands[letter])
        lines.append(f"{letter:<1}{'':2}{n_obs:3d} {obs:<53}"
                     f"{'SYS / # / OBS TYPES'}")
    first = gps_time_to_utc(week, epochs[0].rx_time_s, 0.0)
    lines.append(f"{first.year:6d}{first.month:6d}{first.day:6d}"
                 f"{first.hour:6d}{first.minute:6d}{first.second:13.7f}"
                 f"{'GPS':>8}{'':9}{'TIME OF FIRST OBS'}")
    lines.append(f"{'':60}{'END OF HEADER'}")
    for ep in epochs:
        t = gps_time_to_utc(week, ep.rx_time_s, 0.0)
        # merge channels onto (system, prn) records
        recs: dict = {}
        for c in range(n):
            if not ep.valid[c]:
                continue
            recs.setdefault((sys_letters[c], int(prns[c])), {})[bands[c]] \
                = c
        if not recs:
            continue
        lines.append(f"> {t.year:4d} {t.month:02d} {t.day:02d} "
                     f"{t.hour:02d} {t.minute:02d}"
                     f"{t.second + t.microsecond / 1e6:11.7f}"
                     f"  0{len(recs):3d}")
        for (letter, prn) in sorted(recs):
            row = f"{letter}{prn:02d}"
            for b in sys_bands[letter]:
                c = recs[(letter, prn)].get(b)
                if c is None:
                    row += " " * 64
                    continue
                phase_cyc = -ep.carrier_phase_cycles[c]   # RINEX sign
                row += (f"{ep.pseudorange_m[c]:14.3f}  "
                        f"{phase_cyc:14.3f}  "
                        f"{ep.carrier_doppler_hz[c]:14.3f}  "
                        f"{ep.cn0_db_hz[c]:14.3f}  ")
            lines.append(row.rstrip() if row.strip() else row)
    Path(path).write_text("\n".join(lines) + "\n")


_RINEX_SYS = {"G": "GPS", "E": "Galileo", "R": "GLONASS", "C": "BeiDou",
              "S": "SBAS"}
_SYS_RINEX = {v: k for k, v in _RINEX_SYS.items()}


def read_rinex_obs(path):
    """Parse a RINEX observation file written by write_rinex_obs back into
    (epochs, prns, systems): a list of ObservationEpoch in a channel space
    with one channel per satellite seen in the file (the role of rtklib's
    readrnxobs feeding the base obs stream for relative positioning).

    The carrier phase is negated back to the chain's accumulated-PLL-phase
    convention (write_rinex_obs negates it for the RINEX sign convention),
    and interp_tow_ms is reconstructed from rx_time - pseudorange/c —
    the inverse of the observables engine's compute_pranges.
    """
    from gnss_sim_receiver_tpu.models.observables import ObservationEpoch
    recs = []          # (rx_time_s, [(system, prn, pr, ph, dop, cn0)])
    cur = None
    with open(path) as fh:
        lines = fh.readlines()
    in_header = True
    for ln in lines:
        if in_header:
            if "END OF HEADER" in ln:
                in_header = False
            continue
        if ln.startswith(">"):
            p = ln[1:].split()
            y, mo, d, h, mi = (int(p[0]), int(p[1]), int(p[2]), int(p[3]),
                               int(p[4]))
            sec = float(p[5])
            t = datetime.datetime(y, mo, d, h, mi,
                                  tzinfo=datetime.timezone.utc) \
                + datetime.timedelta(seconds=sec)
            total_s = (t - GPS_EPOCH).total_seconds()
            rx_time_s = total_s % 604800.0
            cur = (rx_time_s, [])
            recs.append(cur)
        elif cur is not None and ln[:1] in _RINEX_SYS:
            sysname = _RINEX_SYS[ln[0]]
            prn = int(ln[1:3])
            # first non-blank band group (fixed 16-char fields, 64 chars
            # per C/L/D/S group); multi-band base files contribute their
            # first observed band per satellite
            body = ln[3:].rstrip("\n")
            group = None
            for g in range(max(1, (len(body) + 63) // 64)):
                seg = body[64 * g: 64 * (g + 1)]
                if seg.strip():
                    group = seg
                    break
            if group is None:
                continue
            vals = group.split()
            if len(vals) < 4:
                continue
            pr, ph, dop, cn0 = (float(vals[0]), float(vals[1]),
                                float(vals[2]), float(vals[3]))
            cur[1].append((sysname, prn, pr, -ph, dop, cn0))
    # channel space: one channel per satellite, order of first appearance
    chan = {}
    for _, obs in recs:
        for sysname, prn, *_ in obs:
            chan.setdefault((sysname, prn), len(chan))
    n = len(chan)
    epochs = []
    for rx_time_s, obs in recs:
        valid = np.zeros(n, bool)
        pr = np.zeros(n)
        tow = np.full(n, np.nan)
        dop = np.zeros(n)
        ph = np.zeros(n)
        cn0 = np.zeros(n)
        for sysname, prn, p, f, dd, c0 in obs:
            c = chan[(sysname, prn)]
            valid[c] = True
            pr[c] = p
            ph[c] = f
            dop[c] = dd
            cn0[c] = c0
            tow[c] = rx_time_s * 1000.0 - p / (constants.SPEED_OF_LIGHT_M_S
                                               / 1000.0)
        epochs.append(ObservationEpoch(
            rx_time_s=rx_time_s, tick_sample=0, valid=valid,
            pseudorange_m=pr, interp_tow_ms=tow, carrier_doppler_hz=dop,
            carrier_phase_cycles=ph, cn0_db_hz=cn0))
    keys = sorted(chan, key=chan.get)
    return epochs, [p for _, p in keys], [s for s, _ in keys]


def write_rinex_nav(path, ephemerides: dict, week: int) -> None:
    """RINEX 3.02 multi-GNSS navigation file (rinex_printer.cc
    log_rinex_nav family).  Accepts the receiver's mixed ephemeris dict:
    GPS under int PRN keys, other constellations under (system, prn)
    keys.  Kepler-broadcast systems (GPS/Galileo/BeiDou/SBAS-as-Kepler)
    get 8-line G/E/C records; GLONASS state-vector ephemerides get the
    4-line R record (pos/vel/acc in km, rinex_printer.cc Glonass nav)."""
    def f(x):
        s = f"{x: .12E}"
        return s.replace("E+", "E+").replace("E-", "E-").rjust(19)

    def sort_key(k):
        return (("GPS", k) if isinstance(k, int) else (k[0], k[1]))

    systems = {("GPS" if isinstance(k, int) else k[0])
               for k in ephemerides}
    ftype = "G: GPS" if systems <= {"GPS"} else "M: MIXED"
    lines = []
    lines.append(f"{'3.02':>9}{'':11}{'N: GNSS NAV DATA':<20}"
                 f"{ftype:<20}{'RINEX VERSION / TYPE'}")
    lines.append(f"{'':60}{'END OF HEADER'}")
    for key in sorted(ephemerides, key=sort_key):
        e = ephemerides[key]
        system = "GPS" if isinstance(key, int) else key[0]
        prn = key if isinstance(key, int) else key[1]
        letter = _SYS_RINEX.get(system, "G")
        if hasattr(e, "pos_m") and not hasattr(e, "sqrt_a"):
            # GLONASS state-vector record (km / km/s / km/s^2)
            toc = gps_time_to_utc(week, e.tb_s, 0.0)
            tau = getattr(e, "tau_n", 0.0)
            gam = getattr(e, "gamma_n", 0.0)
            lines.append(f"R{prn:02d} {toc.year:4d} {toc.month:02d} "
                         f"{toc.day:02d} {toc.hour:02d} {toc.minute:02d} "
                         f"{toc.second:02d}{f(-tau)}{f(gam)}{f(e.tb_s)}")
            p, v, a = e.pos_m, e.vel_ms, e.acc_ms2
            lines.append(f"    {f(p[0] / 1e3)}{f(v[0] / 1e3)}"
                         f"{f(a[0] / 1e3)}{f(0.0)}")
            lines.append(f"    {f(p[1] / 1e3)}{f(v[1] / 1e3)}"
                         f"{f(a[1] / 1e3)}{f(float(e.freq_slot))}")
            lines.append(f"    {f(p[2] / 1e3)}{f(v[2] / 1e3)}"
                         f"{f(a[2] / 1e3)}{f(0.0)}")
            continue
        toc = gps_time_to_utc(week, e.toc, 0.0)
        iode = getattr(e, "iode", 0)
        # broadcast-orbit line 1 field 1 and lines 6-8 are
        # constellation-specific (RINEX 3.02 tables A14/A15/A16;
        # rinex_printer.cc log_rinex_nav per-system overloads)
        if system == "Galileo":
            first = float(getattr(e, "iod_nav", iode))
        elif system == "BeiDou":
            first = float(getattr(e, "iode", 0))     # AODE
        else:
            first = float(iode)
        lines.append(f"{letter}{prn:02d} {toc.year:4d} {toc.month:02d} "
                     f"{toc.day:02d} {toc.hour:02d} {toc.minute:02d} "
                     f"{toc.second:02d}{f(e.af0)}{f(e.af1)}{f(e.af2)}")
        lines.append(f"    {f(first)}{f(e.crs)}{f(e.delta_n_sc * np.pi)}"
                     f"{f(e.m0_sc * np.pi)}")
        lines.append(f"    {f(e.cuc)}{f(e.ecc)}{f(e.cus)}{f(e.sqrt_a)}")
        lines.append(f"    {f(e.toe)}{f(e.cic)}{f(e.omega0_sc * np.pi)}"
                     f"{f(e.cis)}")
        lines.append(f"    {f(e.i0_sc * np.pi)}{f(e.crc)}"
                     f"{f(e.omega_sc * np.pi)}{f(e.omega_dot_sc * np.pi)}")
        if system == "Galileo":
            # data sources (bit0: I/NAV E1-B), GAL week; SISA, health,
            # BGD(E1,E5a), BGD(E1,E5b); transmission time
            lines.append(f"    {f(e.idot_sc * np.pi)}{f(513.0)}"
                         f"{f(float(week))}{f(0.0)}")
            lines.append(f"    {f(3.12)}{f(0.0)}"
                         f"{f(getattr(e, 'bgd_e1e5a', 0.0))}"
                         f"{f(getattr(e, 'bgd_e1e5b', 0.0))}")
            lines.append(f"    {f(e.toe)}{f(0.0)}")
        elif system == "BeiDou":
            # spare, BDT week (BDT = GPS week - 1356 on the common
            # timescale); SV accuracy, SatH1, TGD1, TGD2; ttom, AODC
            lines.append(f"    {f(e.idot_sc * np.pi)}{f(0.0)}"
                         f"{f(float(week - 1356))}{f(0.0)}")
            lines.append(f"    {f(2.0)}{f(0.0)}{f(e.tgd)}"
                         f"{f(getattr(e, 'tgd2', 0.0))}")
            lines.append(f"    {f(e.toe)}"
                         f"{f(float(getattr(e, 'iodc', 0)))}")
        else:
            # GPS: codes on L2, GPS week, L2P flag; SV accuracy, health,
            # TGD, IODC; transmission time, fit interval
            lines.append(f"    {f(e.idot_sc * np.pi)}{f(0.0)}"
                         f"{f(float(week))}{f(0.0)}")
            lines.append(f"    {f(2.0)}{f(0.0)}{f(e.tgd)}"
                         f"{f(float(getattr(e, 'iodc', 0)))}")
            lines.append(f"    {f(e.toe)}{f(4.0)}")
    Path(path).write_text("\n".join(lines) + "\n")


def utc_to_gps_time(dt, leap_s: float = 18.0):
    """datetime -> (week, tow_s); inverse of gps_time_to_utc."""
    delta = (dt - GPS_EPOCH).total_seconds() + leap_s
    week = int(delta // 604800.0)
    return week, delta - week * 604800.0


def read_rinex_nav(path):
    """RINEX 3.02 navigation reader (inverse of write_rinex_nav for the
    Kepler systems G/E/C; GLONASS R records are skipped).  Returns the
    receiver's mixed ephemeris dict: GPS under int PRN keys, others under
    (system, prn) — the same shape Receiver.process_array(ephemerides=)
    and nav.ephemeris.save_assistance consume."""
    import re

    from gnss_sim_receiver_tpu.nav.ephemeris import GpsEphemeris

    sys_of = {"G": "GPS", "E": "Galileo", "C": "BeiDou"}
    text = Path(path).read_text().splitlines()
    i = 0
    while i < len(text) and "END OF HEADER" not in text[i]:
        i += 1
    i += 1

    def fields(line, start=4):
        out = []
        for j in range(start, len(line), 19):
            s = line[j:j + 19].strip()
            if s:
                out.append(float(s.replace("D", "E")))
        return out

    ephs = {}
    while i < len(text):
        line = text[i]
        if not line or line[0] not in "GECR":
            i += 1
            continue
        if line[0] == "R":
            i += 4
            continue
        system = sys_of[line[0]]
        prn = int(line[1:3])
        m = re.match(r".{3}\s*(\d{4})\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)"
                     r"\s+(\d+)", line)
        y, mo, d, h, mi, sec = (int(g) for g in m.groups())
        week, toc = utc_to_gps_time(datetime.datetime(
            y, mo, d, h, mi, sec, tzinfo=datetime.timezone.utc))
        clk = fields(line, start=23)
        rows = [fields(text[i + k]) for k in range(1, 8)
                if i + k < len(text)]
        n_rows = 7
        vals = [v for r in rows[:n_rows] for v in r]
        e = GpsEphemeris(prn=prn, system=system, week=week, toc=toc,
                         af0=clk[0], af1=clk[1], af2=clk[2])
        (first, e.crs, dn, m0) = vals[0:4]
        e.delta_n_sc = dn / np.pi
        e.m0_sc = m0 / np.pi
        (e.cuc, e.ecc, e.cus, e.sqrt_a) = vals[4:8]
        (e.toe, e.cic, om0, e.cis) = vals[8:12]
        e.omega0_sc = om0 / np.pi
        (i0, e.crc, om, omd) = vals[12:16]
        e.i0_sc = i0 / np.pi
        e.omega_sc = om / np.pi
        e.omega_dot_sc = omd / np.pi
        e.idot_sc = vals[16] / np.pi
        if system == "Galileo":
            e.iod_nav = int(first)
            e.bgd_e1e5a = vals[22] if len(vals) > 22 else 0.0
            e.bgd_e1e5b = vals[23] if len(vals) > 23 else 0.0
        elif system == "BeiDou":
            e.iode = int(first)
            e.tgd = vals[22] if len(vals) > 22 else 0.0
            e.iodc = int(vals[25]) if len(vals) > 25 else 0
        else:
            e.iode = int(first)
            e.tgd = vals[22] if len(vals) > 22 else 0.0
            e.iodc = int(vals[23]) if len(vals) > 23 else 0
        key = prn if system == "GPS" else (system, prn)
        ephs[key] = e
        i += 1 + n_rows
    return ephs


# ---------------------------------------------------------------------------
# RINEX 2.11 (rinex_printer.cc version-2 path, selected by the reference
# conf key PVT.rinex_version=2.11: GPS L1 C1/L1/D1/S1 subset with
# D-exponent numerics and inline satellite lists)
# ---------------------------------------------------------------------------

def _d19(x) -> str:
    """FORTRAN D19.12 field: RINEX 2 wants D exponents."""
    s = f"{float(x): .12E}".replace("E", "D")
    return s.rjust(19)


def write_rinex2_obs(path, epochs, prns, week: int, *,
                     marker: str = "GNSS0") -> None:
    """RINEX 2.11 GPS observation file (C1 L1 D1 S1).  Satellites of
    other systems are skipped — version 2 output in the reference is a
    GPS-era format (rinex_printer.cc version==2 branches)."""
    lines = []
    lines.append(f"{'2.11':>9}{'':11}{'OBSERVATION DATA':<20}"
                 f"{'G (GPS)':<20}{'RINEX VERSION / TYPE'}")
    lines.append(f"{'gnss_sim_receiver_tpu':<20}{'':40}"
                 f"{'PGM / RUN BY / DATE'}")
    lines.append(f"{marker:<60}{'MARKER NAME'}")
    lines.append(f"{4:6d}{'C1':>6}{'L1':>6}{'D1':>6}{'S1':>6}{'':30}"
                 f"{'# / TYPES OF OBSERV'}")
    first = gps_time_to_utc(week, epochs[0].rx_time_s, 0.0)
    lines.append(f"{first.year:6d}{first.month:6d}{first.day:6d}"
                 f"{first.hour:6d}{first.minute:6d}{first.second:13.7f}"
                 f"{'GPS':>8}{'':9}{'TIME OF FIRST OBS'}")
    lines.append(f"{'':60}{'END OF HEADER'}")
    n = len(prns)
    for ep in epochs:
        sats = [c for c in range(n) if ep.valid[c]]
        if not sats:
            continue
        t = gps_time_to_utc(week, ep.rx_time_s, 0.0)
        sec = t.second + t.microsecond / 1e6
        head = (f" {t.year % 100:02d} {t.month:2d} {t.day:2d} {t.hour:2d} "
                f"{t.minute:2d}{sec:11.7f}  0{len(sats):3d}")
        # inline satellite list, 12 per line (epoch/sat continuation)
        ids = "".join(f"G{int(prns[c]):02d}" for c in sats[:12])
        lines.append(head + ids)
        for k in range(12, len(sats), 12):
            lines.append(" " * 32
                         + "".join(f"G{int(prns[c]):02d}"
                                   for c in sats[k:k + 12]))
        for c in sats:
            phase_cyc = -ep.carrier_phase_cycles[c]   # RINEX sign
            lines.append(f"{ep.pseudorange_m[c]:14.3f}  "
                         f"{phase_cyc:14.3f}  "
                         f"{ep.carrier_doppler_hz[c]:14.3f}  "
                         f"{ep.cn0_db_hz[c]:14.3f}  ".rstrip())
    Path(path).write_text("\n".join(lines) + "\n")


def write_rinex2_nav(path, ephemerides: dict, week: int) -> None:
    """RINEX 2.11 GPS navigation file: 'PRN yy mm dd ...' records, data
    columns from col 4 with D-exponents (rinex_printer.cc
    log_rinex_nav version-2 overload).  Non-GPS keys are skipped."""
    f = _d19
    lines = []
    lines.append(f"{'2.11':>9}{'':11}{'N: GPS NAV DATA':<20}{'':20}"
                 f"{'RINEX VERSION / TYPE'}")
    lines.append(f"{'':60}{'END OF HEADER'}")
    for key in sorted(k for k in ephemerides if isinstance(k, int)):
        e = ephemerides[key]
        toc = gps_time_to_utc(week, e.toc, 0.0)
        sec = toc.second + toc.microsecond / 1e6
        lines.append(f"{key:2d} {toc.year % 100:02d} {toc.month:2d} "
                     f"{toc.day:2d} {toc.hour:2d} {toc.minute:2d}"
                     f"{sec:5.1f}{f(e.af0)}{f(e.af1)}{f(e.af2)}")
        iode = float(getattr(e, "iode", 0))
        rows = [
            (iode, e.crs, e.delta_n_sc * np.pi, e.m0_sc * np.pi),
            (e.cuc, e.ecc, e.cus, e.sqrt_a),
            (e.toe, e.cic, e.omega0_sc * np.pi, e.cis),
            (e.i0_sc * np.pi, e.crc, e.omega_sc * np.pi,
             e.omega_dot_sc * np.pi),
            (e.idot_sc * np.pi, 1.0, float(week % 1024), 0.0),
            (0.0, float(getattr(e, "sv_health", 0)),
             float(getattr(e, "tgd", 0.0)),
             float(getattr(e, "iodc", iode))),
            (0.0, 4.0, 0.0, 0.0),
        ]
        for r in rows:
            lines.append("   " + "".join(f(v) for v in r))
    Path(path).write_text("\n".join(lines) + "\n")


def read_rinex2_nav(path) -> dict:
    """Read back a RINEX 2.11 GPS nav file (round-trip test and
    assistance interop with legacy 2.11 products).  Field layout per
    RINEX 2.11 table A4: 7 broadcast-orbit rows of 4 D19.12 columns
    starting at column 4."""
    from gnss_sim_receiver_tpu.nav.ephemeris import GpsEphemeris
    txt = Path(path).read_text().splitlines()
    i = 0
    while i < len(txt) and "END OF HEADER" not in txt[i]:
        i += 1
    i += 1

    def fl(s):
        s = s.strip().replace("D", "E")
        return float(s) if s else 0.0

    out = {}
    while i + 7 < len(txt) + 1 and i < len(txt) and txt[i].strip():
        hdr = txt[i]
        prn = int(hdr[:2])
        af0, af1, af2 = fl(hdr[22:41]), fl(hdr[41:60]), fl(hdr[60:79])
        v = []
        for r in range(1, 8):
            row = txt[i + r] if i + r < len(txt) else ""
            for k in range(4):
                v.append(fl(row[3 + 19 * k: 3 + 19 * (k + 1)]))
        week = int(v[18])
        if week < 1024:          # 2.11 files carry mod-1024 weeks
            week += 2048
        out[prn] = GpsEphemeris(
            prn=prn, week=week,
            toc=_toc_from_utc(hdr), af0=af0, af1=af1, af2=af2,
            iode=int(v[0]), crs=v[1], delta_n_sc=v[2] / np.pi,
            m0_sc=v[3] / np.pi,
            cuc=v[4], ecc=v[5], cus=v[6], sqrt_a=v[7],
            toe=v[8], cic=v[9], omega0_sc=v[10] / np.pi, cis=v[11],
            i0_sc=v[12] / np.pi, crc=v[13], omega_sc=v[14] / np.pi,
            omega_dot_sc=v[15] / np.pi, idot_sc=v[16] / np.pi,
            tgd=v[22], iodc=int(v[23]))
        i += 8
    return out


def _toc_from_utc(hdr: str) -> float:
    """RINEX 2 epoch 'yy mm dd hh mm ss.s' -> GPS seconds of week."""
    import datetime as _dt
    yy = int(hdr[3:5]); mo = int(hdr[6:8]); dd = int(hdr[9:11])
    hh = int(hdr[12:14]); mi = int(hdr[15:17]); ss = float(hdr[17:22])
    year = 2000 + yy if yy < 80 else 1900 + yy
    t = _dt.datetime(year, mo, dd, hh, mi, tzinfo=_dt.timezone.utc) \
        + _dt.timedelta(seconds=ss)
    # the 2.11 writer formats epochs with gps_time_to_utc(..., 0.0)
    # (GPS timescale, no leap offset) — invert with the same convention
    _, tow = utc_to_gps_time(t, leap_s=0.0)
    return tow


def write_pvt_xml(path, solutions, week: int) -> None:
    """PVT solutions as XML (rtklib_pvt.cc xml_output_enabled role —
    simple per-epoch records on the boost-XML shape used by the
    reference's serialization outputs)."""
    lines = ['<?xml version="1.0" encoding="UTF-8" standalone="yes" ?>',
             "<pvt_solutions>"]
    for s in solutions:
        t = gps_time_to_utc(week, s.rx_time_corrected_s, 0.0)
        lat_r, lon_r, h = geodesy.ecef_to_llh(s.rx_ecef_m)
        lat, lon = np.degrees(lat_r), np.degrees(lon_r)
        lines.append(
            f"\t<solution><time>{t.isoformat()}</time>"
            f"<lat>{lat:.9f}</lat><lon>{lon:.9f}</lon>"
            f"<height>{h:.3f}</height>"
            f"<x>{s.rx_ecef_m[0]:.3f}</x><y>{s.rx_ecef_m[1]:.3f}</y>"
            f"<z>{s.rx_ecef_m[2]:.3f}</z>"
            f"<clock_bias_s>{s.rx_clock_bias_s:.12e}</clock_bias_s>"
            f"<gdop>{s.gdop:.2f}</gdop><n_sats>{s.n_sats}</n_sats>"
            f"</solution>")
    lines.append("</pvt_solutions>")
    Path(path).write_text("\n".join(lines) + "\n")

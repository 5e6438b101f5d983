"""Shared test fixtures: cached static scenario capture."""

import os
import tempfile

import numpy as np

from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
from gnss_sim_receiver_tpu.sim import generate_baseband
from gnss_sim_receiver_tpu.sim.scenario import build_static_scenario
from gnss_sim_receiver_tpu.utils import geodesy

FS = 2_000_000.0
T0 = 345600.0
DUR = 26.0
RX_LLH = (40.0, -75.0, 100.0)
# v2: scenario carrier phase is now geometric (-2*pi*f_c*delay), required
# for integer DD ambiguities in the RTK end-to-end test
_CACHE = os.path.join(tempfile.gettempdir(),
                      "gnss_fixture_static_v2.npy")
ROVER_DUR = 20.0
# rover offset from the base position, east/north/up meters
ROVER_ENU = (6.0, 3.0, 0.5)


def rx_true_ecef():
    return geodesy.llh_to_ecef(np.radians(RX_LLH[0]), np.radians(RX_LLH[1]),
                               RX_LLH[2])


def rover_true_ecef():
    base = np.asarray(rx_true_ecef())
    up = base / np.linalg.norm(base)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    e, n, u = ROVER_ENU
    return base + e * east + n * north + u * up


def static_scenario_capture():
    """26 s, 6 satellites, GPS L1 C/A at 2 Msps, CN0 47 dB-Hz."""
    if os.path.exists(_CACHE):
        return np.load(_CACHE), rx_true_ecef()
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    sel = [e for e in ephs if e.prn in (1, 3, 4, 5, 9, 10)]
    sats = build_static_scenario(sel, rx_true_ecef(), T0, DUR,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(sats, FS, int(FS * DUR), noise=True, seed=42,
                          bandlimit_oversample=4)
    np.save(_CACHE, x)
    return x, rx_true_ecef()


# RTK pair: at 2 Msps / 47 dB-Hz the DLL code noise makes the DD code
# observable ~2 m (1-sigma) with ~0.5 s correlation — a 16 s static window
# cannot resolve 6 float ambiguities from that (single-frequency static
# RTK at that grade takes minutes).  The two-receiver integration test is
# about the measurement-convention contract, not code-noise sensitivity,
# so its pair runs at a strong 55 dB-Hz where the float converges within
# the capture.
RTK_CN0 = 55.0
RTK_BASE_DUR = 28.0     # subframes 1-3 complete by ~24 s worst case
_CACHE_RTK_BASE = os.path.join(tempfile.gettempdir(),
                      "gnss_fixture_rtk_base_v3.npy")
_CACHE_ROVER = os.path.join(tempfile.gettempdir(),
                      "gnss_fixture_rover_v3.npy")


def rtk_base_scenario_capture():
    """24 s base-station capture for the RTK end-to-end pair."""
    if os.path.exists(_CACHE_RTK_BASE):
        return np.load(_CACHE_RTK_BASE), rx_true_ecef()
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    sel = [e for e in ephs if e.prn in (1, 3, 4, 5, 9, 10)]
    sats = build_static_scenario(sel, rx_true_ecef(), T0, RTK_BASE_DUR,
                                 cn0_db_hz=RTK_CN0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(sats, FS, int(FS * RTK_BASE_DUR), noise=True,
                          seed=42, bandlimit_oversample=4)
    np.save(_CACHE_RTK_BASE, x)
    return x, rx_true_ecef()


CONTROL_DUR = 32.0
_CACHE_CONTROL = os.path.join(tempfile.gettempdir(),
                      "gnss_fixture_control_v1.npy")


def control_scenario_capture():
    """32 s capture for the live control-plane test (warm fix ->
    standby -> hotstart -> refix needs more signal than the 26 s static
    capture)."""
    if os.path.exists(_CACHE_CONTROL):
        return np.load(_CACHE_CONTROL), rx_true_ecef()
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    sel = [e for e in ephs if e.prn in (1, 3, 4, 5, 9, 10)]
    sats = build_static_scenario(sel, rx_true_ecef(), T0, CONTROL_DUR,
                                 cn0_db_hz=50.0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(sats, FS, int(FS * CONTROL_DUR), noise=True,
                          seed=11, bandlimit_oversample=4)
    np.save(_CACHE_CONTROL, x)
    return x, rx_true_ecef()


def scenario_ephemerides():
    """The broadcast ephemerides the fixture scenarios are built from
    (assistance-data source for warm/hot-start tests)."""
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    return {e.prn: e for e in ephs if e.prn in (1, 3, 4, 5, 9, 10)}


def rover_scenario_capture():
    """20 s capture of the same sky seen ~7 m from the base position (the
    RTK rover half of the two-receiver end-to-end test)."""
    rover = rover_true_ecef()
    if os.path.exists(_CACHE_ROVER):
        return np.load(_CACHE_ROVER), rover
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    sel = [e for e in ephs if e.prn in (1, 3, 4, 5, 9, 10)]
    sats = build_static_scenario(sel, rover, T0, ROVER_DUR,
                                 cn0_db_hz=RTK_CN0, subframe_cycle=(1, 2, 3))
    x = generate_baseband(sats, FS, int(FS * ROVER_DUR), noise=True,
                          seed=77, bandlimit_oversample=4)
    np.save(_CACHE_ROVER, x)
    return x, rover

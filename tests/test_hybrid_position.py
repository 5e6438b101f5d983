"""Hybrid GPS L1 + Galileo E1B end-to-end position system test.

The multi-constellation analogue of test_e2e_position (reference:
position_test.cc run with a hybrid GPS+Galileo conf, BASELINE config #3):
one capture carries 4 GPS satellites (LNAV) and 5 Galileo satellites
(INAV); the receiver runs a 1C chain and a 1B chain into one observables
engine and a joint PVT.  Also checks a Galileo-only fix (gps_chain=False).
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

from gnss_sim_receiver_tpu.models.control import ChannelState
from gnss_sim_receiver_tpu.models.receiver import (Receiver, ReceiverConf,
                                                   galileo_e1b_chain)
from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
from gnss_sim_receiver_tpu.sim import generate_baseband
from gnss_sim_receiver_tpu.sim.scenario import build_static_scenario
from gnss_sim_receiver_tpu.utils import geodesy
from tests.fixtures import RX_LLH, T0, rx_true_ecef

FS = 4_000_000.0
DUR = 26.0     # GPS needs a full (1,2,3) subframe cycle after lock: <= 24 s
GPS_PRNS = (1, 3, 4, 5)
GAL_PRNS = (11, 12, 13, 14, 15)
_CACHE = os.path.join(tempfile.gettempdir(),
                      "gnss_fixture_hybrid_v2.npy")


def _hybrid_ephemerides():
    base = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    gps = [e for e in base if e.prn in GPS_PRNS]
    gal = []
    toe60 = round((T0 + 600) / 60.0) * 60.0   # INAV toe LSB is 60 s
    for prn, e in zip(GAL_PRNS, (e for e in base if e.prn not in GPS_PRNS)):
        gal.append(dataclasses.replace(
            e, system="Galileo", prn=prn, toe=toe60, toc=toe60,
            iod_nav=137, bgd_e1e5b=0.0))
    return gps, gal


@pytest.fixture(scope="module")
def hybrid_capture():
    if os.path.exists(_CACHE):
        return np.load(_CACHE), rx_true_ecef()
    gps, gal = _hybrid_ephemerides()
    sats = build_static_scenario(gps + gal, rx_true_ecef(), T0, DUR,
                                 cn0_db_hz=48.0, subframe_cycle=(1, 2, 3))
    assert sorted(s.prn for s in sats if s.system == "GPS") \
        == sorted(GPS_PRNS)
    assert sorted(s.prn for s in sats if s.system == "Galileo") \
        == sorted(GAL_PRNS)
    x = generate_baseband(sats, FS, int(FS * DUR), noise=True, seed=17,
                          bandlimit_oversample=4)
    np.save(_CACHE, x)
    return x, rx_true_ecef()


def _enu_errors(run, rx_true):
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    return np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true, ref)
                     for s in run.solutions])


def test_hybrid_position_fix(hybrid_capture):
    x, rx_true = hybrid_capture
    conf = ReceiverConf(
        fs=FS, prns=GPS_PRNS, max_channels=4, max_acq_channels=4,
        chains=(galileo_e1b_chain(FS, prns=GAL_PRNS, n_channels=5),))
    run = Receiver(conf).process_array(x)

    # both chains track their satellites
    gps_trk = [p for p, s, sysn in zip(run.channel_prns, run.channel_states,
                                       run.channel_systems)
               if s == ChannelState.TRACKING and sysn == "GPS"]
    gal_trk = [p for p, s, sysn in zip(run.channel_prns, run.channel_states,
                                       run.channel_systems)
               if s == ChannelState.TRACKING and sysn == "Galileo"]
    assert sorted(gps_trk) == sorted(GPS_PRNS), run.channel_prns
    assert sorted(gal_trk) == sorted(GAL_PRNS), run.channel_prns

    # ephemerides decoded from both nav messages (GPS keys: int;
    # Galileo keys: ("Galileo", prn))
    assert all(p in run.ephemerides for p in GPS_PRNS)
    assert all(("Galileo", p) in run.ephemerides for p in GAL_PRNS)
    assert run.ephemerides[("Galileo", 11)].iod_nav == 137

    assert len(run.solutions) >= 5
    # joint fix uses satellites of both systems
    assert run.solutions[-1].n_sats >= 7
    enu = _enu_errors(run, rx_true)
    err_2d = np.linalg.norm(enu.mean(0)[:2])
    err_3d = np.linalg.norm(enu.mean(0))
    assert err_2d < 2.0, f"2D {err_2d:.2f} m"
    assert err_3d < 5.0, f"3D {err_3d:.2f} m"


def test_galileo_only_position_fix(hybrid_capture):
    x, rx_true = hybrid_capture
    conf = ReceiverConf(
        fs=FS, gps_chain=False,
        chains=(galileo_e1b_chain(FS, prns=GAL_PRNS, n_channels=5),))
    run = Receiver(conf).process_array(x)
    gal_trk = [p for p, s in zip(run.channel_prns, run.channel_states)
               if s == ChannelState.TRACKING]
    assert sorted(gal_trk) == sorted(GAL_PRNS), run.channel_prns
    assert len(run.solutions) >= 3
    assert run.solutions[-1].n_sats == 5
    enu = _enu_errors(run, rx_true)
    err_3d = np.linalg.norm(enu.mean(0))
    assert err_3d < 5.0, f"3D {err_3d:.2f} m"

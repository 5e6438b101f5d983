"""End-to-end static position system test.

Equivalent of the reference's system test position_test.cc: simulate a
static scenario from broadcast ephemerides, run the full receiver
(acquisition -> tracking -> LNAV -> observables -> PVT), and assert the
reference's accuracy thresholds
(src/tests/system-tests/libs/position_test_flags.h:31-34:
2D < 2 m, 3D < 5 m static for the mean position).

The 26 s capture (~200 MB equiv work) is cached in the temp directory,
keyed by scenario version, so repeated test runs skip synthesis.
"""

import numpy as np
import pytest

from gnss_sim_receiver_tpu.models.receiver import Receiver, ReceiverConf
from gnss_sim_receiver_tpu.utils import geodesy
from tests.fixtures import FS, RX_LLH, static_scenario_capture


@pytest.fixture(scope="module")
def scenario():
    return static_scenario_capture()


def test_static_position_accuracy(scenario):
    x, rx_true = scenario
    rx = Receiver(ReceiverConf(fs=FS, prns=tuple(range(1, 11)),
                               max_channels=8))
    run = rx.process_array(x)

    from gnss_sim_receiver_tpu.models.control import ChannelState
    tracked = [p for p, s in zip(run.channel_prns, run.channel_states)
               if s == ChannelState.TRACKING]
    assert sorted(tracked) == [1, 3, 4, 5, 9, 10], run.channel_prns
    assert len(run.ephemerides) >= 5, sorted(run.ephemerides)
    assert len(run.solutions) >= 5

    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true, ref)
                    for s in run.solutions])
    err_2d = np.linalg.norm(enu.mean(0)[:2])
    err_3d = np.linalg.norm(enu.mean(0))
    rms_3d = np.sqrt((np.linalg.norm(enu, axis=1) ** 2).mean())
    # reference static accuracy thresholds (position_test_flags.h:31-34)
    assert err_2d < 2.0, f"2D {err_2d:.2f} m"
    assert err_3d < 5.0, f"3D {err_3d:.2f} m"
    assert rms_3d < 10.0, f"3D rms {rms_3d:.2f} m"
    # static receiver: velocity near zero
    v = np.array([s.rx_vel_ecef_ms for s in run.solutions])
    assert np.linalg.norm(v.mean(0)) < 1.0
    # solver internals sane
    last = run.solutions[-1]
    assert last.n_sats >= 5
    assert np.sqrt((last.residuals_m ** 2).mean()) < 5.0
    assert last.gdop < 10.0
    # receiver clock bias is the -60 ms tick-rounding offset, not drifting
    clk = np.array([s.rx_clock_bias_s for s in run.solutions])
    assert np.all(np.abs(clk + 0.06) < 0.005)

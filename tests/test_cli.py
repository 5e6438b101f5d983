"""CLI + factory tests: a reference-style conf file drives the receiver
end-to-end through `python -m gnss_sim_receiver_tpu` (reference analogue:
gnss_block_factory_test.cc + running the binary)."""

import os
import textwrap

import numpy as np
import pytest

from gnss_sim_receiver_tpu.__main__ import main
from gnss_sim_receiver_tpu.models.factory import (receiver_conf_from_config,
                                                  source_from_config)
from gnss_sim_receiver_tpu.utils.config import FileConfiguration
from gnss_sim_receiver_tpu.utils.sample_io import write_samples
from tests.fixtures import static_scenario_capture

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

CONF = """\
GNSS-SDR.internal_fs_sps=2000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={filename}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=2000000
SignalConditioner.implementation=Signal_Conditioner
DataTypeAdapter.implementation=Ishort_To_Complex
InputFilter.implementation=Pass_Through
Resampler.implementation=Pass_Through
Channels_1C.count=8
Channel.signal=1C
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.coherent_integration_time_ms=1
Acquisition_1C.pfa=0.01
Acquisition_1C.doppler_max=5000
Acquisition_1C.doppler_step=250
Acquisition_1C.max_dwells=2
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Tracking_1C.pll_bw_hz=35.0
Tracking_1C.dll_bw_hz=2.0
TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.output_rate_ms=20
"""


def test_factory_parses_reference_conf():
    """The factory must accept a reference conf file's keys (upstream
    conf/gnss-sdr_GPS_L1_ishort.conf)."""
    conf = FileConfiguration(os.path.join(DATA,
                                          "gnss-sdr_GPS_L1_ishort.conf"))
    src = source_from_config(conf)
    assert src.item_type == "ishort"
    assert src.sampling_frequency == 4_000_000
    rc = receiver_conf_from_config(conf)
    assert rc.fs == 2_000_000
    assert rc.max_channels == 8
    assert rc.acq.doppler_max == 10_000
    assert rc.trk.pll_bw_hz == 40.0
    assert rc.trk.dll_bw_hz == 4.0
    assert rc.trk.pll_filter_order == 3


def test_cli_runs_receiver_from_conf(tmp_path, capsys):
    x, _ = static_scenario_capture()
    cap = tmp_path / "cap.ishort"
    write_samples(cap, x[: int(2e6 * 8)], "ishort", scale=200.0)
    conf = tmp_path / "rx.conf"
    conf.write_text(textwrap.dedent(CONF.format(filename=cap)))
    # 8 s: channels acquire + track, no ephemeris yet -> exit code 1
    rc = main([f"--config_file={conf}"])
    out = capsys.readouterr().out
    assert "Channels: PRNs" in out
    assert rc == 1
    # at least 5 of the 6 simulated satellites picked up
    line = [ln for ln in out.splitlines() if ln.startswith("Channels")][0]
    prns = [int(p) for p in line.split("[")[1].rstrip("]").split(",")]
    assert len([p for p in prns if p > 0]) >= 5


def test_factory_parses_hybrid_conf():
    """A reference hybrid GPS+Galileo conf yields a 1B signal chain
    (conf/gnss-sdr_Hybrid_byte.conf: Channels_1C=10, Channels_1B=10)."""
    conf = FileConfiguration(os.path.join(DATA, "gnss-sdr_Hybrid_byte.conf"))
    rc = receiver_conf_from_config(conf)
    assert rc.fs == 20_000_000
    assert rc.max_channels == 10 and rc.gps_chain
    assert len(rc.chains) == 1
    ch = rc.chains[0]
    assert ch.signal == "1B" and ch.system == "Galileo"
    assert ch.n_channels == 10
    assert ch.acq.doppler_step == 125.0
    assert ch.trk.pll_bw_hz == 15.0
    # 0.6 E1 chips -> 1.2 sub-chips
    assert ch.trk.very_early_late_space_chips == pytest.approx(1.2)
    # two chains -> 20 global channels in one receiver
    from gnss_sim_receiver_tpu.models.receiver import Receiver
    assert sum(c.n_channels for c in rc.all_chains()) == 20
    assert Receiver(rc) is not None


def test_factory_rejects_unknown_blocks(tmp_path):
    conf = tmp_path / "bad.conf"
    conf.write_text("Acquisition_1C.implementation=Exotic_Acq\n")
    with pytest.raises(NotImplementedError):
        receiver_conf_from_config(FileConfiguration(conf))


def test_write_outputs_config_driven(tmp_path):
    import numpy as np

    from gnss_sim_receiver_tpu.__main__ import _write_outputs
    from gnss_sim_receiver_tpu.models.control import ChannelState
    from gnss_sim_receiver_tpu.models.pvt import PvtSolution
    from gnss_sim_receiver_tpu.models.receiver import ReceiverRun
    from gnss_sim_receiver_tpu.utils import geodesy
    from gnss_sim_receiver_tpu.utils.config import InMemoryConfiguration

    rx = geodesy.llh_to_ecef(np.radians(40.0), np.radians(-75.0), 100.0)
    sol = PvtSolution(True, rx, 0.0, np.zeros(3), 0.0, 345625.0,
                      2.5, 2.0, 1.2, 1.6, 6, np.zeros(6))
    run = ReceiverRun(solutions=[sol, sol], observation_epochs=[],
                      channel_prns=[7], channel_states=[ChannelState.TRACKING],
                      ephemerides={}, events=[])
    c = InMemoryConfiguration()
    c.set_property("PVT.nmea_dump_filename", str(tmp_path / "o.nmea"))
    c.set_property("PVT.flag_kml", "true")
    c.set_property("PVT.kml_output_path", str(tmp_path / "o.kml"))
    c.set_property("PVT.flag_gpx", "true")
    c.set_property("PVT.gpx_output_path", str(tmp_path / "o.gpx"))
    c.set_property("PVT.flag_geojson", "true")
    c.set_property("PVT.geojson_output_path", str(tmp_path / "o.geojson"))
    _write_outputs(c, run)
    for name in ("o.nmea", "o.kml", "o.gpx", "o.geojson"):
        assert (tmp_path / name).exists(), name



def test_cli_runs_without_protobuf(tmp_path, capsys, monkeypatch):
    """With no Monitor.* keys the CLI path imports no protobuf: it runs
    with google.protobuf unimportable."""
    import sys
    for name in list(sys.modules):
        if name.startswith("google.protobuf") or name.endswith("_pb2"):
            monkeypatch.setitem(sys.modules, name, None)
        elif name.startswith("gnss_sim_receiver_tpu.monitor"):
            monkeypatch.delitem(sys.modules, name)   # import afresh
    monkeypatch.setitem(sys.modules, "google.protobuf", None)
    with pytest.raises(ImportError):
        import google.protobuf  # noqa: F401
    x, _ = static_scenario_capture()
    cap = tmp_path / "cap.ishort"
    write_samples(cap, x[: int(2e6 * 2)], "ishort", scale=200.0)
    conf = tmp_path / "rx.conf"
    conf.write_text(textwrap.dedent(CONF.format(filename=cap)))
    # 2 s: the whole CLI path runs; too short for a fix -> exit code 1
    rc = main([f"--config_file={conf}"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "Channels: PRNs" in out

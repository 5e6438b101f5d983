"""chip_smoke.py's phases at tiny sizes on the CPU (the same code and
checks the card runs at full width), and its refusal to run without a
GPU."""

import pytest

import bench
import chip_smoke

CARD = "cpu test"


@pytest.mark.parametrize("phase", ["fft", "kernels", "receiver", "cli"])
def test_phase_tiny(phase, capsys):
    if phase == "fft":
        chip_smoke.phase_fft(CARD, seconds=0.05, n_channels=3)
    elif phase == "kernels":
        chip_smoke.phase_kernels(CARD, n_channels=3, seconds=0.1, n_prns=3,
                                 fir_samples=40_000)
    elif phase == "receiver":
        out = chip_smoke.phase_receiver(CARD, duration_s=32.0, n_sats=6,
                                        n_channels=6)
        assert out["n_fix"] > 0 and out["err3d"] < 5.0
    else:
        out = chip_smoke.phase_cli(CARD, duration_s=28.0)
        assert out["rc"] == 0 and out["err3d"] < 5.0
    # every result line names the device it ran on
    assert any(ln.startswith(f"[{phase}]") and ln.endswith(f"({CARD})")
               for ln in capsys.readouterr().out.splitlines())


def test_smoke_check_raises():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check(False, "forced")


@pytest.mark.parametrize("entry", [chip_smoke.main, bench.main])
def test_refuses_without_gpu(entry, capsys):
    assert entry() != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs a GPU" in captured.err

"""Benchmark: tracking throughput, PCPS acquisition grids/s and the full
receiver chain on one GPU.

    python bench.py

Prints the device and the card's name and power limit, then ONE JSON
line:
  metric      — correlated Msamples/s (channels x fs x realtime factor) of
                the block tracking kernel at 12 channels, 2 Msps
  vs_baseline — against the reference CPU figure of ~1 channel tracked in
                real time at 2 Msps per core (BASELINE.md), i.e.
                baseline = 2 Msamples/s
Extra keys: the per-epoch scan and the block kernel at 12/48/192
channels, acquisition grids/s (41 Doppler bins x 2000 delays x 2 dwells,
12 PRNs) and the full chain's seconds of signal per wall second.

Every kernel time is the median of warm calls that end in
block_until_ready.  Exits non-zero without a GPU or when any part fails.
"""

import json
import sys
import time

import numpy as np


def _median_time(fn, reps: int) -> float:
    """Median wall time of `reps` warm calls of fn(), each ending in
    block_until_ready (the first call compiles and is not counted)."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _tracking_state(trk, n_channels):
    import jax.numpy as jnp
    return trk._init_state(n_channels)._replace(
        active=jnp.ones(n_channels, bool),
        carrier_doppler=jnp.linspace(-4000, 4000, n_channels
                                     ).astype(jnp.float32))


def _bench_tracking(fs, n_channels, n_epochs, x, reps=10):
    """Per-epoch scan (models.tracking.track_chunk)."""
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.models import tracking as trk
    from gnss_sim_receiver_tpu.ops import prn_codes

    conf = trk.TrackingConf(fs=fs)
    prns = [(i % 32) + 1 for i in range(n_channels)]
    codes = jnp.asarray(prn_codes.gps_l1_ca_code_table(prns))
    taps = jnp.asarray(np.array([+0.25, 0.0, -0.25], np.float32))
    state = _tracking_state(trk, n_channels)
    dt = _median_time(lambda: trk.track_chunk(conf, n_epochs, codes, taps,
                                              x, state), reps)
    realtime = n_epochs * conf.t_epoch_nominal_s / dt
    return realtime, n_channels * fs * realtime / 1e6


def _bench_tracking_blocks(fs, n_channels, n_blocks, e_block, x, reps=10):
    """Block tracking kernel (models.tracking_block), the steady-state
    path the receiver runs once channels settle."""
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.models import tracking as trk
    from gnss_sim_receiver_tpu.models import tracking_block as tb
    from gnss_sim_receiver_tpu.ops import prn_codes

    conf = trk.TrackingConf(fs=fs)
    prns = [(i % 32) + 1 for i in range(n_channels)]
    tables = np.stack([np.asarray(prn_codes.gps_l1_ca_code(p), np.float32)
                       for p in prns])
    codes_rep = tb.code_spectra(conf, tables)
    taps = jnp.asarray(np.array([+0.25, 0.0, -0.25], np.float32))
    state = _tracking_state(trk, n_channels)
    dt = _median_time(lambda: tb.track_chunk_blocks(
        conf, n_blocks, e_block, codes_rep, taps, x, state), reps)
    realtime = n_blocks * e_block * conf.t_epoch_nominal_s / dt
    return realtime, n_channels * fs * realtime / 1e6


def _bench_acquisition(fs, n_channels, x, reps=20):
    import jax.numpy as jnp

    from gnss_sim_receiver_tpu.ops import pcps, prn_codes

    fft = int(round(fs * 1e-3))
    sampled = np.stack([prn_codes.sample_code(prn_codes.gps_l1_ca_code(p),
                                              fs, 1.023e6, fft)
                        for p in range(1, n_channels + 1)])
    cfc = jnp.asarray(np.conj(np.fft.fft(sampled, axis=-1))
                      .astype(np.complex64))
    dops = jnp.asarray(pcps.doppler_grid(5000.0, 250.0))
    xd = x[: 2 * fft].reshape(2, fft)
    dt = _median_time(lambda: pcps.max_to_input_power_stat(
        pcps.pcps_grid(xd, cfc, dops, fs), jnp.float32(2.0)), reps)
    return n_channels / dt


def main() -> int:
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU; JAX's default backend is "
              f"{jax.default_backend()}", file=sys.stderr)
        return 1
    import chip_smoke
    from gnss_sim_receiver_tpu.models import tracking as trk

    dev = jax.devices()[0]
    card = chip_smoke.card_name_and_power()
    print(card, flush=True)

    fs = 2_000_000.0
    n_epochs = 1000          # 1 s of signal per timed call
    conf = trk.TrackingConf(fs=fs)
    rng = np.random.default_rng(0)
    chunk_len = conf.nominal_epoch_samples * (n_epochs + 2) + conf.block_size
    x = jnp.asarray((rng.standard_normal(chunk_len)
                     + 1j * rng.standard_normal(chunk_len)
                     ).astype(np.complex64))

    per_epoch = {}
    block_kernel = {}
    for c in (12, 48, 192):
        rt, ms = _bench_tracking(fs, c, n_epochs, x)
        per_epoch[f"{c}ch"] = {"realtime_factor": rt, "msamples_s": ms}
        # 1000 epochs = 50 blocks x 20
        rt, ms = _bench_tracking_blocks(fs, c, 50, 20, x)
        block_kernel[f"{c}ch"] = {"realtime_factor": rt, "msamples_s": ms}
    grids_s = _bench_acquisition(fs, 12, x)

    baseline_msamp_s = 2.0   # 1 channel x 2 Msps realtime per CPU core
    blk12 = block_kernel["12ch"]["msamples_s"]
    out = {
        "metric": "block-kernel correlated Msamples/s (12ch GPS L1 @2Msps)",
        "value": blk12,
        "unit": "Msamples/s",
        "vs_baseline": blk12 / baseline_msamp_s,
        "block_kernel": block_kernel,
        "per_epoch_scan": per_epoch,
        "acq_grids_per_s": grids_s,
        "acq_grid": "41x2000x2dwell",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }
    # full receiver chain: chip_smoke's receiver phase (12 satellites,
    # 12 channels, 2 Msps, 120 s, checked against truth), cold then warm
    rx = chip_smoke.phase_receiver(card)
    out["full_chain_realtime_factor"] = 120.0 / rx["walls"][1]
    out["full_chain"] = {"warm_wall_s": rx["walls"][1],
                         "cold_wall_s": rx["walls"][0],
                         "n_fixes": rx["n_fix"], "err_2d_m": rx["err2d"],
                         "err_3d_m": rx["err3d"],
                         "peak_bytes_in_use": rx["peak_bytes"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched PCPS acquisition engine.

Functional equivalent of the reference `pcps_acquisition` GNU Radio block +
per-constellation adapters (src/algorithms/acquisition/): given a block of
conditioned samples, searches ALL channels' (Doppler x code delay) grids in
one batched device program and returns per-channel detections.

Differences from the reference by design (batched on the device):
  - no worker thread / blocking modes: acquisition is one jitted call over
    a sample block shared by every searching channel;
  - the Doppler loop, channel loop, and dwell loop are array axes;
  - two-step refinement (make_2_steps, pcps_acquisition.cc:698-758) is a
    second jitted call on a narrow grid around the coarse hit.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sim_receiver_tpu import constants
from gnss_sim_receiver_tpu.ops import pcps, prn_codes


@dataclasses.dataclass
class AcqConf:
    """Reference Acq_Conf (acquisition/libs/acq_conf.h:33-81) subset."""
    fs_in: float = 2_000_000.0
    doppler_max: float = 5000.0
    doppler_step: float = 250.0
    doppler_center: float = 0.0
    sampled_ms: int = 1
    max_dwells: int = 1
    pfa: float = 0.01
    threshold: float = 0.0          # used when pfa <= 0
    use_cfar_algorithm: bool = True
    make_two_steps: bool = False
    doppler_step2: float = 125.0
    num_doppler_bins_step2: int = 4
    # double the FFT so one full clean code period always exists even when
    # a nav-symbol edge falls inside the dwell (pcps_acquisition.cc:607,656;
    # use with CFAR — the peak repeats at delay+N and defeats the
    # first-vs-second-peak statistic)
    bit_transition_flag: bool = False
    # engine variant: "pcps" (plain), "fine_doppler" (iterative Doppler
    # zoom, pcps_acquisition_fine_doppler_cc), "tong" (Tong sequential
    # detector, pcps_tong_acquisition_cc), "quicksync" (folded FFT),
    # "cccwsr" (coherent data+pilot sign recovery,
    # pcps_cccwsr_acquisition_cc), "8ms" (two-period sign-tolerant
    # coherent, galileo_pcps_8ms_acquisition_cc), "iq_caf" (E5a
    # noncoherent I/Q with CAF Doppler smoothing,
    # galileo_e5a_noncoherent_iq_acquisition_caf_cc)
    variant: str = "pcps"
    caf_bins: int = 0                # iq_caf: Doppler boxcar half-width
    fine_doppler_iters: int = 3      # zoom iterations (step /4 each)
    quicksync_fold: int = 4          # QuickSync folding factor
    tong_init: int = 1               # Tong counter init (tong_init_val)
    tong_max: int = 2                # declare at this count (tong_max_val)
    tong_max_dwells: int = 10        # dismissal dwell cap (tong_max_dwells)


@partial(jax.jit, static_argnames=("fs", "use_cfar", "spc",
                                   "two_steps", "n_side", "step2"))
def _acquire_fused(x_dwells, code_fft_conj, dopplers,
                   fs, use_cfar, spc, two_steps, n_side, step2):
    """Whole PCPS search in ONE dispatch and ONE packed pull: coarse grid +
    detection statistic + optional step-two narrow-grid Doppler refinement
    (pcps_acquisition.cc:698-758 make_2_steps) — returns a [4, C] float32
    buffer (stat, doppler_hz, delay_idx, stat2).  Host captures are
    sliced host-side and uploaded; device-resident captures go through
    _acquire_fused_dev."""
    m = x_dwells.shape[0]
    x = x_dwells.astype(jnp.complex64)
    grid = pcps.pcps_grid(x, code_fft_conj, dopplers, fs)
    if use_cfar:
        stat, dop_idx, del_idx = pcps.max_to_input_power_stat(
            grid, jnp.float32(m))
    else:
        stat, dop_idx, del_idx = pcps.first_vs_second_peak_stat(grid, spc)
    dop_hz = dopplers[dop_idx]
    stat2 = jnp.zeros_like(stat)
    if two_steps:
        offs = ((jnp.arange(2 * n_side + 1) - n_side)
                * jnp.float32(step2))
        dops2 = dop_hz[:, None] + offs[None, :]
        grid2 = pcps.pcps_grid_per_channel(x, code_fft_conj, dops2, fs)
        stat2, dop2_idx, _ = pcps.max_to_input_power_stat(
            grid2, jnp.float32(m))
        dop_hz = jnp.take_along_axis(dops2, dop2_idx[:, None], axis=1)[:, 0]
    return jnp.stack([stat.astype(jnp.float32), dop_hz.astype(jnp.float32),
                      del_idx.astype(jnp.float32),
                      stat2.astype(jnp.float32)])


@partial(jax.jit, static_argnames=("need", "m", "fs", "use_cfar", "spc",
                                   "two_steps", "n_side", "step2"))
def _acquire_fused_dev(x2d, row, code_fft_conj, dopplers,
                       need, m, fs, use_cfar, spc, two_steps, n_side,
                       step2):
    """_acquire_fused for a DEVICE-RESIDENT capture: the dwell window is
    cut out of a [W, G] row view of the capture with a traced row index
    (dynamic_slice over two adjacent rows), so every acquisition at any
    cursor reuses ONE compiled program — eager per-cursor slicing would
    compile a fresh tiny executable per distinct start index."""
    win = jax.lax.dynamic_slice_in_dim(x2d, row, 2, axis=0).reshape(-1)
    x_dwells = win[:need].reshape(m, need // m)
    return _acquire_fused(x_dwells, code_fft_conj, dopplers,
                          fs=fs, use_cfar=use_cfar, spc=spc,
                          two_steps=two_steps, n_side=n_side, step2=step2)


def _dwell_view(x, m: int, n: int):
    """[m, n] complex64 dwell view of x: a device array is sliced/reshaped
    on-device (no host round-trip); host arrays are uploaded once."""
    if isinstance(x, jnp.ndarray):
        return x[: m * n].reshape(m, n).astype(jnp.complex64)
    return jnp.asarray(
        np.asarray(x[: m * n], dtype=np.complex64).reshape(m, n))


@dataclasses.dataclass
class AcqResults:
    """Per-channel acquisition outcome (fills the Gnss_Synchro Acq_* fields,
    gnss_synchro.h 'Acquisition' block)."""
    detected: np.ndarray            # [C] bool
    test_stat: np.ndarray           # [C] float
    delay_samples: np.ndarray       # [C] float
    doppler_hz: np.ndarray          # [C] float
    threshold: float
    samplestamp: int                # sample index of block start


class PcpsAcquisitionEngine:
    """Batched PCPS acquisition over a fixed PRN set.  Signal-agnostic:
    pass code_provider(prn) -> +-1 sub-chip table and sc_rate for non-GPS
    signals (e.g. Galileo E1 BOC sub-chip tables); defaults to GPS L1
    C/A."""

    def __init__(self, conf: AcqConf, prns, code_provider=None,
                 sc_rate: float | None = None, code_provider2=None):
        self.conf = conf
        self.prns = list(int(p) for p in prns)
        fs = conf.fs_in
        code_provider = code_provider or prn_codes.gps_l1_ca_code
        sc_rate = sc_rate or constants.GPS_L1_CA_CODE_RATE_CPS
        self.n_coherent = int(round(fs * 1e-3 * conf.sampled_ms))
        self.fft_size = (2 * self.n_coherent if conf.bit_transition_flag
                         else self.n_coherent)
        self.samples_per_chip = max(1, int(round(fs / sc_rate)))
        # local replica FFTs (adapter-side precompute in the reference);
        # bit-transition mode: one code period + zero padding, so each lag
        # correlates N samples out of the 2N buffer
        codes = np.stack([
            prn_codes.sample_code(np.asarray(code_provider(p), np.float32),
                                  fs, sc_rate, self.n_coherent)
            for p in self.prns])
        self._codes_host = codes      # time domain (quicksync path)
        if conf.bit_transition_flag:
            codes = np.concatenate(
                [codes, np.zeros_like(codes)], axis=-1)
        self.code_fft_conj = jnp.asarray(
            np.conj(np.fft.fft(codes, axis=-1)).astype(np.complex64))
        # second replica set: the CCCWSR (data+pilot) and E5a I/Q
        # variants correlate against two code families per satellite
        self.code2_fft_conj = None
        if code_provider2 is not None and conf.variant in ("cccwsr",
                                                           "iq_caf"):
            codes2 = np.stack([
                prn_codes.sample_code(
                    np.asarray(code_provider2(p), np.float32),
                    fs, sc_rate, self.n_coherent)
                for p in self.prns])
            if conf.bit_transition_flag:
                codes2 = np.concatenate(
                    [codes2, np.zeros_like(codes2)], axis=-1)
            self.code2_fft_conj = jnp.asarray(
                np.conj(np.fft.fft(codes2, axis=-1)).astype(np.complex64))
        self.dopplers = jnp.asarray(pcps.doppler_grid(
            conf.doppler_max, conf.doppler_step, conf.doppler_center))
        n_cells = self.fft_size * len(self.dopplers)
        self.threshold = (pcps.cfar_threshold(conf.pfa, n_cells,
                                              conf.max_dwells)
                          if conf.pfa > 0 else conf.threshold)

    @property
    def n_samples_needed(self) -> int:
        if self.conf.variant == "tong":
            return self.fft_size * self.conf.tong_max_dwells
        if self.conf.variant == "8ms":
            return 2 * self.fft_size * self.conf.max_dwells
        return self.fft_size * self.conf.max_dwells

    def acquire(self, x: np.ndarray, samplestamp: int = 0) -> AcqResults:
        """Search every channel's grid over `x` (>= n_samples_needed
        samples)."""
        if self.conf.variant == "tong":
            return self._acquire_tong(x, samplestamp)
        if self.conf.variant == "quicksync":
            return self._acquire_quicksync(x, samplestamp)
        if self.conf.variant in ("cccwsr", "8ms", "iq_caf"):
            return self._acquire_dual(x, samplestamp)
        m = self.conf.max_dwells
        n = self.fft_size
        if len(x) < m * n:
            raise ValueError(f"need {m * n} samples, got {len(x)}")
        x_dwells = _dwell_view(x, m, n)
        stat, del_idx, doppler_hz = self._coarse(x_dwells)
        # the refinement passes compute the max-to-input-power statistic;
        # only fold them into the detection statistic when the coarse pass
        # used the same (CFAR) statistic — with the first-vs-second-peak
        # statistic the refinement updates Doppler only (comparing the two
        # incomparable statistics against one threshold flips detections)
        if self.conf.variant == "fine_doppler":
            doppler_hz, stat2 = self._fine_doppler(x_dwells, doppler_hz)
            if self.conf.use_cfar_algorithm:
                stat = np.maximum(stat, stat2)
        elif self.conf.make_two_steps:
            doppler_hz, stat2 = self._refine(x_dwells, doppler_hz)
            if self.conf.use_cfar_algorithm:
                stat = np.maximum(stat, stat2)
        delay = np.asarray(del_idx, dtype=np.float64)
        if self.conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)   # peak repeats at +N
        return AcqResults(
            detected=stat > self.threshold,
            test_stat=stat,
            delay_samples=delay,
            doppler_hz=doppler_hz.astype(np.float64),
            threshold=self.threshold,
            samplestamp=int(samplestamp),
        )

    def acquire_from(self, x_host, start: int) -> AcqResults:
        """Acquisition over capture window [start, start+n_samples_needed)
        of the full capture: the coarse grid + two-step refinement run in
        one fused dispatch with one packed device->host pull.  A host
        capture has its window sliced host-side and uploaded; a
        device-resident capture is windowed ON DEVICE with a traced row
        index (_acquire_fused_dev), so no per-cursor programs compile.
        Falls back to `acquire` for the tong / fine_doppler variants."""
        if self.conf.variant != "pcps":
            return self.acquire(x_host[start:start + self.n_samples_needed],
                                samplestamp=start)
        conf = self.conf
        m, n = conf.max_dwells, self.fft_size
        if isinstance(x_host, jnp.ndarray):
            return self._acquire_from_device(x_host, start)
        x_dwells = _dwell_view(x_host[start:start + m * n], m, n)
        buf = np.asarray(_acquire_fused(
            x_dwells, self.code_fft_conj, self.dopplers,
            fs=float(conf.fs_in),
            use_cfar=bool(conf.use_cfar_algorithm),
            spc=self.samples_per_chip,
            two_steps=bool(conf.make_two_steps),
            n_side=int(conf.num_doppler_bins_step2),
            step2=float(conf.doppler_step2)))
        return self._finish_fused(buf, int(start))

    def _acquire_from_device(self, x, start: int) -> AcqResults:
        conf = self.conf
        m = conf.max_dwells
        need = m * self.fft_size
        g = -(-need // 128) * 128
        cache = getattr(self, "_dev_cache", None)
        if cache is None or cache[0] is not x:
            w = len(x) // g
            if w < 2:
                raise ValueError("device capture shorter than one "
                                 "acquisition window pair")
            self._dev_cache = (x, x[: w * g].reshape(w, g), w)
        _, x2d, w = self._dev_cache
        row = min(max(int(start) // g, 0), w - 2)
        buf = np.asarray(_acquire_fused_dev(
            x2d, jnp.int32(row), self.code_fft_conj, self.dopplers,
            need=need, m=m, fs=float(conf.fs_in),
            use_cfar=bool(conf.use_cfar_algorithm),
            spc=self.samples_per_chip,
            two_steps=bool(conf.make_two_steps),
            n_side=int(conf.num_doppler_bins_step2),
            step2=float(conf.doppler_step2)))
        return self._finish_fused(buf, row * g)

    def _finish_fused(self, buf: np.ndarray, samplestamp: int) -> AcqResults:
        conf = self.conf
        # fold the step-two (max-to-input-power) statistic in only when the
        # coarse statistic is the same CFAR one — see acquire()
        if conf.use_cfar_algorithm:
            stat = np.maximum(buf[0], buf[3]).astype(np.float64)
        else:
            stat = buf[0].astype(np.float64)
        delay = buf[2].astype(np.float64)
        if conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)
        return AcqResults(
            detected=stat > self.threshold, test_stat=stat,
            delay_samples=delay, doppler_hz=buf[1].astype(np.float64),
            threshold=self.threshold, samplestamp=int(samplestamp))

    def _coarse(self, x_dwells):
        grid = pcps.pcps_grid(x_dwells, self.code_fft_conj, self.dopplers,
                              float(self.conf.fs_in))
        return self._stat_pack(grid, x_dwells.shape[0])

    def _stat_pack(self, grid, n_dwells):
        """Detection statistic + peak cell from a [C, D, N] grid, pulled
        in one packed device->host transfer."""
        if self.conf.use_cfar_algorithm:
            stat, dop_idx, del_idx = pcps.max_to_input_power_stat(
                grid, jnp.float32(n_dwells))
        else:
            stat, dop_idx, del_idx = pcps.first_vs_second_peak_stat(
                grid, self.samples_per_chip)
        buf = np.asarray(jnp.stack([stat.astype(jnp.float32),
                                    dop_idx.astype(jnp.float32),
                                    del_idx.astype(jnp.float32)]))
        stat = buf[0].astype(np.float64)
        del_idx = buf[2].astype(np.int64)
        doppler_hz = np.asarray(self.dopplers)[buf[1].astype(np.int64)]
        return stat, del_idx, doppler_hz

    def _acquire_dual(self, x: np.ndarray, samplestamp: int) -> AcqResults:
        """cccwsr / 8ms / iq_caf variant grids (two replica families or
        two coherent periods), same statistic + threshold machinery as
        the base engine."""
        conf = self.conf
        m = conf.max_dwells
        n = self.fft_size * (2 if conf.variant == "8ms" else 1)
        if len(x) < m * n:
            raise ValueError(f"need {m * n} samples, got {len(x)}")
        x_dwells = _dwell_view(x, m, n)
        fs = float(conf.fs_in)
        if conf.variant == "8ms":
            grid = pcps.pcps_8ms_grid(x_dwells, self.code_fft_conj,
                                      self.dopplers, fs)
            # two coherent periods per dwell: the CFAR reference uses
            # the per-correlation count
            n_eff = 2 * m
        elif conf.variant == "cccwsr":
            data_fft = (self.code2_fft_conj
                        if self.code2_fft_conj is not None
                        else self.code_fft_conj)
            grid = pcps.pcps_cccwsr_grid(x_dwells, data_fft,
                                         self.code_fft_conj,
                                         self.dopplers, fs)
            n_eff = 2 * m
        else:                                   # iq_caf
            q_fft = (self.code2_fft_conj
                     if self.code2_fft_conj is not None
                     else self.code_fft_conj)
            grid = pcps.pcps_e5a_noncoherent_iq_grid(
                x_dwells, self.code_fft_conj, q_fft, self.dopplers, fs,
                caf_bins=int(conf.caf_bins))
            n_eff = 2 * m
        stat, del_idx, doppler_hz = self._stat_pack(grid, n_eff)
        delay = np.asarray(del_idx, dtype=np.float64)
        if conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)
        if conf.variant == "8ms":
            delay = np.mod(delay, self.n_coherent)
        # variant-aware CFAR: every cell sums TWO correlations (dof 4m);
        # the sign-recovery variants take a max over two hypotheses per
        # cell — union-bound the per-cell Pfa at pfa/2
        if conf.pfa > 0:
            n_cells = grid.shape[-1] * len(self.dopplers)
            pfa_c = conf.pfa / (2.0 if conf.variant in ("cccwsr", "8ms")
                                else 1.0)
            threshold = pcps.cfar_threshold(pfa_c, n_cells, n_eff)
        else:
            threshold = conf.threshold
        return AcqResults(
            detected=stat > threshold,
            test_stat=stat,
            delay_samples=delay,
            doppler_hz=doppler_hz.astype(np.float64),
            threshold=threshold,
            samplestamp=int(samplestamp),
        )

    def _narrow_grid_step(self, x_dwells, centers_hz, step_hz, n_side):
        """One batched narrow-grid pass: every channel searches its own
        (2*n_side+1)-bin Doppler set centered on centers_hz — one device
        dispatch for all channels (pcps_grid_per_channel)."""
        dop, stat, _ = self._narrow_grid_full(x_dwells, centers_hz,
                                              step_hz, n_side)
        return dop, stat

    def _narrow_grid_full(self, x_dwells, centers_hz, step_hz, n_side):
        """_narrow_grid_step + the winning code-delay index."""
        offsets = ((np.arange(2 * n_side + 1) - n_side) * step_hz)
        dops = (np.asarray(centers_hz, np.float64)[:, None]
                + offsets[None, :]).astype(np.float32)
        grid = pcps.pcps_grid_per_channel(
            x_dwells, self.code_fft_conj, jnp.asarray(dops),
            float(self.conf.fs_in))
        stat, dop_idx, del_idx = pcps.max_to_input_power_stat(
            grid, jnp.float32(x_dwells.shape[0]))
        buf = np.asarray(jnp.stack([stat.astype(jnp.float32),
                                    dop_idx.astype(jnp.float32),
                                    del_idx.astype(jnp.float32)]))
        dop_idx = buf[1].astype(np.int64)
        best = np.take_along_axis(dops, dop_idx[:, None], axis=1)[:, 0]
        return (best.astype(np.float64), buf[0].astype(np.float64),
                buf[2].astype(np.float64))

    def acquire_assisted(self, x, start: int, centers_hz,
                         span_hz: float = 250.0,
                         step_hz: float = 62.5) -> AcqResults:
        """Doppler-ASSISTED acquisition: each channel searches only a
        +-span_hz grid around its own predicted Doppler (primary-band
        lock scaled by the carrier ratio) in ONE dwell — the secondary-
        band assisted search of the reference flowgraph (project_doppler,
        gnss_flowgraph.cc:1774-1795 + the assisted acq dispatch
        :2615-2750)."""
        conf = self.conf
        m, n = conf.max_dwells, self.fft_size
        x_win = x[start:start + m * n]
        x_dwells = _dwell_view(x_win, m, n)
        n_side = max(1, int(round(span_hz / step_hz)))
        dop, stat, delay = self._narrow_grid_full(
            x_dwells, np.asarray(centers_hz, np.float64), step_hz, n_side)
        n_cells = self.fft_size * (2 * n_side + 1)
        thr = (pcps.cfar_threshold(conf.pfa, n_cells, conf.max_dwells)
               if conf.pfa > 0 else conf.threshold)
        if conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)
        return AcqResults(
            detected=stat > thr, test_stat=stat, delay_samples=delay,
            doppler_hz=dop, threshold=thr, samplestamp=int(start))

    def _refine(self, x_dwells, coarse_doppler_hz):
        """Step-two narrow-grid Doppler refinement around each channel's
        coarse hit (pcps_acquisition.cc:698-758, make_2_steps)."""
        conf = self.conf
        return self._narrow_grid_step(x_dwells, coarse_doppler_hz,
                                      conf.doppler_step2,
                                      conf.num_doppler_bins_step2)

    def _fine_doppler(self, x_dwells, coarse_doppler_hz):
        """Iterative Doppler zoom: re-grid around the current estimate with
        the step shrinking /4 per iteration — the role of the reference's
        pcps_acquisition_fine_doppler_cc estimate_Doppler refinement, done
        as batched narrow grids instead of a per-channel FFT interpolator."""
        step = self.conf.doppler_step / 2.0
        dop = np.asarray(coarse_doppler_hz, np.float64)
        stat = np.zeros(len(self.prns))
        for _ in range(max(self.conf.fine_doppler_iters, 1)):
            dop, stat = self._narrow_grid_step(x_dwells, dop, step, 4)
            step /= 4.0
        return dop, stat

    def _acquire_quicksync(self, x: np.ndarray, samplestamp: int) \
            -> AcqResults:
        """QuickSync folded search (pcps_quicksync_acquisition_cc role):
        detect on the N/fold grid (fold x smaller FFT), then resolve the
        fold ambiguity with `fold` full-length correlations at the
        detected (Doppler, folded-lag)."""
        import jax.numpy as jnp

        m = self.conf.max_dwells
        n = self.n_coherent          # no bit-transition mode here
        if len(x) < m * n:
            raise ValueError(f"need {m * n} samples, got {len(x)}")
        fold = int(self.conf.quicksync_fold)
        x_dwells = jnp.asarray(np.ascontiguousarray(
            x[: m * n]).reshape(m, n).astype(np.complex64))
        if not hasattr(self, "_codes_time"):
            self._codes_time = jnp.asarray(self._codes_host)
        g = pcps.pcps_quicksync_grid(
            x_dwells, self._codes_time, self.dopplers, self.conf.fs_in,
            fold)                                        # [C, D, N/fold]
        stat_j, dop_idx_j, lag_j = pcps.max_to_input_power_stat(
            g, jnp.float32(m))
        buf = np.asarray(jnp.stack([stat_j.astype(jnp.float32),
                                    dop_idx_j.astype(jnp.float32),
                                    lag_j.astype(jnp.float32)]))
        stat = buf[0].astype(np.float64)
        dops = np.asarray(self.dopplers)[
            buf[1].astype(np.int64)].astype(np.float64)
        lag_f = buf[2].astype(np.int64)
        delays, _ = pcps.quicksync_resolve(
            x_dwells[0], self._codes_time,
            jnp.asarray(dops.astype(np.float32)),
            jnp.asarray(lag_f.astype(np.int32)), self.conf.fs_in,
            fold=fold)
        # same Gamma-inverse threshold family as the full grid, sized
        # for the folded cell count
        thr = pcps.cfar_threshold(self.conf.pfa,
                                  (n // fold) * len(self.dopplers), m) \
            if self.conf.pfa > 0 else self.conf.threshold
        return AcqResults(
            detected=stat > thr,
            test_stat=stat,
            delay_samples=np.asarray(delays, np.float64) % n,
            doppler_hz=dops,
            threshold=thr,
            samplestamp=int(samplestamp),
        )

    def _acquire_tong(self, x: np.ndarray, samplestamp: int) -> AcqResults:
        """Tong sequential detector (pcps_tong_acquisition_cc): per-channel
        counter K starts at tong_init; each dwell above threshold K += 1,
        below K -= 1; detection at K == tong_max, dismissal at K == 0 or
        after tong_max_dwells dwells.  Dwells are successive sample blocks;
        each dwell's grids for all channels run in one batched dispatch."""
        conf = self.conf
        n = self.fft_size
        c = len(self.prns)
        k_counter = np.full(c, conf.tong_init, np.int32)
        alive = np.ones(c, bool)
        detected = np.zeros(c, bool)
        best = dict(stat=np.zeros(c), delay=np.zeros(c), dop=np.zeros(c))
        n_dwells = min(conf.tong_max_dwells, len(x) // n)
        for d in range(n_dwells):
            if not alive.any():
                break
            x_dwell = _dwell_view(x[d * n: (d + 1) * n], 1, n)
            stat, del_idx, dop = self._coarse(x_dwell)
            up = stat > self.threshold
            k_counter = np.where(alive & up, k_counter + 1,
                                 np.where(alive, k_counter - 1, k_counter))
            better = alive & (stat > best["stat"])
            best["stat"] = np.where(better, stat, best["stat"])
            best["delay"] = np.where(better, del_idx, best["delay"])
            best["dop"] = np.where(better, dop, best["dop"])
            newly = alive & (k_counter >= conf.tong_max)
            detected |= newly
            alive &= ~newly & (k_counter > 0)
        delay = best["delay"].astype(np.float64)
        if conf.bit_transition_flag:
            delay = np.mod(delay, self.n_coherent)
        return AcqResults(
            detected=detected, test_stat=best["stat"],
            delay_samples=delay, doppler_hz=best["dop"].astype(np.float64),
            threshold=self.threshold, samplestamp=int(samplestamp))

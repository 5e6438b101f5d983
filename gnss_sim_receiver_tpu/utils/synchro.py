"""The inter-stage data model.

Batched equivalent of the reference's ``Gnss_Synchro`` record
(src/core/system_parameters/gnss_synchro.h:38-238).  Where the reference
passes one struct per channel per integration period through GNU Radio ring
buffers, we carry a *batch*: a struct-of-arrays over ``[..., n_channels]``
(and usually a leading epoch/time axis) that flows between the batched
receiver stages as a pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda s: ([getattr(s, f) for f in fields], None),
        lambda _, c: cls(*c),
    )
    return cls


@_pytree_dataclass
class SynchroBatch:
    """Batched Gnss_Synchro: each field is an array whose trailing axis is
    the channel axis (leading axes may be epochs).

    Field names follow gnss_synchro.h:38-238 (snake_case), restricted to the
    fields consumed downstream (telemetry -> observables -> PVT) plus the
    acquisition/tracking handoff fields.
    """

    # satellite / signal identity
    prn: Any                       # int32
    # acquisition outputs (gnss_synchro.h "Acquisition" block)
    acq_delay_samples: Any         # float32
    acq_doppler_hz: Any            # float32
    acq_samplestamp_samples: Any   # int64 (host) / int32 (device, chunk-rel)
    # tracking outputs (one row per integration period)
    fs: Any                        # float64 sampling rate [Hz]
    prompt_i: Any                  # float32
    prompt_q: Any                  # float32
    cn0_db_hz: Any                 # float32
    carrier_doppler_hz: Any        # float32
    carrier_phase_rads: Any        # float64 accumulated carrier phase
    code_phase_samples: Any        # float64 remnant code phase at epoch start
    tracking_sample_counter: Any   # int64 absolute sample index at epoch end
    flag_valid_symbol: Any         # bool
    # telemetry outputs
    tow_at_current_symbol_ms: Any  # float64
    flag_valid_word: Any           # bool
    # observables outputs
    pseudorange_m: Any             # float64
    rx_time_s: Any                 # float64
    flag_valid_pseudorange: Any    # bool
    interp_tow_ms: Any             # float64

    @classmethod
    def zeros(cls, n_channels: int) -> "SynchroBatch":
        f32 = lambda: np.zeros(n_channels, np.float32)
        f64 = lambda: np.zeros(n_channels, np.float64)
        return cls(
            prn=np.zeros(n_channels, np.int32),
            acq_delay_samples=f32(),
            acq_doppler_hz=f32(),
            acq_samplestamp_samples=np.zeros(n_channels, np.int64),
            fs=f64(),
            prompt_i=f32(),
            prompt_q=f32(),
            cn0_db_hz=f32(),
            carrier_doppler_hz=f32(),
            carrier_phase_rads=f64(),
            code_phase_samples=f64(),
            tracking_sample_counter=np.zeros(n_channels, np.int64),
            flag_valid_symbol=np.zeros(n_channels, bool),
            tow_at_current_symbol_ms=f64(),
            flag_valid_word=np.zeros(n_channels, bool),
            pseudorange_m=f64(),
            rx_time_s=f64(),
            flag_valid_pseudorange=np.zeros(n_channels, bool),
            interp_tow_ms=f64(),
        )

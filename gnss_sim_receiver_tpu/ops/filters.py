"""Input-filter kernels: FIR, frequency-translating decimating FIR, IIR
notch, pulse blanking.

Batched XLA equivalents of the reference input_filter stage
(src/algorithms/input_filter/adapters/: Fir_Filter,
Freq_Xlating_Fir_Filter, Notch_Filter, Notch_Filter_Lite,
Pulse_Blanking_Filter).  Convolutions run as
lax.conv_general_dilated; the IIR notch carries its recursion through
lax.scan (blockwise, so XLA sees a static loop).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def design_lowpass(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Host-side FIR design (windowed sinc), the role of the reference's
    gr::filter::firdes usage.  cutoff_norm in (0, 1), 1 = Nyquist."""
    from scipy import signal as sps
    return sps.firwin(num_taps, cutoff_norm).astype(np.float32)


@partial(jax.jit, static_argnames=("decimation",))
def fir_filter(x: jax.Array, taps: jax.Array, decimation: int = 1):
    """Decimating FIR on a complex stream ('same' alignment: output k is
    the filter centered at input k*decimation)."""
    t = taps.astype(jnp.float32)
    n_taps = t.shape[0]
    pad = n_taps // 2
    xr = jnp.pad(jnp.real(x), (pad, n_taps - 1 - pad))
    xi = jnp.pad(jnp.imag(x), (pad, n_taps - 1 - pad))

    def conv1d(v):
        return jax.lax.conv_general_dilated(
            v[None, None, :], t[::-1][None, None, :],
            window_strides=(decimation,), padding="VALID")[0, 0]
    return jax.lax.complex(conv1d(xr), conv1d(xi))


@partial(jax.jit, static_argnames=("decimation", "fs"))
def freq_xlating_fir_filter(x: jax.Array, taps: jax.Array,
                            center_freq_hz: float, fs: float,
                            decimation: int = 1):
    """Down-convert by center_freq then low-pass + decimate — the
    reference's workhorse conditioner (Freq_Xlating_Fir_Filter)."""
    n = jnp.arange(x.shape[0], dtype=jnp.float32)
    ph = -2.0 * jnp.pi * jnp.float32(center_freq_hz / fs) * n
    lo = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    return fir_filter(x * lo, taps, decimation)


@jax.jit
def notch_filter(x: jax.Array, f0_norm: jax.Array, bw_norm: jax.Array):
    """Second-order IIR notch at normalized frequency f0 (of fs), -3 dB
    width bw — the role of Notch_Filter_Lite for CW interference.
    y[n] = x[n] - 2cos(w0) x[n-1] + x[n-2] + 2r cos(w0) y[n-1] - r^2 y[n-2]
    with r = 1 - pi*bw."""
    w0 = 2.0 * jnp.pi * f0_norm
    r = 1.0 - jnp.pi * bw_norm
    b1 = -2.0 * jnp.cos(w0)
    a1 = 2.0 * r * jnp.cos(w0)
    a2 = -(r * r)

    def step(carry, xn):
        x1, x2, y1, y2 = carry
        yn = xn + b1 * x1 + x2 + a1 * y1 + a2 * y2
        return (xn, x1, yn, y1), yn

    z = jnp.zeros((), x.dtype)
    _, y = jax.lax.scan(step, (z, z, z, z), x)
    # normalize passband gain (evaluated at DC-opposite side is ~1 anyway)
    g = (1.0 + b1 + 1.0) / (1.0 - a1 - a2)
    return y / g


@partial(jax.jit, static_argnames=("window",))
def pulse_blanking(x: jax.Array, threshold_sigmas: float = 4.0,
                   window: int = 64):
    """Zero out samples whose windowed power exceeds
    threshold_sigmas^2 x the stream's median window power (the reference
    Pulse_Blanking_Filter excises pulsed interference)."""
    p = jnp.real(x) ** 2 + jnp.imag(x) ** 2
    n = p.shape[0] - p.shape[0] % window
    pw = p[:n].reshape(-1, window).mean(axis=1)
    ref = jnp.median(pw)
    keep = (pw <= threshold_sigmas ** 2 * ref)
    keep_full = jnp.repeat(keep, window, total_repeat_length=n)
    keep_full = jnp.concatenate(
        [keep_full, jnp.ones(p.shape[0] - n, dtype=bool)])
    return jnp.where(keep_full, x, 0.0 + 0.0j)

"""Cubature / unscented filter library (ops.nonlinear).

Mirrors the reference's cubature_filter_test / unscented_filter_test
strategy (tests/unit-tests/.../tracking): on a linear-Gaussian system
the sigma-point filters must agree with the exact Kalman filter; on a
nonlinear measurement they must converge; and batched, the pure
functions must jit and vmap over a channel batch."""

import jax
import jax.numpy as jnp
import numpy as np

from gnss_sim_receiver_tpu.ops.nonlinear import (
    CubatureFilter, UnscentedFilter, sigma_predict, sigma_update)


def _linear_system(rng, nx=4, nz=2, T=40):
    F = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    H = rng.standard_normal((nz, nx))
    Q = 0.01 * np.eye(nx)
    R = 0.1 * np.eye(nz)
    x = rng.standard_normal(nx)
    xs, zs = [], []
    for _ in range(T):
        x = F @ x + rng.multivariate_normal(np.zeros(nx), Q)
        zs.append(H @ x + rng.multivariate_normal(np.zeros(nz), R))
        xs.append(x.copy())
    return F, H, Q, R, np.array(xs), np.array(zs)


def _kf(F, H, Q, R, zs, x0, P0):
    x, P = x0.copy(), P0.copy()
    for z in zs:
        x = F @ x
        P = F @ P @ F.T + Q
        S = H @ P @ H.T + R
        K = np.linalg.solve(S.T, H @ P).T
        x = x + K @ (z - H @ x)
        P = P - K @ S @ K.T
    return x, P


def test_sigma_filters_match_kf_on_linear_system():
    """On a linear-Gaussian system both sigma-point rules are exactly the
    Kalman filter (up to float32 roundoff)."""
    rng = np.random.default_rng(3)
    F, H, Q, R, _, zs = _linear_system(rng)
    x0 = np.zeros(4)
    P0 = np.eye(4)
    x_kf, P_kf = _kf(F, H, Q, R, zs, x0, P0)
    for cls in (CubatureFilter, UnscentedFilter):
        filt = cls(jnp.asarray(x0), jnp.asarray(P0))
        x, P = jnp.asarray(x0), jnp.asarray(P0)
        for z in zs:
            xp, Pp = filt.predict_sequential(
                x, P, lambda s: jnp.asarray(F) @ s, jnp.asarray(Q))
            x, P = filt.update_sequential(
                jnp.asarray(z), xp, Pp, lambda s: jnp.asarray(H) @ s,
                jnp.asarray(R))
        assert np.linalg.norm(np.asarray(x) - x_kf) < 1e-2, cls
        assert np.linalg.norm(np.asarray(P) - P_kf) < 1e-2, cls
        # getter surface parity (nonlinear_tracking.h:71-74)
        assert np.allclose(np.asarray(filt.get_x_est()), np.asarray(x))
        assert filt.get_P_x_pred().shape == (4, 4)


def test_cubature_converges_nonlinear_measurement():
    """Scalar random-walk state observed through a saturating
    nonlinearity: the CKF posterior must track the true state."""
    rng = np.random.default_rng(7)
    xs_true = np.cumsum(0.05 * rng.standard_normal(150)) + 1.0
    Q = jnp.array([[0.05 ** 2]])
    R = jnp.array([[0.01]])

    def h(s):
        return jnp.tanh(s)

    x, P = jnp.array([0.0]), jnp.array([[4.0]])
    errs = []
    for xt in xs_true:
        z = np.tanh(xt) + rng.normal(0, 0.1)
        x, P = sigma_predict(x, P, lambda s: s, Q)
        x, P = sigma_update(jnp.array([z]), x, P, h, R)
        errs.append(abs(float(x[0]) - xt))
    assert np.mean(errs[-30:]) < 0.5 * np.mean(errs[:10])
    assert np.mean(errs[-30:]) < 0.4


def test_sigma_rules_jit_and_vmap_over_channels():
    """Batched contract: one jitted vmapped call advances a whole channel
    batch of independent filters."""
    n_ch, nx = 8, 3
    F = jnp.eye(nx) * 0.99
    Q = 0.01 * jnp.eye(nx)
    R = jnp.array([[0.1]])

    def step(x, P, z):
        xp, Pp = sigma_predict(x, P, lambda s: F @ s, Q)
        return sigma_update(z, xp, Pp,
                            lambda s: jnp.atleast_1d(jnp.sin(s[0])), R)

    batched = jax.jit(jax.vmap(step))
    x = jnp.zeros((n_ch, nx))
    P = jnp.tile(jnp.eye(nx), (n_ch, 1, 1))
    z = jnp.linspace(-0.5, 0.5, n_ch)[:, None]
    x2, P2 = batched(x, P, z)
    assert x2.shape == (n_ch, nx) and P2.shape == (n_ch, nx, nx)
    assert np.all(np.isfinite(np.asarray(x2)))
    # diagonal covariances shrank (information was gained)
    assert np.all(np.asarray(P2[:, 0, 0]) < 1.0)

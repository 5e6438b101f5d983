"""Nonlinear Bayesian filter library: cubature and unscented Kalman
filters as pure JAX functions.

Role parity with the reference's tracking library
/root/reference/src/algorithms/tracking/libs/nonlinear_tracking.h:46-109
(``CubatureFilter`` / ``UnscentedFilter`` with ``predict_sequential`` /
``update_sequential`` over an arbitrary ``ModelFunction``), after
Arasaratnam & Haykin, "Cubature Kalman Filters", IEEE TAC 54(6), 2009.

Batched design: instead of the reference's stateful classes looping
over sigma points one ``arma::vec`` at a time, each rule is a pure
function whose sigma-point propagation is a single vmapped batch — the
model function is evaluated on an ``[n_pts, nx]`` array in one XLA
computation, so the filters jit, vmap over channels, and run in-scan on
device.  State lives in a (x, P) tuple carried by the caller.

Cubature rule: 2n points at sqrt(n)·columns of chol(P), equal weights.
Unscented rule: 2n+1 points with kappa-weighted center (reference uses
alpha=1e-3-style scaled transform with kappa = 3 - nx; we match that
default).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _chol_points_cubature(x, P):
    """[2n, nx] cubature points and their (equal) weights."""
    n = x.shape[0]
    S = jnp.linalg.cholesky(P)
    scaled = jnp.sqrt(jnp.asarray(n, x.dtype)) * S.T        # rows = sqrt(n) s_i
    pts = jnp.concatenate([x[None, :] + scaled, x[None, :] - scaled])
    w = jnp.full((2 * n,), 1.0 / (2 * n), x.dtype)
    return pts, w


def _chol_points_unscented(x, P, kappa=None):
    """[2n+1, nx] sigma points and weights (unscented transform)."""
    n = x.shape[0]
    if kappa is None:
        kappa = 3.0 - n
    lam = jnp.asarray(n + kappa, x.dtype)
    S = jnp.linalg.cholesky(lam * P)
    pts = jnp.concatenate([x[None, :], x[None, :] + S.T, x[None, :] - S.T])
    w0 = kappa / (n + kappa)
    wi = 1.0 / (2.0 * (n + kappa))
    w = jnp.concatenate([jnp.asarray([w0], x.dtype),
                         jnp.full((2 * n,), wi, x.dtype)])
    return pts, w


def _propagate(pts, w, fcn):
    """Push sigma points through ``fcn`` (vmapped) and return the
    weighted mean, spread matrix (pts - mean, weight-scaled), and the
    propagated points."""
    ypts = jax.vmap(fcn)(pts)
    mean = jnp.einsum("p,pi->i", w, ypts)
    dev = ypts - mean[None, :]
    return mean, dev, ypts


def sigma_predict(x_post, P_post, transition_fcn, Q, *, rule="cubature",
                  kappa=None):
    """Time update: propagate the posterior through ``transition_fcn``.

    Returns (x_pred, P_pred).  ``rule``: "cubature" | "unscented".
    Mirrors CubatureFilter::predict_sequential /
    UnscentedFilter::predict_sequential (nonlinear_tracking.cc).
    """
    pts, w = (_chol_points_cubature(x_post, P_post)
              if rule == "cubature"
              else _chol_points_unscented(x_post, P_post, kappa))
    mean, dev, _ = _propagate(pts, w, transition_fcn)
    P = jnp.einsum("p,pi,pj->ij", w, dev, dev) + Q
    return mean, P


def sigma_update(z, x_pred, P_pred, measurement_fcn, R, *,
                 rule="cubature", kappa=None):
    """Measurement update.  Returns (x_est, P_est).

    Cross/innovation covariances from the same sigma-point set
    (CubatureFilter::update_sequential role)."""
    pts, w = (_chol_points_cubature(x_pred, P_pred)
              if rule == "cubature"
              else _chol_points_unscented(x_pred, P_pred, kappa))
    z_mean, z_dev, _ = _propagate(pts, w, measurement_fcn)
    x_dev = pts - x_pred[None, :]
    P_zz = jnp.einsum("p,pi,pj->ij", w, z_dev, z_dev) + R
    P_xz = jnp.einsum("p,pi,pj->ij", w, x_dev, z_dev)
    K = jnp.linalg.solve(P_zz.T, P_xz.T).T
    x_est = x_pred + K @ (jnp.atleast_1d(z) - z_mean)
    P_est = P_pred - K @ P_zz @ K.T
    P_est = 0.5 * (P_est + P_est.T)
    return x_est, P_est


class CubatureFilter:
    """Stateful convenience wrapper with the reference's exact method
    surface (initialize / predict_sequential / update_sequential /
    get_*); the math lives in the pure functions above."""

    rule = "cubature"

    def __init__(self, x0=None, P0=None, nx: int | None = None):
        if x0 is None:
            nx = nx or 1
            x0 = jnp.zeros(nx)
            P0 = jnp.eye(nx)
        self.initialize(x0, P0)

    def initialize(self, x0, P0):
        self.x_pred = jnp.asarray(x0, jnp.float64
                                  if jax.config.jax_enable_x64
                                  else jnp.float32).reshape(-1)
        self.P_pred = jnp.asarray(P0, self.x_pred.dtype)
        self.x_est = self.x_pred
        self.P_est = self.P_pred

    def predict_sequential(self, x_post, P_post, transition_fcn, Q):
        self.x_pred, self.P_pred = sigma_predict(
            jnp.asarray(x_post).reshape(-1), jnp.asarray(P_post),
            transition_fcn, jnp.asarray(Q), rule=self.rule)
        return self.x_pred, self.P_pred

    def update_sequential(self, z, x_pred, P_pred, measurement_fcn, R):
        self.x_est, self.P_est = sigma_update(
            jnp.asarray(z).reshape(-1), jnp.asarray(x_pred).reshape(-1),
            jnp.asarray(P_pred), measurement_fcn, jnp.asarray(R),
            rule=self.rule)
        return self.x_est, self.P_est

    def get_x_pred(self):
        return self.x_pred

    def get_P_x_pred(self):
        return self.P_pred

    def get_x_est(self):
        return self.x_est

    def get_P_x_est(self):
        return self.P_est


class UnscentedFilter(CubatureFilter):
    rule = "unscented"

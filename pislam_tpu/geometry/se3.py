"""SE(3) / SO(3) utilities in pure JAX (fixed-shape float32).

No reference counterpart (the reference is frontend-only, README.md:22); this
underpins the VO/pose-graph/BA backend specified by BASELINE.json's north
star. Conventions: rotation matrices act on column vectors; exp/log use
Rodrigues forms.

float32 numerics: every trig coefficient is written in a cancellation-free
form (1 - cos via 2 sin^2(theta/2)) and switched to its Taylor series below
theta ~ 0.07, where the closed forms lose float32 precision. Both branches of
each jnp.where are NaN-free for all inputs (jnp.where evaluates both).
"""

from __future__ import annotations

import jax.numpy as jnp

_T2_SMALL = 5e-3  # theta^2 cutoff (theta ~ 0.07) for Taylor fallbacks


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], -1),
        jnp.stack([wz, z, -wx], -1),
        jnp.stack([-wy, wx, z], -1),
    ], -2)


def _coefficients(theta2):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), stable float32."""
    t2 = jnp.maximum(theta2, 1e-24)
    t = jnp.sqrt(t2)
    small = theta2 < _T2_SMALL
    ts = jnp.where(small, 1.0, t)  # safe theta for the closed forms
    sh = jnp.sin(0.5 * ts)
    a = jnp.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                  jnp.sin(ts) / ts)
    b = jnp.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                  2.0 * sh * sh / (ts * ts))
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                  (ts - jnp.sin(ts)) / (ts * ts * ts))
    return a, b, c


def so3_exp(w):
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta2 = jnp.sum(w * w, -1)[..., None, None]
    a, b, _ = _coefficients(theta2)
    k = hat(w)
    k2 = k @ k
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), k.shape)
    return eye + a * k + b * k2


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle (theta in [0, pi]).

    Differentiable at the identity: the small-angle branch derives its
    series from u = sin(theta) = |v|/2 (polynomial in u^2, clean JVP)
    instead of theta = arccos(trace...) whose derivative blows up at
    theta = 0 -- required by the analytic pose-graph Jacobians
    (backend/pose_graph.py) which autodiff through log at the residual,
    i.e. exactly where edges are near-converged.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos)
    v = jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    th = theta[..., None]
    small = th < 0.07
    ths = jnp.where(small, 1.0, th)
    # theta/(2 sin theta) = arcsin(u)/(2u) with u = sin(theta) = |v|/2;
    # series in u^2 only (no arccos in the data path of this branch)
    u2 = jnp.sum(v * v, -1, keepdims=True) * 0.25
    s = jnp.where(small,
                  0.5 * (1.0 + u2 / 6.0 + 3.0 * u2 * u2 / 40.0),
                  ths / (2.0 * jnp.sin(ths)))
    # theta -> pi branch (sin -> 0): axis_i^2 = (R_ii - cos) / (1 - cos),
    # signs from the off-diagonal antisymmetric part v. The 1e-12 inside
    # sqrt keeps the JVP finite when an axis component is exactly zero.
    near_pi = theta[..., None] > 3.0
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis = jnp.sqrt(jnp.clip(
        (diag - cos[..., None]) / jnp.clip(1.0 - cos[..., None], 1e-6, None),
        0.0, 1.0) + 1e-12)
    sign = jnp.where(v >= 0, 1.0, -1.0)
    w_pi = axis * sign * theta[..., None]
    w_reg = v * s
    return jnp.where(near_pi, w_pi, w_reg)


def se3_exp(xi):
    """(..., 6) twist [rho, w] -> ((..., 3, 3) R, (..., 3) t)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, -1)[..., None, None]
    a, b, c = _coefficients(theta2)
    k = hat(w)
    k2 = k @ k
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), k.shape)
    R = eye + a * k + b * k2
    V = eye + b * k + c * k2
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """Inverse of se3_exp: ((...,3,3), (...,3)) -> (..., 6) twist."""
    w = so3_log(R)
    theta2 = jnp.sum(w * w, -1)[..., None, None]
    t2 = jnp.maximum(theta2, 1e-24)
    th = jnp.sqrt(t2)
    small = theta2 < _T2_SMALL
    ths = jnp.where(small, 1.0, th)
    # coef = (1 - (theta/2) cot(theta/2)) / theta^2, Taylor 1/12 + t^2/720
    half = 0.5 * ths
    cot = jnp.cos(half) / jnp.maximum(jnp.sin(half), 1e-12)
    coef = jnp.where(small,
                     1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
                     (1.0 - half * cot) / (ths * ths))
    k = hat(w)
    k2 = k @ k
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), k.shape)
    Vinv = eye - 0.5 * k + coef * k2
    rho = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([rho, w], -1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): X -> Ra (Rb X + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, X):
    """Apply: (..., 3, 3), (..., 3), (..., N, 3) -> (..., N, 3)."""
    return X @ jnp.swapaxes(R, -1, -2) + t[..., None, :]

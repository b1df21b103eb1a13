"""Motion-only bundle adjustment: camera pose from 2D-3D correspondences.

PnP as a fixed-shape batched solve. Given map landmarks (world xyz) matched
to the current frame's normalised keypoints, refine the frame pose by
robust Gauss-Newton on the reprojection error -- the ORB-SLAM-style "track
the local map" step the reference never shipped (frontend-only,
README.md:22). Fixed iteration count, fixed shapes, Huber re-weighting
instead of explicit RANSAC: one jitted program.

Jacobians come from forward-mode autodiff of the residual at the identity
perturbation (exact, no hand-derived formulas), same pattern as
backend/pose_graph.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3


def _project_residuals(R, t, xyz, uv):
    """(N, 2) reprojection residuals + (N,) depths, world->cam pose."""
    xc = xyz @ R.T + t
    z = xc[:, 2]
    zs = jnp.where(z > 1e-6, z, 1.0)  # NaN-free for behind-camera points
    r = xc[:, :2] / zs[:, None] - uv
    return r, z


@partial(jax.jit, static_argnames=("iters",))
def motion_only_ba(R0, t0, xyz, uv, valid, iters: int = 8,
                   huber: float = 5e-3, inlier_threshold: float = 6e-3,
                   damping: float = 1e-6):
    """Refine a world->cam pose against matched map points.

    R0 (3,3), t0 (3,): initial pose. xyz (N,3) world landmarks, uv (N,2)
    normalised observations, valid (N,) bool. Returns dict with R, t,
    inliers (N,) bool, num_inliers. Behind-camera points get zero weight.
    """
    def step(carry, _):
        R, t = carry

        def res(xi):
            dR, dt = se3.se3_exp(xi)
            Rn = dR @ R
            tn = (dR @ t[:, None])[:, 0] + dt
            r, _ = _project_residuals(Rn, tn, xyz, uv)
            return r

        r, z = _project_residuals(R, t, xyz, uv)
        J = jax.jacfwd(res)(jnp.zeros(6))          # (N, 2, 6)
        rn = jnp.linalg.norm(r, axis=1)
        w = jnp.where(rn > huber, huber / jnp.maximum(rn, 1e-12), 1.0)
        w = jnp.where(valid & (z > 1e-6), w, 0.0)
        Jw = J * w[:, None, None]
        H = jnp.einsum("nki,nkj->ij", Jw, J) + damping * jnp.eye(6)
        b = -jnp.einsum("nki,nk->i", Jw, r)
        xi = jnp.linalg.solve(H, b)
        dR, dt = se3.se3_exp(xi)
        Rn = dR @ R
        tn = (dR @ t[:, None])[:, 0] + dt
        return (Rn, tn), jnp.sum(w * rn * rn)

    (R, t), costs = jax.lax.scan(step, (R0, t0), None, length=iters)
    r, z = _project_residuals(R, t, xyz, uv)
    rn = jnp.linalg.norm(r, axis=1)
    inl = valid & (z > 1e-6) & (rn < inlier_threshold)
    return {"R": R, "t": t, "inliers": inl,
            "num_inliers": jnp.sum(inl), "costs": costs}

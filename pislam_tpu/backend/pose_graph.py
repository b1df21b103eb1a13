"""Pose-graph optimisation (Gauss-Newton over SE(3) relative constraints).

No reference counterpart; part of the backend specified by BASELINE.json
configs[3]. Fixed-shape: N pose nodes, M edges with validity masks. For the
window/keyframe-graph sizes SLAM uses (N <= a few hundred), the full (6N, 6N)
normal matrix is small; we assemble it densely with segment_sums and solve
with a damped dense factorisation -- the accelerator-friendly inversion of
sparse CPU solvers. Node 0 is gauge-fixed.

Edge residual (right-perturbation convention):
    r_ij = log( Z_ij^{-1} (X_i^{-1} X_j) )
with Jacobians approximated at identity perturbation (standard Gauss-Newton
for pose graphs; exact enough near convergence, iterated otherwise).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..geometry import se3


class PoseGraph(NamedTuple):
    R: jax.Array          # (N, 3, 3)
    t: jax.Array          # (N, 3)
    edge_i: jax.Array     # (M,) int32
    edge_j: jax.Array     # (M,) int32
    edge_R: jax.Array     # (M, 3, 3) measured relative rotation (i -> j)
    edge_t: jax.Array     # (M, 3)
    edge_valid: jax.Array  # (M,) bool
    node_valid: jax.Array  # (N,) bool
    # Optional (M,) per-edge information weights (scalar isotropic
    # information matrices): residual m contributes w_m * |r_m|^2. The
    # ORB-SLAM essential graph weights edges by match support; an
    # equal-weight graph lets N-1 odometry edges outvote one correct loop
    # edge, which is the textbook cause of loop over/under-correction.
    # None = all ones (backward compatible).
    edge_weight: Optional[jax.Array] = None
    # Optional Sim(3) state (optimize(..., sim3=True)): per-node
    # log-scales and per-edge measured relative log-scales. A monocular
    # front end drifts in SCALE along the trajectory; an SE(3) graph has
    # no scale DOF, so a metric loop edge's translation misfit gets
    # distributed as bogus rotations/translations instead of the scale
    # change that actually happened -- the reason ORB-SLAM optimises its
    # essential graph over Sim(3). None = zeros.
    node_logs: Optional[jax.Array] = None   # (N,) log s_i
    edge_logs: Optional[jax.Array] = None   # (M,) log s_ij measured


def _edge_weights(g: PoseGraph):
    if g.edge_weight is None:
        return jnp.ones(g.edge_i.shape[0], jnp.float32)
    return g.edge_weight.astype(jnp.float32)


def _node_logs(g: PoseGraph):
    if g.node_logs is None:
        return jnp.zeros(g.R.shape[0], jnp.float32)
    return g.node_logs.astype(jnp.float32)


def _edge_logs(g: PoseGraph):
    if g.edge_logs is None:
        return jnp.zeros(g.edge_i.shape[0], jnp.float32)
    return g.edge_logs.astype(jnp.float32)


# ---- Sim(3) helpers: elements act as x -> e^ls R x + t -------------------

def _sim3_rel(lsi, Ri, ti, lsj, Rj, tj):
    """X_i^{-1} X_j for Sim3 nodes: (ls, R, t) relative, batched."""
    Rit = jnp.swapaxes(Ri, -1, -2)
    si_inv = jnp.exp(-lsi)
    R = Rit @ Rj
    t = si_inv[..., None] * (Rit @ (tj - ti)[..., None])[..., 0]
    return lsj - lsi, R, t


def _sim3_residual(ls_rel, R_rel, t_rel, ls_z, R_z, t_z):
    """(…, 7) residual of E = Z^{-1} (X_i^{-1} X_j): [t_E, log R_E, ls_E].

    A simplified Sim3 log (translation taken directly instead of through
    the W-matrix) -- vanishes iff E is identity, which is all Gauss-Newton
    needs; near convergence it differs from the exact log only by a
    benign reweighting of the translation block."""
    Rzt = jnp.swapaxes(R_z, -1, -2)
    sz_inv = jnp.exp(-ls_z)
    R_E = Rzt @ R_rel
    t_E = sz_inv[..., None] * (Rzt @ (t_rel - t_z)[..., None])[..., 0]
    w_E = se3.so3_log(R_E)
    return jnp.concatenate(
        [t_E, w_E, (ls_rel - ls_z)[..., None]], axis=-1)


def sim3_edge_residuals(g: PoseGraph):
    """(M, 7) Sim3 twist residuals (masked by edge_valid)."""
    ls = _node_logs(g)
    ls_rel, R_rel, t_rel = _sim3_rel(
        ls[g.edge_i], g.R[g.edge_i], g.t[g.edge_i],
        ls[g.edge_j], g.R[g.edge_j], g.t[g.edge_j])
    r = _sim3_residual(ls_rel, R_rel, t_rel,
                       _edge_logs(g), g.edge_R, g.edge_t)
    return r * g.edge_valid[:, None]


def _analytic_jacobians_sim3(g: PoseGraph):
    """Exact J_i, J_j (M, 7, 7) wrt left-multiplicative Sim3 twists
    [rho, w, sigma] (autodiff, like the SE3 path)."""
    def res(xi, lsi, Ri, ti, lsj, Rj, tj, lz, ZR, Zt):
        def perturb(p, ls, R, t):
            dR, dt = se3.se3_exp(p[:6])
            sig = p[6]
            return (ls + sig, dR @ R,
                    jnp.exp(sig) * (dR @ t[:, None])[:, 0] + dt)
        lsi2, Ri2, ti2 = perturb(xi[:7], lsi, Ri, ti)
        lsj2, Rj2, tj2 = perturb(xi[7:], lsj, Rj, tj)
        ls_rel, R_rel, t_rel = _sim3_rel(lsi2, Ri2, ti2, lsj2, Rj2, tj2)
        return _sim3_residual(ls_rel, R_rel, t_rel, lz, ZR, Zt)

    ls = _node_logs(g)
    jac = jax.vmap(jax.jacfwd(res),
                   in_axes=(None, 0, 0, 0, 0, 0, 0, 0, 0, 0))(
        jnp.zeros(14),
        ls[g.edge_i], g.R[g.edge_i], g.t[g.edge_i],
        ls[g.edge_j], g.R[g.edge_j], g.t[g.edge_j],
        _edge_logs(g), g.edge_R, g.edge_t)  # (M, 7, 14)
    r0 = sim3_edge_residuals(g)
    sw = jnp.sqrt(_edge_weights(g))
    jac = jac * sw[:, None, None]
    r0 = r0 * sw[:, None]
    m = g.edge_valid[:, None, None]
    return jac[:, :, :7] * m, jac[:, :, 7:] * m, r0


def edge_residuals(g: PoseGraph):
    """(M, 6) twist residuals log(Z^{-1} X_i^{-1} X_j)."""
    Ri, ti = g.R[g.edge_i], g.t[g.edge_i]
    Rj, tj = g.R[g.edge_j], g.t[g.edge_j]
    Rinv, tinv = se3.inverse(Ri, ti)
    Rij, tij = se3.compose(Rinv, tinv, Rj, tj)
    Zinv_R, Zinv_t = se3.inverse(g.edge_R, g.edge_t)
    Er, Et = se3.compose(Zinv_R, Zinv_t, Rij, tij)
    r = se3.se3_log(Er, Et)
    return r * g.edge_valid[:, None]


def _analytic_jacobians(g: PoseGraph):
    """Exact J_i, J_j (M, 6, 6) wrt left-multiplicative twists, via forward-
    mode autodiff of the per-edge residual (the JAX-native replacement for
    hand-derived SE(3) right-Jacobian formulas). Exact to float32 roundoff;
    the forward-difference version below loses ~half the significand per
    entry (eps=1e-5 in float32) which caps convergence on large loops.
    """
    def res(xi, Ri, ti, Rj, tj, ZR, Zt):
        dRi, dti = se3.se3_exp(xi[:6])
        dRj, dtj = se3.se3_exp(xi[6:])
        Ri2, ti2 = dRi @ Ri, (dRi @ ti[:, None])[:, 0] + dti
        Rj2, tj2 = dRj @ Rj, (dRj @ tj[:, None])[:, 0] + dtj
        Rinv, tinv = se3.inverse(Ri2, ti2)
        Rij, tij = se3.compose(Rinv, tinv, Rj2, tj2)
        Zinv_R, Zinv_t = se3.inverse(ZR, Zt)
        Er, Et = se3.compose(Zinv_R, Zinv_t, Rij, tij)
        return se3.se3_log(Er, Et)

    jac = jax.vmap(jax.jacfwd(res), in_axes=(None, 0, 0, 0, 0, 0, 0))(
        jnp.zeros(12),
        g.R[g.edge_i], g.t[g.edge_i], g.R[g.edge_j], g.t[g.edge_j],
        g.edge_R, g.edge_t)  # (M, 6, 12)
    r0 = edge_residuals(g)
    # sqrt-information weighting: scaling (J, r) by sqrt(w) puts w into
    # both the normal matrix (w J^T J) and the gradient (w J^T r)
    sw = jnp.sqrt(_edge_weights(g))
    jac = jac * sw[:, None, None]
    r0 = r0 * sw[:, None]
    m = g.edge_valid[:, None, None]
    return jac[:, :, :6] * m, jac[:, :, 6:] * m, r0


def _numerical_jacobians(g: PoseGraph, eps: float = 1e-5):
    """J_i, J_j (M, 6, 6) wrt left-multiplicative twists on nodes i and j.

    Forward differences via one vmapped batch over the 12 perturbation axes
    (cheap: M x 12 residual evaluations, all vectorised).
    """
    def perturbed(axis_onehot, side):
        dR, dt = se3.se3_exp(axis_onehot)

        def apply(g):
            if side == 0:
                Ri = dR[None] @ g.R[g.edge_i]
                ti = (dR[None] @ g.t[g.edge_i][..., None])[..., 0] + dt[None]
                Rj, tj = g.R[g.edge_j], g.t[g.edge_j]
            else:
                Ri, ti = g.R[g.edge_i], g.t[g.edge_i]
                Rj = dR[None] @ g.R[g.edge_j]
                tj = (dR[None] @ g.t[g.edge_j][..., None])[..., 0] + dt[None]
            Rinv, tinv = se3.inverse(Ri, ti)
            Rij, tij = se3.compose(Rinv, tinv, Rj, tj)
            Zinv_R, Zinv_t = se3.inverse(g.edge_R, g.edge_t)
            Er, Et = se3.compose(Zinv_R, Zinv_t, Rij, tij)
            return se3.se3_log(Er, Et)
        return apply(g)

    r0 = perturbed(jnp.zeros(6), 0)
    eye = jnp.eye(6) * eps
    ji = jnp.stack([(perturbed(eye[k], 0) - r0) / eps for k in range(6)], -1)
    jj = jnp.stack([(perturbed(eye[k], 1) - r0) / eps for k in range(6)], -1)
    sw = jnp.sqrt(_edge_weights(g))
    ji, jj, r0 = ji * sw[:, None, None], jj * sw[:, None, None], \
        r0 * sw[:, None]
    m = g.edge_valid[:, None, None]
    return ji * m, jj * m, r0 * g.edge_valid[:, None]


def _solve_normal_dense(graph, ji, jj, r, damping, n):
    """Assemble + factorise the dense (DN, DN) normal equations
    (D = 6 for SE3, 7 for Sim3 -- inferred from the Jacobian blocks)."""
    D = ji.shape[-1]
    h = jnp.zeros((n, D, n, D))
    b = jnp.zeros((n, D))
    hii = jnp.einsum("mki,mkj->mij", ji, ji)
    hjj = jnp.einsum("mki,mkj->mij", jj, jj)
    hij = jnp.einsum("mki,mkj->mij", ji, jj)
    bi = -jnp.einsum("mki,mk->mi", ji, r)
    bj = -jnp.einsum("mki,mk->mi", jj, r)
    h = h.at[graph.edge_i, :, graph.edge_i, :].add(hii)
    h = h.at[graph.edge_j, :, graph.edge_j, :].add(hjj)
    h = h.at[graph.edge_i, :, graph.edge_j, :].add(hij)
    h = h.at[graph.edge_j, :, graph.edge_i, :].add(
        jnp.swapaxes(hij, -1, -2))
    b = b.at[graph.edge_i].add(bi).at[graph.edge_j].add(bj)

    hd = h.reshape(D * n, D * n) + damping * jnp.eye(D * n)
    bd = b.reshape(-1)
    pin = jnp.repeat(~graph.node_valid | (jnp.arange(n) == 0), D)
    hd = jnp.where(pin[:, None] | pin[None, :], jnp.eye(D * n), hd)
    bd = jnp.where(pin, 0.0, bd)
    return jnp.linalg.solve(hd, bd).reshape(n, D)


def _solve_normal_cg(graph, ji, jj, r, damping, n, cg_iters):
    """Matrix-free block-Jacobi PCG on the same normal equations.

    The dense path materialises (6N)^2 and factorises in O((6N)^3) --
    fine for windowed graphs, a ceiling for keyframe_capacity 256+. Here
    H x is applied per edge (two einsums + two segment_sums), O(M) memory;
    the per-node 6x6 diagonal blocks are inverted once per GN step as the
    preconditioner (pose graphs are chain-dominated, so block-Jacobi PCG
    converges in O(graph diameter) iterations).
    """
    from .ba import _pcg

    D = ji.shape[-1]
    pinned = ~graph.node_valid | (jnp.arange(n) == 0)

    blocks = jnp.zeros((n, D, D))
    blocks = blocks.at[graph.edge_i].add(jnp.einsum("mki,mkj->mij", ji, ji))
    blocks = blocks.at[graph.edge_j].add(jnp.einsum("mki,mkj->mij", jj, jj))
    blocks = blocks + damping * jnp.eye(D)
    blocks = jnp.where(pinned[:, None, None], jnp.eye(D), blocks)
    binv = jnp.linalg.inv(blocks)

    b = jnp.zeros((n, D))
    b = b.at[graph.edge_i].add(-jnp.einsum("mki,mk->mi", ji, r))
    b = b.at[graph.edge_j].add(-jnp.einsum("mki,mk->mi", jj, r))
    b = jnp.where(pinned[:, None], 0.0, b).reshape(-1)

    def apply(x_flat):
        x = jnp.where(pinned[:, None], 0.0, x_flat.reshape(n, D))
        y = (jnp.einsum("mki,mi->mk", ji, x[graph.edge_i])
             + jnp.einsum("mki,mi->mk", jj, x[graph.edge_j]))  # (M, K)
        out = jnp.zeros((n, D))
        out = out.at[graph.edge_i].add(jnp.einsum("mki,mk->mi", ji, y))
        out = out.at[graph.edge_j].add(jnp.einsum("mki,mk->mi", jj, y))
        out = out + damping * x
        out = jnp.where(pinned[:, None], x_flat.reshape(n, D), out)
        return out.reshape(-1)

    def minv(r_flat):
        return jnp.einsum("nij,nj->ni", binv,
                          r_flat.reshape(n, D)).reshape(-1)

    return _pcg(apply, minv, b, cg_iters).reshape(n, D)


@partial(jax.jit, static_argnames=("iters", "solver", "cg_iters", "sim3"))
def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-4,
             solver: str = "auto", cg_iters: int = 0, sim3: bool = False):
    """Damped GN iterations; node 0 gauge-fixed. Returns (graph, costs).

    solver="auto" uses the dense factorisation up to 64 nodes and
    matrix-free block-Jacobi PCG above (same answers within CG tolerance;
    O(M) memory instead of O((6N)^2)). cg_iters=0 defaults to
    max(128, N): block-Jacobi PCG needs ~graph-diameter iterations to
    propagate a loop correction along a chain-dominated graph.

    sim3=True optimises over Sim(3) -- each node additionally carries a
    log-scale (g.node_logs; zeros if absent) so monocular scale drift can
    be absorbed as scale change along the chain instead of being forced
    into bogus rotations/translations (the ORB-SLAM essential-graph
    formulation). Convert back to SE(3) poses with t / exp(node_logs)
    (the caller's job; see models/slam.py).

    The returned per-iteration costs are INFORMATION-WEIGHTED (sum of
    w * |r|^2 over edges): comparable across iterations of one graph,
    but not across graphs with different edge_weight scales (e.g.
    covisibility-count weights in the tens vs unit weights)."""
    n = g.R.shape[0]
    if solver == "auto":
        solver = "cg" if n > 64 else "dense"
    if not cg_iters:
        cg_iters = max(128, n)
    assert solver in ("dense", "cg")
    if sim3 and g.node_logs is None:
        g = g._replace(node_logs=jnp.zeros(n, jnp.float32))

    def step(graph, _):
        if sim3:
            ji, jj, r = _analytic_jacobians_sim3(graph)
        else:
            ji, jj, r = _analytic_jacobians(graph)
        if solver == "cg":
            delta = _solve_normal_cg(graph, ji, jj, r, damping, n, cg_iters)
        else:
            delta = _solve_normal_dense(graph, ji, jj, r, damping, n)
        dR, dt = se3.se3_exp(delta[:, :6])
        Rn = dR @ graph.R
        tn = (dR @ graph.t[..., None])[..., 0]
        if sim3:
            sig = delta[:, 6]
            tn = jnp.exp(sig)[:, None] * tn + dt
            new = graph._replace(R=Rn, t=tn,
                                 node_logs=_node_logs(graph) + sig)
            res = sim3_edge_residuals(new)
        else:
            tn = tn + dt
            new = graph._replace(R=Rn, t=tn)
            res = edge_residuals(new)
        cost = jnp.sum(_edge_weights(new)[:, None] * res ** 2)
        return new, cost

    g, costs = jax.lax.scan(step, g, None, length=iters)
    return g, costs

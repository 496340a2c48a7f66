"""Batched dense ADMM QP core in JAX (replaces OSQP + eiquadprog).

Solves   min_x 1/2 x'Px + q'x   s.t.  l <= Ax <= u
with the OSQP operator splitting (same algorithm as oracle/qp.py, which is the
float64 reference for this module; SURVEY.md §2.1 native table rows "OSQP" and
"eiquadprog").  Batched-accelerator choices:

  * FIXED iteration count (SURVEY.md §7.3 "fixed-iteration ADMM"): no data-
    dependent control flow, so the whole solve jits into one fused program and
    `vmap`s across thousands of scenarios in lockstep (BASELINE.json:5).
  * The KKT matrix K = P + sigma I + A' diag(rho) A is inverted ONCE per adapt
    round (blocked Cholesky + triangular inverse, qp/blockinv.py) and
    applied as a dense inverse: every ADMM iteration is then batched
    matrix-vector products + a clip.  (n <= 192, so K^-1 is small;
    Newton-Schulz / LU / Cholesky paths are kept for comparison.)
  * Ruiz equilibration + cost scaling in-graph (f32 conditioning; §7.3
    "Numerics").
  * Per-row rho with the OSQP 1e3 equality boost (rows with l == u), computed
    from the bounds with a finite-infinity convention (INF = 1e20).

Single-problem layout; batch with jax.vmap over (P, q, A, l, u [, x0, y0]).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from mpctsid_tpu.qp.blockinv import spd_inverse_chol
from mpctsid_tpu.qp.precision import residual_matvec
from mpctsid_tpu.utils import f32_matmuls

INF = 1e20


@dataclasses.dataclass
class QPSolution:
    x: jnp.ndarray          # (n,) primal
    y: jnp.ndarray          # (m,) dual
    z: jnp.ndarray          # (m,) projected constraint value
    prim_res: jnp.ndarray   # scalar, unscaled inf-norm
    dual_res: jnp.ndarray   # scalar, unscaled inf-norm
    # Per-scenario solve status (SURVEY.md §5.3 failure detection): True when
    # the returned x is finite and primal-feasible to `status_tol`.  Under
    # vmap this is the per-scenario status VECTOR consumers use for the
    # last-feasible-plan fallback (cascade/engine.py) — a diverged scenario
    # must never silently poison its rollout.
    ok: jnp.ndarray         # bool scalar


jax.tree_util.register_dataclass(
    QPSolution, data_fields=["x", "y", "z", "prim_res", "dual_res", "ok"],
    meta_fields=[])


def _ns_inverse(K, x0=None, iters: int = 16):
    """Newton-Schulz iteration for K^-1 of an SPD matrix: X <- X (2I - K X).

    Matmul-only: no pivoting or triangular solves.  Cold init X0 = I / ||K||_inf (valid for SPD K); warm init from a
    previous inverse (adapt rounds change K mildly) needs ~1/3 the iterations.
    Quadratic convergence: residual ||I - XK|| squares each step."""
    n = K.shape[0]
    eye2 = 2.0 * jnp.eye(n, dtype=K.dtype)
    if x0 is None:
        norm_inf = jnp.max(jnp.sum(jnp.abs(K), axis=1))
        X = jnp.eye(n, dtype=K.dtype) / norm_inf
    else:
        X = x0

    def body(_, X):
        return X @ (eye2 - K @ X)

    return jax.lax.fori_loop(0, iters, body, X)


def ruiz_equilibrate(P, q, A, l, u, iters: int = 8):
    """Modified-Ruiz equilibration of [[P, A'], [A, 0]] + cost scaling.

    Returns (Pb, qb, Ab, lb, ub, D, E, c): x = D xb, y = E yb / c.

    NORM-ONLY iteration (round-5 rewrite): the loop carries just the scale
    vectors (D, E, c) and reads the ORIGINAL P/A through weighted abs-max
    reductions — the scaled matrix's column max is
    max_i |c D_i P_ij D_j| = c D_j max_i(D_i |P_ij|) — then applies the
    accumulated scaling ONCE at the end.  The previous form rescaled the
    full (n,n)+(m,n) matrices every round: at B=1024/n=192 that is ~13 GB
    of loop-carried read+write memory traffic.  Read-only reductions halve
    the traffic and drop the writes.  Same scales up to
    fp reduction order; same guards (all-zero rows keep scale 1)."""

    def body(_, carry):
        D, E, c = carry
        # weighted column/row maxes of the CURRENT scaled matrices, computed
        # from the originals:  Pb_ij = c D_i P_ij D_j,  Ab_ij = E_i A_ij D_j
        wp = jnp.max(jnp.abs(P) * D[:, None], axis=0)       # max_i D_i|P_ij|
        wa_col = jnp.max(jnp.abs(A) * E[:, None], axis=0)   # max_i E_i|A_ij|
        wa_row = jnp.max(jnp.abs(A) * D[None, :], axis=1)   # max_j |A_ij|D_j
        cn = jnp.maximum(c * D * wp, D * wa_col)
        cm = E * wa_row
        # all-zero rows/cols (e.g. freed swing-contact rows) keep scale 1,
        # otherwise the 1e6 factor compounds to inf across rounds
        dn = jnp.where(cn < 1e-10, 1.0, jax.lax.rsqrt(jnp.maximum(cn, 1e-12)))
        dm = jnp.where(cm < 1e-10, 1.0, jax.lax.rsqrt(jnp.maximum(cm, 1e-12)))
        D = D * dn
        E = E * dm
        # cost scaling vs the POST-dn matrices (matches the original order)
        pcol = c * D * jnp.max(jnp.abs(P) * D[:, None], axis=0)
        qb_max = c * jnp.max(jnp.abs(q) * D)
        gamma = 1.0 / jnp.maximum(
            jnp.maximum(jnp.mean(pcol), qb_max), 1e-12)
        return D, E, c * gamma

    n = P.shape[0]
    m = A.shape[0]
    init = (jnp.ones(n, P.dtype), jnp.ones(m, P.dtype),
            jnp.asarray(1.0, P.dtype))
    D, E, c = jax.lax.fori_loop(0, iters, body, init)
    Pb = (c * D)[:, None] * P * D[None, :]
    qb = c * D * q
    Ab = E[:, None] * A * D[None, :]
    # scale bounds, keeping the finite-infinity convention intact
    lb = jnp.where(l <= -INF, l, E * l)
    ub = jnp.where(u >= INF, u, E * u)
    return Pb, qb, Ab, lb, ub, D, E, c


@f32_matmuls
@partial(jax.jit, static_argnames=("iters", "mode", "equilibrate_iters",
                                   "polish_kkt", "adapt_rounds",
                                   "rho", "sigma", "alpha", "rho_eq_scale"))
def admm_solve(P, q, A, l, u,
               x0=None, y0=None,
               iters: int = 60,
               rho: float = 0.1,
               sigma: float = 1e-6,
               alpha: float = 1.6,
               rho_eq_scale: float = 1e3,
               mode: str = "blockinv",
               equilibrate_iters: int = 8,
               polish_kkt: bool = False,
               adapt_rounds: int = 1,
               status_tol: float = 0.05) -> QPSolution:
    """Fixed-iteration OSQP-style ADMM.  vmap-able; see module docstring."""
    n = P.shape[0]
    m = A.shape[0]
    dtype = P.dtype

    P0, q0, A0, l0, u0 = P, q, A, l, u

    P, q, A, l, u, D, E, c = ruiz_equilibrate(P, q, A, l, u, equilibrate_iters)

    eq = (u0 - l0) < 1e-9
    eqf = eq.astype(dtype)

    x = jnp.zeros(n, dtype) if x0 is None else (x0 / D).astype(dtype)
    y = jnp.zeros(m, dtype) if y0 is None else (y0 * c / E).astype(dtype)
    z = jnp.clip(A @ x, l, u)

    def run_block(rho_s, x, z, y, n_iters):
        """n_iters ADMM iterations at scalar rho (with the eq-row boost)."""
        rho_vec = (1.0 + eqf * (rho_eq_scale - 1.0)) * rho_s
        rho_inv = 1.0 / rho_vec
        K = P + sigma * jnp.eye(n, dtype=dtype) + (A.T * rho_vec) @ A
        if mode == "blockinv":
            # Blocked Cholesky + triangular inverse + 1 Newton-Schulz
            # correction (qp/blockinv.py): matmul-only like NS, but an exact
            # O(n^3) factorization whose triangular inverse only faces
            # cond(L) = sqrt(cond(K)) — backward-stable where the raw Schur
            # recursion lost ~cond(K)*eps and NaN'd the cascade on
            # equality-boosted WBC KKTs (residual ~1 at cond 1e4 in f32;
            # chol matches batched LU at 3e-4 on the same matrices).  Works
            # for both QP stages; the modes below are reference/fallbacks.
            K_inv = spd_inverse_chol(K, ns_steps=1)
        elif mode == "inv":
            # Newton-Schulz inverse: matmul-only, unlike the LU-based
            # jnp.linalg.inv.
            # VALID ONLY for cond(K) <~ 1e3 in f32 (no equality-boosted rows):
            # the MPC QP qualifies; the WBC QP (eq rows, cond ~ 1e5) must use
            # mode="exact_inv" — NS diverges there.  Cold-start every round:
            # warm-starting across rho changes can put ||I - X0 K|| > 1 and
            # NS then diverges to NaN.
            K_inv = _ns_inverse(K, iters=22)
        elif mode == "exact_inv":
            K_inv = jnp.linalg.inv(K)
        else:
            K_inv = None
            L = jnp.linalg.cholesky(K)

            def k_solve(rhs):
                t = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
                return jax.scipy.linalg.solve_triangular(L.T, t, lower=False)

        if K_inv is not None:
            def k_solve(rhs):  # noqa: F811
                # one iterative-refinement step: squares the explicit
                # inverse's relative error (~1e-2 at cond 1e5 -> ~1e-4) for
                # two extra matmuls, and what closes the parity gap vs an LU
                # solve on the WBC ridge KKT (scripts/diag_kinv,
                # scripts/diag_wbc_mode).
                x_a = K_inv @ rhs
                return x_a + K_inv @ (rhs - K @ x_a)

        def body(_, carry):
            x, z, y = carry
            rhs = sigma * x - q + A.T @ (rho_vec * z - y)
            x_t = k_solve(rhs)
            z_t = A @ x_t
            x_n = alpha * x_t + (1.0 - alpha) * x
            z_r = alpha * z_t + (1.0 - alpha) * z
            z_n = jnp.clip(z_r + rho_inv * y, l, u)
            y_n = y + rho_vec * (z_r - z_n)
            return x_n, z_n, y_n

        return jax.lax.fori_loop(0, n_iters, body, (x, z, y))

    # OSQP-style adaptive rho: fixed number of rounds, each refactoring with a
    # per-problem rho from the scaled residual ratio.  Rounds are trace-time
    # static, so the whole schedule vmaps (every scenario adapts independently).
    rho_s = jnp.asarray(rho, dtype)
    n_rounds = max(1, adapt_rounds)
    iters_per = max(1, iters // n_rounds)
    for r_i in range(n_rounds):
        x, z, y = run_block(rho_s, x, z, y, iters_per)
        if r_i + 1 < n_rounds:
            Ax = A @ x
            Px = P @ x
            Aty = A.T @ y
            rp = jnp.max(jnp.abs(Ax - z)) / jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(Ax)), jnp.max(jnp.abs(z))), 1e-12)
            rd = jnp.max(jnp.abs(Px + q + Aty)) / jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(Px)),
                            jnp.maximum(jnp.max(jnp.abs(q)),
                                        jnp.max(jnp.abs(Aty)))), 1e-12)
            # f32 deviation from OSQP's [1e-6, 1e6]: rho bounds [1e-3, 1e3].
            # K = P + sigma I + A' rho A has lmin >~ rho * lmin(A'A), so tiny
            # rho drives cond(K) past what ANY f32 factorization can invert
            # (observed: adapted rho 4.8e-4 -> cond ~ 1e6 -> inverse residual
            # 4e6).  Warm starts + the polish tail recover the convergence
            # speed the narrower rho range gives up.
            rho_s = jnp.clip(rho_s * jnp.sqrt(rp / jnp.maximum(rd, 1e-12)),
                             1e-3, 1e3)

    if polish_kkt:
        # polish in the SCALED frame (well-conditioned KKT for the f32 solve);
        # two rounds: the second re-detects the active set at the polished point
        x, y = _polish(P, q, A, l, u, x, y, eq)
        x, y = _polish(P, q, A, l, u, x, y, eq, active_tol=1e-5)
    # unscale and report unscaled residuals
    x = D * x
    y = E * y / c
    z_u = jnp.clip(A0 @ x, l0, u0)
    prim = jnp.max(jnp.abs(A0 @ x - z_u)) if m else jnp.zeros((), dtype)
    dual = jnp.max(jnp.abs(P0 @ x + q0 + A0.T @ y))
    ok = (jnp.all(jnp.isfinite(x)) & jnp.isfinite(prim)
          & (prim < status_tol))
    return QPSolution(x=x, y=y, z=z_u, prim_res=prim, dual_res=dual, ok=ok)


def _polish(P, q, A, l, u, x, y, eq,
            active_tol: float = 1e-3, delta: float = 1e-4):
    """Device-side OSQP polish: one masked-KKT solve on the detected active set.

    Fixed-shape trick: instead of slicing active rows (dynamic shapes), solve
        [[P,            A' diag(mask)], [x ]   [      -q       ]
         [diag(mask) A, -D_nu        ]] [nu] = [ mask * b_active]
    where D_nu = delta*I on active rows and I on inactive rows, which pins
    nu_i = 0 exactly for inactive constraints.  Falls back to the ADMM iterate
    per-problem when the polished point is infeasible or the KKT residual got
    worse (mirrors oracle/qp.py _polish acceptance test).  One batched dense
    solve replaces hundreds of ADMM iterations of tail accuracy."""
    n = P.shape[0]
    m = A.shape[0]
    dtype = P.dtype
    Ax = A @ x
    l_fin = l > -INF
    u_fin = u < INF
    # a side can only be active if its bound is finite (degenerate swing rows
    # carry nonzero duals of either sign at mu*fz = 0)
    low = l_fin & ((y < -active_tol) | (jnp.abs(Ax - l) < active_tol))
    upp = u_fin & ((y > active_tol) | (jnp.abs(Ax - u) < active_tol))
    low = (low | eq) & ~(upp & ~eq)
    act = low | upp
    mask = act.astype(dtype)
    b = jnp.where(low, l, u)

    AtM = A.T * mask
    Dnu = jnp.where(act, delta, 1.0).astype(dtype)
    KKT_reg = jnp.concatenate([
        jnp.concatenate([P + delta * jnp.eye(n, dtype=dtype), AtM], axis=1),
        jnp.concatenate([AtM.T, -jnp.diag(Dnu)], axis=1),
    ], axis=0)
    rhs = jnp.concatenate([-q, mask * b])
    lu, piv = jax.scipy.linalg.lu_factor(KKT_reg)
    sol = jax.scipy.linalg.lu_solve((lu, piv), rhs)
    # two steps of iterative refinement against the UNregularized system
    KKT0 = jnp.concatenate([
        jnp.concatenate([P, AtM], axis=1),
        jnp.concatenate([AtM.T, -jnp.diag(jnp.where(act, 0.0, 1.0)
                                          .astype(dtype))], axis=1),
    ], axis=0)
    # refinement residual in df32 (qp/precision.py): a plain f32 matvec has an
    # accumulation floor of ~n*eps*|terms| ~ 1e-4 in the unscaled frame, which
    # was the measured parity bottleneck vs the f64 oracle
    for _ in range(3):
        sol = sol + jax.scipy.linalg.lu_solve(
            (lu, piv), residual_matvec(rhs, KKT0, sol))
    xp = sol[:n]
    yp = sol[n:] * mask

    # acceptance by KKT residual, computed in df32 (qp/precision.py): the MPC
    # QP's tiny force-regularization curvature leaves near-flat valleys where
    # objective differences of ~1e-12 correspond to x differences of ~1e-4 —
    # an f32 objective/merit comparison is pure noise there and was observed
    # rejecting strictly better polished points.  Stationarity |Px + q + A'y|
    # and feasibility violation compare decisively (1e-6 vs 1e-4 scale).
    # Dual-sign checks are not used: they misfire on the degenerate swing-foot
    # rows (both pyramid sides tight at mu*fz = 0).
    def kkt_err(x_, y_):
        Ax_ = A @ x_
        viol = jnp.maximum(jnp.max(jnp.maximum(Ax_ - u, 0.0)),
                           jnp.max(jnp.maximum(l - Ax_, 0.0)))
        stat = jnp.max(jnp.abs(residual_matvec(-(q + A.T @ y_), P, x_)))
        return jnp.maximum(stat, viol)

    ok = kkt_err(xp, yp) <= kkt_err(x, y)
    x_out = jnp.where(ok, xp, x)
    y_out = jnp.where(ok, yp, y)
    return x_out, y_out

"""JAX centroidal MPC: batched SRB discretization, condensation, QP assembly.

Functional twin of oracle/mpc.py (the float64 reference; BASELINE.json:5,7 —
12-state SRB, horizon 16, dt 20 ms, friction pyramid + force bounds, swing
forces pinned to zero).  The horizon recursion (condensation) is unrolled at
trace time (N = 16 static), producing pure batched matmuls; everything vmaps
over scenarios (BASELINE.json:8 "batched 256 MPC QPs").

State x = [p(3), rpy(3), v(3), w_world(3)]; input u = 4 stacked forces (12,).
Single-sample layout; batch with jax.vmap.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from mpctsid_tpu.config import MpcConfig
from mpctsid_tpu.model.solo12 import Solo12Model
from mpctsid_tpu.qp.admm import INF, admm_solve
from mpctsid_tpu.utils import f32_matmuls

NX = 12
NU = 12
N_FEET = 4
ROWS_PER_FOOT = 5


def rot_z(yaw):
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    z = jnp.zeros_like(yaw)
    o = jnp.ones_like(yaw)
    return jnp.stack([
        jnp.stack([c, -s, z], -1),
        jnp.stack([s, c, z], -1),
        jnp.stack([z, z, o], -1),
    ], -2)


def _skew(r):
    z = jnp.zeros_like(r[..., 0])
    return jnp.stack([
        jnp.stack([z, -r[..., 2], r[..., 1]], -1),
        jnp.stack([r[..., 2], z, -r[..., 0]], -1),
        jnp.stack([-r[..., 1], r[..., 0], z], -1),
    ], -2)


def reference_rollout(model: Solo12Model, cfg: MpcConfig, x0, v_cmd):
    """(N,12) reference states x_1..x_N from the commanded velocity.

    Mirrors oracle/mpc.py reference_rollout (SURVEY.md §2.1 rollout row)."""
    N = cfg.horizon
    dt = cfg.dt

    def step(carry, _):
        p, yaw = carry
        Rz = rot_z(yaw)
        v_world = Rz @ jnp.array([v_cmd[0], v_cmd[1], 0.0], dtype=p.dtype)
        p_n = p + dt * v_world
        yaw_n = yaw + dt * v_cmd[2]
        x = jnp.concatenate([
            jnp.stack([p_n[0], p_n[1], jnp.asarray(model.h_ref, p.dtype)]),
            jnp.stack([jnp.zeros_like(yaw), jnp.zeros_like(yaw), yaw_n]),
            v_world,
            jnp.stack([jnp.zeros_like(yaw), jnp.zeros_like(yaw), v_cmd[2]]),
        ])
        return (p_n, yaw_n), x

    (_, _), xs = jax.lax.scan(step, (x0[0:3], x0[5]), None, length=N)
    return xs


def srb_discrete(model: Solo12Model, cfg: MpcConfig, yaw, feet, p_ref,
                 total_mass=None):
    """One-step Euler (A(12,12), B(12,12), c(12)); mirrors oracle srb_discrete.

    total_mass: optional traced override of model.total_mass — the SRB-model
    side of a per-scenario payload perturbation (BASELINE.json:9)."""
    dt = cfg.dt
    dtype = feet.dtype
    if total_mass is None:
        total_mass = jnp.asarray(model.total_mass, dtype)
    Rz = rot_z(yaw)
    I_b = jnp.asarray(model.srb_inertia, dtype)
    I_w = Rz @ I_b @ Rz.T
    I_w_inv = jnp.linalg.inv(I_w)

    A = jnp.eye(NX, dtype=dtype)
    A = A.at[0:3, 6:9].set(dt * jnp.eye(3, dtype=dtype))
    A = A.at[3:6, 9:12].set(dt * Rz.T)

    r = feet - p_ref[None]                        # (4,3)
    Bw = dt * jnp.einsum("ij,fjk->fik", I_w_inv, _skew(r))   # (4,3,3)
    Bv = (dt / total_mass) * jnp.broadcast_to(
        jnp.eye(3, dtype=dtype), (4, 3, 3))
    B = jnp.zeros((NX, NU), dtype)
    B = B.at[6:9].set(jnp.concatenate([Bv[i] for i in range(4)], axis=1))
    B = B.at[9:12].set(jnp.concatenate([Bw[i] for i in range(4)], axis=1))

    c = jnp.zeros(NX, dtype).at[8].set(-dt * model.g)
    return A, B, c


def _pyramid_block(mu: float, dtype) -> jnp.ndarray:
    return jnp.asarray(np.array([
        [1.0, 0.0, -mu],
        [1.0, 0.0, mu],
        [0.0, 1.0, -mu],
        [0.0, 1.0, mu],
        [0.0, 0.0, 1.0],
    ]), dtype)


@f32_matmuls
def build_mpc_qp(model: Solo12Model, cfg: MpcConfig, x0, x_ref, feet, contacts,
                 total_mass=None):
    """Condensed MPC QP (P, q, A, l, u) over U in R^{12N}.

    x0 (12,), x_ref (N,12), feet (N,4,3), contacts (N,4) in {0,1}.
    total_mass: optional traced per-scenario mass (payload perturbation)."""
    N = cfg.horizon
    dtype = x0.dtype

    # all N one-step models in one batched op (vmap over the horizon index)
    A_ks, B_ks, c_ks = jax.vmap(
        lambda yaw, ft, pr: srb_discrete(model, cfg, yaw, ft, pr,
                                         total_mass=total_mass))(
            x_ref[:, 5], feet, x_ref[:, 0:3])          # (N,12,12)(N,12,12)(N,12)

    # condensation as a scan over the horizon: each step is ONE row-level
    # matmul (12,12)@(12,12N) instead of k block-level (12,12)@(12,12)
    # matmuls — 16 batched ops total, not N(N+1)/2 = 136 tiny matmuls, each
    # its own launch in the unrolled block form.
    def cond_step(carry, inp):
        Sx_p, Sc_p, Su_p = carry                        # (12,12),(12,),(12,12N)
        A_k, B_k, c_k, k = inp
        Sx_k = A_k @ Sx_p
        Sc_k = A_k @ Sc_p + c_k
        Su_k = A_k @ Su_p
        Su_k = jax.lax.dynamic_update_slice(Su_k, B_k, (0, k * NU))
        return (Sx_k, Sc_k, Su_k), (Sx_k, Sc_k, Su_k)

    init = (jnp.eye(NX, dtype=dtype), jnp.zeros(NX, dtype),
            jnp.zeros((NX, N * NU), dtype))
    _, (Sx_r, Sc_r, Su_r) = jax.lax.scan(
        cond_step, init, (A_ks, B_ks, c_ks, jnp.arange(N)))
    Su = Su_r.reshape(N * NX, N * NU)                    # (12N,12N)
    Sx = Sx_r.reshape(N * NX, NX)                        # (12N,12)
    Sc = Sc_r.reshape(N * NX)                            # (12N,)

    q_diag = jnp.tile(jnp.asarray(cfg.q_diag, dtype), N)
    P = Su.T @ (q_diag[:, None] * Su) + cfg.w_force * jnp.eye(N * NU, dtype=dtype)
    drift = Sx @ x0 + Sc - x_ref.reshape(-1)
    q = Su.T @ (q_diag * drift)

    # Swing-foot forces are pinned by a large ridge instead of l = u = 0
    # constraint rows: the oracle's row formulation makes the active set
    # rank-deficient at mu*fz = 0 (5 rows, rank 3), which breaks any
    # device-side KKT polish.  The ridge shifts the solution by O(|q|/w_pin)
    # ~ 1e-6 N — far below the 1e-4 parity budget (BASELINE.json:5).
    w_pin = 1e6
    pin = w_pin * (1.0 - jnp.repeat(contacts.reshape(-1), 3))
    P = P + jnp.diag(pin.astype(dtype))

    # constraints: block-diagonal 5x3 pyramid per (step, foot) — constant matrix
    C_np = np.array([[1.0, 0.0, -cfg.mu], [1.0, 0.0, cfg.mu],
                     [0.0, 1.0, -cfg.mu], [0.0, 1.0, cfg.mu],
                     [0.0, 0.0, 1.0]])
    A_np = np.zeros((N * N_FEET * ROWS_PER_FOOT, N * NU))
    for kf in range(N * N_FEET):
        A_np[kf * ROWS_PER_FOOT:(kf + 1) * ROWS_PER_FOOT,
             kf * 3:(kf + 1) * 3] = C_np
    A_c = jnp.asarray(A_np, dtype)
    # bounds: stance feet get the pyramid/box rows; swing feet rows are FREE
    # (their forces are pinned by the ridge above, keeping every possible
    # active set full-rank)
    cvec = contacts.reshape(-1)  # (N*4,)
    stance = cvec > 0.5
    l_blk = jnp.stack([
        jnp.full_like(cvec, -INF),
        jnp.where(stance, 0.0, -INF),
        jnp.full_like(cvec, -INF),
        jnp.where(stance, 0.0, -INF),
        jnp.where(stance, cfg.fz_min, -INF),
    ], axis=-1).reshape(-1)
    u_blk = jnp.stack([
        jnp.where(stance, 0.0, INF),
        jnp.full_like(cvec, INF),
        jnp.where(stance, 0.0, INF),
        jnp.full_like(cvec, INF),
        jnp.where(stance, cfg.fz_max, INF),
    ], axis=-1).reshape(-1)
    return P, q, A_c, l_blk, u_blk


@f32_matmuls
@partial(jax.jit, static_argnames=("model", "cfg", "iters"))
def solve_mpc_batch(model: Solo12Model, cfg: MpcConfig,
                    x0, x_ref, feet, contacts,
                    warm_x=None, warm_y=None, iters: int = 200):
    """Batched MPC solve: all args carry a leading batch dim.

    Returns (forces (B,N,4,3), QPSolution)."""

    def one(x0_, xref_, feet_, cont_, wx, wy):
        P, q, A, l, u = build_mpc_qp(model, cfg, x0_, xref_, feet_, cont_)
        return admm_solve(P, q, A, l, u, x0=wx, y0=wy, iters=iters)

    sol = jax.vmap(one)(x0, x_ref, feet, contacts,
                        warm_x if warm_x is not None else jnp.zeros(
                            (x0.shape[0], cfg.horizon * NU), x0.dtype),
                        warm_y if warm_y is not None else jnp.zeros(
                            (x0.shape[0],
                             cfg.horizon * N_FEET * ROWS_PER_FOOT), x0.dtype))
    B = x0.shape[0]
    forces = sol.x.reshape(B, cfg.horizon, N_FEET, 3)
    return forces, sol

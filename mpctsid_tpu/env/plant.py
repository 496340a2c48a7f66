"""JAX batched plant: whole-body dynamics + penalty ground contacts.

Functional twin of oracle/sim.py (which replaces the reference's PyBullet plant,
SURVEY.md §2.1 "Simulator"), with the same implicit-damping contact integration:

    (M + h J' D J) v+ = M v + h (tau_gen - bias + J' f_elastic)

then Coulomb-cone / unilateral clamping with anchor dragging, recomputing the
velocity explicitly with the (bounded) clamped forces where clamping occurred.
All contact switching is masked arithmetic — no data-dependent control flow —
so the step vmaps across thousands of scenarios (BASELINE.json:10-11
"Monte-Carlo rollouts").  Per-scenario friction / contact parameters are data,
enabling the mu/load perturbation batches of BASELINE.json:9.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mpctsid_tpu import dyn
from mpctsid_tpu.model.tree import NV, KinematicTree
from mpctsid_tpu.qp.blockinv import spd_inverse


@dataclasses.dataclass
class ContactParams:
    kp_n: jnp.ndarray    # normal spring
    kd_n: jnp.ndarray    # normal damper
    kp_t: jnp.ndarray    # tangential anchor spring
    kd_t: jnp.ndarray    # tangential damper
    mu: jnp.ndarray      # friction coefficient

    @staticmethod
    def default(dtype=jnp.float32) -> "ContactParams":
        f = lambda v: jnp.asarray(v, dtype)
        return ContactParams(kp_n=f(8000.0), kd_n=f(100.0),
                             kp_t=f(2000.0), kd_t=f(30.0), mu=f(0.7))


jax.tree_util.register_dataclass(
    ContactParams, data_fields=["kp_n", "kd_n", "kp_t", "kd_t", "mu"],
    meta_fields=[])


@dataclasses.dataclass
class PlantState:
    q: jnp.ndarray          # (19,)
    v: jnp.ndarray          # (18,)
    anchor: jnp.ndarray     # (4,2)
    in_contact: jnp.ndarray # (4,) float {0,1}

    @staticmethod
    def init(q, v=None) -> "PlantState":
        v = jnp.zeros(NV, q.dtype) if v is None else v
        return PlantState(q=q, v=v, anchor=jnp.zeros((4, 2), q.dtype),
                          in_contact=jnp.zeros(4, q.dtype))


jax.tree_util.register_dataclass(
    PlantState, data_fields=["q", "v", "anchor", "in_contact"], meta_fields=[])


def _substep(tree: KinematicTree, st: PlantState, tau, h_dt, p: ContactParams,
             extra_base_inertia=None):
    q, v = st.q, st.v
    dtype = q.dtype
    M = dyn.crba(tree, q, extra_base_inertia=extra_base_inertia)
    bias = dyn.rnea(tree, q, v, jnp.zeros(NV, dtype),
                    extra_base_inertia=extra_base_inertia)
    feet = dyn.foot_positions(tree, q)      # (4,3)
    J = dyn.foot_jacobians(tree, q)         # (4,3,18)

    below = feet[:, 2] < 0.0
    new_contact = below & (st.in_contact < 0.5)
    anchor = jnp.where(new_contact[:, None], feet[:, 0:2], st.anchor)
    in_c = below.astype(dtype)

    # elastic forces (world): anchored tangential spring + normal spring
    f_el = jnp.concatenate([
        -p.kp_t * (feet[:, 0:2] - anchor),
        (-p.kp_n * feet[:, 2])[:, None],
    ], axis=-1) * in_c[:, None]

    D = jnp.diag(jnp.stack([p.kd_t, p.kd_t, p.kd_n]))
    tau_gen = jnp.concatenate([jnp.zeros(6, dtype), tau])

    # implicit damping: M_eff = M + h * sum_active J' D J
    JDJ = jnp.einsum("fai,ab,f,fbj->ij", J, D, in_c, J)
    M_eff = M + h_dt * JDJ
    rhs = M @ v + h_dt * (tau_gen - bias
                          + jnp.einsum("fai,fa->i", J, f_el))
    # M and M_eff are SPD with cond ~ 1e2: the blocked Schur inverse
    # (qp/blockinv.py) is exact to ~cond * eps_f32 here and matmul-only.
    M_inv = spd_inverse(M)
    v_imp = spd_inverse(M_eff) @ rhs

    # contact forces at the implicit velocity, then clamp
    foot_vel = jnp.einsum("fai,i->fa", J, v_imp)
    f_raw = f_el - jnp.einsum("ab,fb->fa", D, foot_vel) * in_c[:, None]
    fz = jnp.maximum(f_raw[:, 2], 0.0)
    ft = f_raw[:, 0:2]
    limit = p.mu * fz
    ft_norm = jnp.linalg.norm(ft, axis=-1)
    scale = jnp.where(ft_norm > limit,
                      limit / jnp.maximum(ft_norm, 1e-12), 1.0)
    ft_cl = ft * scale[:, None]
    clamped = (ft_norm > limit) | (f_raw[:, 2] < 0.0)
    # drag anchors for sliding feet so the spring sits on the cone
    slid = (ft_norm > limit) & (in_c > 0.5)
    anchor = jnp.where(
        slid[:, None],
        feet[:, 0:2] + (ft_cl + p.kd_t * foot_vel[:, 0:2]) / p.kp_t,
        anchor)
    f_cl = jnp.concatenate([ft_cl, fz[:, None]], axis=-1) * in_c[:, None]

    # explicit recomputation with clamped (bounded) forces where clamping hit
    rhs_cl = M @ v + h_dt * (tau_gen - bias
                             + jnp.einsum("fai,fa->i", J, f_cl))
    v_exp = M_inv @ rhs_cl
    any_cl = jnp.any(clamped & (in_c > 0.5))
    v_new = jnp.where(any_cl, v_exp, v_imp)

    q_new = dyn.integrate_q(q, v_new, h_dt)
    return PlantState(q=q_new, v=v_new, anchor=anchor, in_contact=in_c), f_cl


def plant_step(tree: KinematicTree, st: PlantState, tau,
               dt: float = 0.001, substeps: int = 2,
               params: ContactParams | None = None,
               extra_base_inertia=None):
    """One 1 kHz plant step under joint torques tau (12,).

    extra_base_inertia: optional traced (6,6) base spatial-inertia addend —
    the TRUE payload carried by the plant in load-perturbation batches
    (BASELINE.json:9); per-scenario data under vmap.

    Returns (new_state, ground_forces (4,3) from the last substep)."""
    params = params or ContactParams.default(st.q.dtype)
    h_dt = dt / substeps
    f = jnp.zeros((4, 3), st.q.dtype)
    for _ in range(substeps):
        st, f = _substep(tree, st, tau, h_dt, params,
                         extra_base_inertia=extra_base_inertia)
    return st, f

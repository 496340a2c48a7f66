"""JAX rigid-body dynamics for the fixed Solo-12 topology (replaces Pinocchio).

Functional twin of oracle/dynamics.py (SURVEY.md §2.1 native table: "from-scratch
JAX rigid-body dynamics ... closed-form per-link chain, vmap/jit-compiled"), with
the same conventions:

  q = [p_base(3), quat_xyzw(4), q_joints(12)]  (19,)
  v = [v_base_linear_LOCAL(3), w_base_LOCAL(3), qdot(12)]  (18,)

Batched structure: the four legs are IDENTICAL base->HAA->HFE->KFE chains
(model/tree.py), so every per-body recursion here is computed for all four legs
at once as (4, ...) batched tensor ops — a ~4x smaller XLA graph than a
13-body loop and wider ops.  The resulting mass matrix is
exactly block-structured: dense 6x6 base block, 6x12 base-leg coupling, and a
block-diagonal 12x12 joint block (legs only couple through the base).

Everything is single-sample; batch over scenarios with jax.vmap
(BASELINE.json:5 "vmapped across thousands of scenarios").
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from mpctsid_tpu.model.solo12 import Solo12Model
from mpctsid_tpu.model.tree import NV, KinematicTree, build_tree

GRAV = 9.81


# ---------------------------------------------------------------- constants

class LegConsts:
    """Trace-time constants describing the 4 identical leg chains."""

    def __init__(self, tree: KinematicTree):
        # per-level placements in the parent frame, (4,3)
        self.pl_hip = np.asarray(tree.placement[[1, 4, 7, 10]])
        self.pl_upper = np.asarray(tree.placement[[2, 5, 8, 11]])
        self.pl_lower = np.asarray(tree.placement[[3, 6, 9, 12]])
        self.foot_off = np.asarray(tree.foot_offset)
        # per-level spatial inertias (shared across legs), (6,6)
        self.I_hip = _spatial_inertia(tree, 1)
        self.I_upper = _spatial_inertia(tree, 2)
        self.I_lower = _spatial_inertia(tree, 3)
        self.I_base = _spatial_inertia(tree, 0)
        for b in (4, 7, 10):
            assert np.allclose(_spatial_inertia(tree, b), self.I_hip)
        self.mass = np.asarray(tree.mass)


def _spatial_inertia(tree: KinematicTree, b: int) -> np.ndarray:
    m = tree.mass[b]
    c = tree.com[b]
    C = np.array([[0.0, -c[2], c[1]], [c[2], 0.0, -c[0]], [-c[1], c[0], 0.0]])
    out = np.zeros((6, 6))
    out[0:3, 0:3] = tree.inertia[b] + m * (C @ C.T)
    out[0:3, 3:6] = m * C
    out[3:6, 0:3] = m * C.T
    out[3:6, 3:6] = m * np.eye(3)
    return out


def quat_to_rot(quat_xyzw):
    x, y, z, w = quat_xyzw[0], quat_xyzw[1], quat_xyzw[2], quat_xyzw[3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n
    return jnp.stack([
        jnp.stack([1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)]),
        jnp.stack([s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)]),
        jnp.stack([s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)]),
    ])


def _rx(q):
    """(4,) angles -> (4,3,3) rotations about +x."""
    c, s = jnp.cos(q), jnp.sin(q)
    z = jnp.zeros_like(q)
    o = jnp.ones_like(q)
    return jnp.stack([
        jnp.stack([o, z, z], -1),
        jnp.stack([z, c, -s], -1),
        jnp.stack([z, s, c], -1),
    ], -2)


def _ry(q):
    """(4,) angles -> (4,3,3) rotations about +y."""
    c, s = jnp.cos(q), jnp.sin(q)
    z = jnp.zeros_like(q)
    o = jnp.ones_like(q)
    return jnp.stack([
        jnp.stack([c, z, s], -1),
        jnp.stack([z, o, z], -1),
        jnp.stack([-s, z, c], -1),
    ], -2)


def _mm(A, B):
    """Batched (…,3,3)@(…,3,3)."""
    return jnp.einsum("...ij,...jk->...ik", A, B)


def _mv(A, x):
    """Batched (…,3,3)@(…,3)."""
    return jnp.einsum("...ij,...j->...i", A, x)


def _skew(r):
    """(...,3) -> (...,3,3)."""
    z = jnp.zeros_like(r[..., 0])
    return jnp.stack([
        jnp.stack([z, -r[..., 2], r[..., 1]], -1),
        jnp.stack([r[..., 2], z, -r[..., 0]], -1),
        jnp.stack([-r[..., 1], r[..., 0], z], -1),
    ], -2)


class LegKin:
    """Per-configuration leg-batched kinematics cache (all (4, ...) arrays)."""

    __slots__ = ("R0", "p0", "Rr_hip", "Rr_upper", "Rr_lower",
                 "R_hip", "R_upper", "R_lower",
                 "p_hip", "p_upper", "p_lower", "p_foot", "C")

    def __init__(self, C: LegConsts, q):
        self.C = C
        self.R0 = quat_to_rot(q[3:7])
        self.p0 = q[0:3]
        ql = q[7:].reshape(4, 3)
        self.Rr_hip = _rx(ql[:, 0])
        self.Rr_upper = _ry(ql[:, 1])
        self.Rr_lower = _ry(ql[:, 2])
        self.R_hip = _mm(self.R0[None], self.Rr_hip)
        self.p_hip = self.p0[None] + _mv(self.R0, jnp.asarray(C.pl_hip))
        self.R_upper = _mm(self.R_hip, self.Rr_upper)
        self.p_upper = self.p_hip + _mv(self.R_hip, jnp.asarray(C.pl_upper))
        self.R_lower = _mm(self.R_upper, self.Rr_lower)
        self.p_lower = self.p_upper + _mv(self.R_upper, jnp.asarray(C.pl_lower))
        self.p_foot = self.p_lower + _mv(self.R_lower, jnp.asarray(C.foot_off))


AX_HAA = np.array([1.0, 0.0, 0.0])
AX_HFE = np.array([0.0, 1.0, 0.0])


def _leg_levels(C: LegConsts):
    """(placement(4,3), axis(3,), R_rel attr, inertia) per level, root-first."""
    return (
        (C.pl_hip, AX_HAA, "Rr_hip", C.I_hip),
        (C.pl_upper, AX_HFE, "Rr_upper", C.I_upper),
        (C.pl_lower, AX_HFE, "Rr_lower", C.I_lower),
    )


def foot_positions(tree_or_consts, q):
    C = _consts(tree_or_consts)
    return LegKin(C, q).p_foot


_CONSTS_CACHE: dict[int, LegConsts] = {}


def _consts(tree_or_consts) -> LegConsts:
    if isinstance(tree_or_consts, LegConsts):
        return tree_or_consts
    key = id(tree_or_consts)
    if key not in _CONSTS_CACHE:
        _CONSTS_CACHE[key] = LegConsts(tree_or_consts)
    return _CONSTS_CACHE[key]


def fk(tree_or_consts, q):
    """Compatibility helper: returns the LegKin cache."""
    return LegKin(_consts(tree_or_consts), q)


def point_mass_spatial(m, r=None, dtype=jnp.float32):
    """(6,6) spatial inertia ([ang; lin] convention) of a point mass m rigidly
    attached to the base at offset r (default: the base origin).

    This is the per-scenario LOAD perturbation hook (BASELINE.json:9 "mu/load
    perturbation batches"): m is DATA, so a payload spread vmaps across a
    scenario batch while the LegConsts stay trace-time constants."""
    m = jnp.asarray(m, dtype)
    out = jnp.zeros((6, 6), dtype)
    out = out.at[3, 3].set(m).at[4, 4].set(m).at[5, 5].set(m)
    if r is not None:
        S = _skew(jnp.asarray(r, dtype))
        out = out.at[0:3, 0:3].set(m * (S @ S.T))
        out = out.at[0:3, 3:6].set(m * S)
        out = out.at[3:6, 0:3].set(m * S.T)
    return out


def rnea(tree_or_consts, q, v, a, gravity: float = GRAV,
         extra_base_inertia=None):
    """tau(18,) = M(q) a + C(q,v) v + g(q);  a = 0 gives the bias vector h.

    extra_base_inertia: optional traced (6,6) spatial inertia added to the
    base body (payload perturbations; see point_mass_spatial)."""
    C = _consts(tree_or_consts)
    k = LegKin(C, q)
    qd = v[6:].reshape(4, 3)
    qdd = a[6:].reshape(4, 3)

    # base (local coords)
    w0, v0 = v[3:6], v[0:3]
    wd0 = a[3:6]
    vd0 = a[0:3] + k.R0.T @ jnp.array([0.0, 0.0, gravity])

    # forward pass, batched over legs
    w_par = jnp.broadcast_to(w0, (4, 3))
    v_par = jnp.broadcast_to(v0, (4, 3))
    wd_par = jnp.broadcast_to(wd0, (4, 3))
    vd_par = jnp.broadcast_to(vd0, (4, 3))
    lv = []
    for lvl, (pl, ax, rattr, I6) in enumerate(_leg_levels(C)):
        Rr = getattr(k, rattr)
        RrT = jnp.swapaxes(Rr, -1, -2)
        pl_j = jnp.asarray(pl)
        ax_j = jnp.asarray(ax)
        wc = _mv(RrT, w_par)
        vc = _mv(RrT, v_par + jnp.cross(w_par, pl_j))
        w_b = wc + ax_j[None] * qd[:, lvl:lvl + 1]
        v_b = vc
        wdc = _mv(RrT, wd_par)
        vdc = _mv(RrT, vd_par + jnp.cross(wd_par, pl_j))
        wd_b = wdc + ax_j[None] * qdd[:, lvl:lvl + 1] + jnp.cross(
            w_b, ax_j[None] * qd[:, lvl:lvl + 1])
        vd_b = vdc + jnp.cross(v_b, ax_j[None] * qd[:, lvl:lvl + 1])
        lv.append((w_b, v_b, wd_b, vd_b, I6, Rr, pl_j, ax_j))
        w_par, v_par, wd_par, vd_par = w_b, v_b, wd_b, vd_b

    # body wrenches (batched): f = I a + v x* I v
    def wrench(w, vl, wd, vd, I6):
        I6j = jnp.asarray(I6)
        mom = jnp.concatenate([w, vl], axis=-1)
        acc = jnp.concatenate([wd, vd], axis=-1)
        Iv = jnp.einsum("ij,...j->...i", I6j, mom)
        fb = jnp.einsum("ij,...j->...i", I6j, acc)
        n = fb[..., 0:3] + jnp.cross(w, Iv[..., 0:3]) + jnp.cross(vl, Iv[..., 3:6])
        f = fb[..., 3:6] + jnp.cross(w, Iv[..., 3:6])
        return n, f

    # base wrench
    I_base = jnp.asarray(C.I_base, q.dtype)
    if extra_base_inertia is not None:
        I_base = I_base + extra_base_inertia
    n0, f0 = wrench(w0, v0, wd0, vd0, I_base)

    # backward pass over the 3 levels
    taus = [None, None, None]
    n_child = f_child = None
    for lvl in range(2, -1, -1):
        w_b, v_b, wd_b, vd_b, I6, Rr, pl_j, ax_j = lv[lvl]
        n_b, f_b = wrench(w_b, v_b, wd_b, vd_b, I6)
        if n_child is not None:
            n_b = n_b + n_child
            f_b = f_b + f_child
        taus[lvl] = jnp.einsum("j,...j->...", ax_j, n_b)
        # transform into parent coords
        fP = _mv(Rr, f_b)
        nP = _mv(Rr, n_b) + jnp.cross(pl_j, fP)
        n_child, f_child = nP, fP

    n0 = n0 + n_child.sum(axis=0)
    f0 = f0 + f_child.sum(axis=0)
    tau_j = jnp.stack(taus, axis=-1).reshape(12)
    return jnp.concatenate([f0, n0, tau_j])


def crba(tree_or_consts, q, extra_base_inertia=None):
    """Mass matrix M(q) (18,18): dense base block, 6x12 coupling, block-diag legs.

    extra_base_inertia: optional traced (6,6) base-body spatial inertia addend
    (payload perturbations; see point_mass_spatial)."""
    C = _consts(tree_or_consts)
    k = LegKin(C, q)

    def spatial_X(Rr, pl):
        """(4,6,6) motion transform child <- parent; pl is (4,3)."""
        RrT = jnp.swapaxes(Rr, -1, -2)
        zero = jnp.zeros_like(RrT)
        top = jnp.concatenate([RrT, zero], axis=-1)
        bot = jnp.concatenate(
            [_mm(RrT, jnp.swapaxes(_skew(pl), -1, -2)), RrT], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)

    levels = _leg_levels(C)
    # composite inertias per level, (4,6,6)
    Ic_lower = jnp.broadcast_to(jnp.asarray(C.I_lower), (4, 6, 6))
    X_lower = spatial_X(k.Rr_lower, jnp.asarray(levels[2][0]))
    Ic_upper = jnp.asarray(C.I_upper)[None] + jnp.einsum(
        "lji,ljk,lkm->lim", X_lower, Ic_lower, X_lower)
    X_upper = spatial_X(k.Rr_upper, jnp.asarray(levels[1][0]))
    Ic_hip = jnp.asarray(C.I_hip)[None] + jnp.einsum(
        "lji,ljk,lkm->lim", X_upper, Ic_upper, X_upper)
    X_hip = spatial_X(k.Rr_hip, jnp.asarray(levels[0][0]))
    Ic_base = jnp.asarray(C.I_base) + jnp.einsum(
        "lji,ljk,lkm->im", X_hip, Ic_hip, X_hip)
    if extra_base_inertia is not None:
        Ic_base = Ic_base + extra_base_inertia

    def xf_to_parent(Rr, pl, F):
        """(4,6) child-frame force -> parent frame."""
        fP = _mv(Rr, F[..., 3:6])
        nP = _mv(Rr, F[..., 0:3]) + jnp.cross(pl, fP)
        return jnp.concatenate([nP, fP], axis=-1)

    S_haa = jnp.concatenate([jnp.asarray(AX_HAA), jnp.zeros(3)])
    S_hfe = jnp.concatenate([jnp.asarray(AX_HFE), jnp.zeros(3)])

    # per-leg 3x3 blocks and base couplings, batched
    # KFE column
    F_k = jnp.einsum("lij,j->li", Ic_lower, S_hfe)          # (4,6)
    m_kk = jnp.einsum("j,lj->l", S_hfe, F_k)
    F_k_up = xf_to_parent(k.Rr_lower, jnp.asarray(levels[2][0]), F_k)
    m_hk = jnp.einsum("j,lj->l", S_hfe, F_k_up)
    F_k_hip = xf_to_parent(k.Rr_upper, jnp.asarray(levels[1][0]), F_k_up)
    m_ak = jnp.einsum("j,lj->l", S_haa, F_k_hip)
    F_k_base = xf_to_parent(k.Rr_hip, jnp.asarray(levels[0][0]), F_k_hip)
    # HFE column
    F_h = jnp.einsum("lij,j->li", Ic_upper, S_hfe)
    m_hh = jnp.einsum("j,lj->l", S_hfe, F_h)
    F_h_hip = xf_to_parent(k.Rr_upper, jnp.asarray(levels[1][0]), F_h)
    m_ah = jnp.einsum("j,lj->l", S_haa, F_h_hip)
    F_h_base = xf_to_parent(k.Rr_hip, jnp.asarray(levels[0][0]), F_h_hip)
    # HAA column
    F_a = jnp.einsum("lij,j->li", Ic_hip, S_haa)
    m_aa = jnp.einsum("j,lj->l", S_haa, F_a)
    F_a_base = xf_to_parent(k.Rr_hip, jnp.asarray(levels[0][0]), F_a)

    # assemble the block-diagonal joint block (12,12)
    zeros = jnp.zeros_like(m_aa)
    blocks = jnp.stack([
        jnp.stack([m_aa, m_ah, m_ak], -1),
        jnp.stack([m_ah, m_hh, m_hk], -1),
        jnp.stack([m_ak, m_hk, m_kk], -1),
    ], -2)  # (4,3,3)
    M_jj = jax.scipy.linalg.block_diag(*[blocks[i] for i in range(4)])

    # base coupling: spatial forces in base frame -> rows [lin; ang]
    def base_rows(F):  # (4,6) -> (6,4) columns
        return jnp.concatenate([F[..., 3:6], F[..., 0:3]], axis=-1).T

    cols = jnp.stack([F_a_base, F_h_base, F_k_base], axis=1)  # (4,3,6)
    cols = jnp.concatenate([cols[..., 3:6], cols[..., 0:3]], axis=-1)  # lin;ang
    M_bj = cols.reshape(12, 6).T  # (6,12)

    # base 6x6: [ang;lin] spatial inertia -> [lin;ang] generalized
    M_bb = jnp.concatenate([
        jnp.concatenate([Ic_base[3:6, 3:6], Ic_base[3:6, 0:3]], axis=1),
        jnp.concatenate([Ic_base[0:3, 3:6], Ic_base[0:3, 0:3]], axis=1),
    ], axis=0)

    top = jnp.concatenate([M_bb, M_bj], axis=1)
    bot = jnp.concatenate([M_bj.T, M_jj], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def foot_jacobians(tree_or_consts, q):
    """(4,3,18) world-frame linear-velocity Jacobians of the four feet.

    Joint columns are only filled for each foot's own leg (block structure)."""
    C = _consts(tree_or_consts)
    k = LegKin(C, q)
    R0 = k.R0
    p_foot = k.p_foot  # (4,3)
    # base columns
    r_local = jnp.einsum("ji,lj->li", R0, p_foot - k.p0[None])  # (4,3)
    base_lin = jnp.broadcast_to(R0, (4, 3, 3))
    base_ang = -_mm(base_lin, _skew(r_local))
    # joint columns (own leg only)
    ax_haa = _mv(k.R_hip, jnp.broadcast_to(jnp.asarray(AX_HAA), (4, 3)))
    ax_hfe = _mv(k.R_upper, jnp.broadcast_to(jnp.asarray(AX_HFE), (4, 3)))
    ax_kfe = _mv(k.R_lower, jnp.broadcast_to(jnp.asarray(AX_HFE), (4, 3)))
    col_haa = jnp.cross(ax_haa, p_foot - k.p_hip)
    col_hfe = jnp.cross(ax_hfe, p_foot - k.p_upper)
    col_kfe = jnp.cross(ax_kfe, p_foot - k.p_lower)
    leg_cols = jnp.stack([col_haa, col_hfe, col_kfe], axis=-1)  # (4,3,3)
    # scatter leg columns into (4,3,12) block-diagonal layout
    eye = jnp.eye(4)
    joint_cols = jnp.einsum("lk,lij->likj", eye, leg_cols).reshape(4, 3, 12)
    return jnp.concatenate([base_lin, base_ang, joint_cols], axis=-1)


def foot_velocities(tree_or_consts, q, v):
    J = foot_jacobians(tree_or_consts, q)
    return jnp.einsum("fij,j->fi", J, v)


def foot_drifts(tree_or_consts, q, v):
    """(4,3) world-frame Jdot @ v per foot (classical accel, qdd = 0, g off)."""
    C = _consts(tree_or_consts)
    k = LegKin(C, q)
    R0 = k.R0
    qd = v[6:].reshape(4, 3)
    w_par = jnp.broadcast_to(_mv(R0, v[3:6]), (4, 3))
    v_par = jnp.broadcast_to(_mv(R0, v[0:3]), (4, 3))
    a_par = jnp.broadcast_to(_mv(R0, jnp.cross(v[3:6], v[0:3])), (4, 3))
    al_par = jnp.zeros((4, 3))
    p_par = jnp.broadcast_to(k.p0, (4, 3))
    Rws = (k.R_hip, k.R_upper, k.R_lower)
    ps = (k.p_hip, k.p_upper, k.p_lower)
    axes = (AX_HAA, AX_HFE, AX_HFE)
    for lvl in range(3):
        r = ps[lvl] - p_par
        ax_w = _mv(Rws[lvl], jnp.broadcast_to(jnp.asarray(axes[lvl]), (4, 3)))
        w_b = w_par + ax_w * qd[:, lvl:lvl + 1]
        v_b = v_par + jnp.cross(w_par, r)
        al_b = al_par + jnp.cross(w_par, ax_w * qd[:, lvl:lvl + 1])
        a_b = (a_par + jnp.cross(al_par, r)
               + jnp.cross(w_par, jnp.cross(w_par, r)))
        w_par, v_par, al_par, a_par, p_par = w_b, v_b, al_b, a_b, ps[lvl]
    r = k.p_foot - k.p_lower
    return (a_par + jnp.cross(al_par, r)
            + jnp.cross(w_par, jnp.cross(w_par, r)))


def integrate_q(q, v, dt):
    """Integrate generalized velocity (local convention) over dt."""
    R0 = quat_to_rot(q[3:7])
    p = q[0:3] + R0 @ v[0:3] * dt
    w = v[3:6] * dt
    th2 = w @ w
    th = jnp.sqrt(th2 + 1e-30)
    half = th / 2.0
    sinc_half = jnp.where(th < 1e-8, 0.5 - th2 / 48.0, jnp.sin(half) / th)
    dq = jnp.concatenate([w * sinc_half, jnp.cos(half)[None]])
    x1, y1, z1, w1 = q[3], q[4], q[5], q[6]
    x2, y2, z2, w2 = dq[0], dq[1], dq[2], dq[3]
    quat = jnp.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])
    quat = quat / jnp.linalg.norm(quat)
    return jnp.concatenate([p, quat, q[7:] + v[6:] * dt])

"""The full MPC+TSID cascade as one fused device program.

Reference structure being reproduced (SURVEY.md §3.1-3.4): a 1 kHz WBC loop
with a 50 Hz MPC running in a second process, the WBC consuming the last
COMPLETED plan.  Batched restructuring (SURVEY.md §3 note): the cascade is a
`lax.scan` over MPC periods with an inner `lax.scan` over the `mpc_every` WBC
ticks — the cadence split is structural, not modulo-tested — and the
one-solve-stale handoff is a carried array: the plan solved in period p is
consumed in period p+1 (its column 1 covers p+1's prediction window); period 0
uses a gravity-compensation fallback, matching oracle/cascade.py exactly.

Everything here is single-scenario and vmaps across thousands of scenarios
(BASELINE.json:10 "4k batched scenario rollouts"), including per-scenario gait
id, velocity command, and plant friction (BASELINE.json:8-9).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from mpctsid_tpu import dyn
from mpctsid_tpu.config import EngineConfig
from mpctsid_tpu.env.plant import ContactParams, PlantState, plant_step
from mpctsid_tpu.model.solo12 import Solo12Model
from mpctsid_tpu.model.tree import build_tree
from mpctsid_tpu.mpc.srb import build_mpc_qp, reference_rollout
from mpctsid_tpu.utils import f32_matmuls
from mpctsid_tpu.plan.footsteps import plan_footsteps_horizon
from mpctsid_tpu.plan.gait import contacts_at, swing_tables
from mpctsid_tpu.plan.swing import swing_foot_ref
from mpctsid_tpu.qp.admm import admm_solve
from mpctsid_tpu.wbc.tsid import WbcRefs, solve_wbc

N_MPC_VARS = 192
N_MPC_ROWS = 320
N_WBC_VARS = 30
N_WBC_ROWS = 50


@dataclasses.dataclass
class ControllerState:
    phase: jnp.ndarray         # int32 scalar — gait phase (MPC periods)
    liftoff: jnp.ndarray       # (4,3)
    touchdown: jnp.ndarray     # (4,3)
    prev_contacts: jnp.ndarray # (4,)
    f_plan: jnp.ndarray        # (N,4,3) stale plan consumed this period
    mpc_warm_x: jnp.ndarray    # (192,)
    mpc_warm_y: jnp.ndarray    # (320,)
    wbc_warm_x: jnp.ndarray    # (30,)
    wbc_warm_y: jnp.ndarray    # (50,)
    v_int: jnp.ndarray         # (3,) velocity-error integral [vx, vy, wz]


jax.tree_util.register_dataclass(
    ControllerState,
    data_fields=["phase", "liftoff", "touchdown", "prev_contacts", "f_plan",
                 "mpc_warm_x", "mpc_warm_y", "wbc_warm_x", "wbc_warm_y",
                 "v_int"],
    meta_fields=[])


def srb_state(q, v):
    """Project full (q, v) onto the 12-dim SRB state [p, rpy, v_w, w_w]."""
    R0 = dyn.quat_to_rot(q[3:7])
    rpy = jnp.stack([
        jnp.arctan2(R0[2, 1], R0[2, 2]),
        -jnp.arcsin(jnp.clip(R0[2, 0], -1.0, 1.0)),
        jnp.arctan2(R0[1, 0], R0[0, 0]),
    ])
    return jnp.concatenate([q[0:3], rpy, R0 @ v[0:3], R0 @ v[3:6]])


@f32_matmuls
def init_controller(model: Solo12Model, cfg: EngineConfig, tree, q0,
                    gait_id, payload=None) -> ControllerState:
    dtype = q0.dtype
    feet = dyn.foot_positions(tree, q0) * jnp.asarray([1, 1, 0], dtype)
    contacts0 = contacts_at(gait_id, jnp.int32(0)).astype(dtype)
    n_st = jnp.maximum(contacts0.sum(), 1.0)
    mass = jnp.asarray(model.total_mass, dtype)
    if payload is not None:
        mass = mass + payload
    fb = jnp.zeros((cfg.mpc.horizon, 4, 3), dtype)
    fb = fb.at[:, :, 2].set(mass * model.g / n_st
                            * contacts0[None, :])
    return ControllerState(
        phase=jnp.int32(0),
        liftoff=feet, touchdown=feet, prev_contacts=contacts0,
        f_plan=fb,
        mpc_warm_x=jnp.zeros(N_MPC_VARS, dtype),
        mpc_warm_y=jnp.zeros(N_MPC_ROWS, dtype),
        wbc_warm_x=jnp.zeros(N_WBC_VARS, dtype),
        wbc_warm_y=jnp.zeros(N_WBC_ROWS, dtype),
        v_int=jnp.zeros(3, dtype),
    )


@dataclasses.dataclass(frozen=True)
class CascadeConfigured:
    """Static bundle: model + config + tree, hashable for jit closure."""

    model: Solo12Model
    cfg: EngineConfig

    def __post_init__(self):
        object.__setattr__(self, "_tree", build_tree(self.model))

    @property
    def tree(self):
        return self._tree


@f32_matmuls
def cascade_period(cc: CascadeConfigured, ctl: ControllerState,
                   plant: PlantState, gait_id, v_cmd,
                   contact_params: ContactParams,
                   est=None, use_estimator: bool = False,
                   est_mocap: bool = False,
                   mpc_iters: int = None, mpc_rounds: int = None,
                   wbc_iters: int = None, wbc_rounds: int = None,
                   payload=None, payload_known: bool = True):
    """One 20 ms MPC period: plan + MPC solve + mpc_every WBC/plant ticks.

    With use_estimator=True, the controller consumes the complementary-filter
    estimate (est/) fed by the plant's IMU + encoders instead of ground truth
    (SURVEY.md §3.2 "estimator.update" first in the tick).  By default the
    estimator is HINT-FREE: base x-y comes from integrating the fused
    velocity, drifting like the reference's leg-odometry does (SURVEY.md
    §3.5 — the reference has no mocap).  est_mocap=True feeds the plant's
    true base position as an external-position hint (the mocap/sim-truth
    analog; VERDICT.md round-4 missing #4 made hint-free the default).

    payload: optional traced scalar (kg) — a point mass rigidly attached at
    the base origin; per-scenario DATA under vmap (BASELINE.json:9 "mu/load
    perturbation batches").  The plant always carries it.  payload_known
    (static) controls whether the CONTROLLER models it too (SRB total mass +
    WBC mass matrix/gravity bias); False exercises unmodeled-load
    robustness."""
    from mpctsid_tpu.est.filter import estimator_update, imu_from_plant

    model, cfg, tree = cc.model, cc.cfg, cc.tree
    # solver budgets default from the config tree (SURVEY.md §5.6); explicit
    # kwargs (benches, A/B scripts, parity tests) override
    if mpc_iters is None:
        mpc_iters = cfg.solver.mpc_iters
    if mpc_rounds is None:
        mpc_rounds = cfg.solver.mpc_adapt_rounds
    if wbc_iters is None:
        wbc_iters = cfg.solver.wbc_iters
    if wbc_rounds is None:
        wbc_rounds = cfg.solver.wbc_adapt_rounds
    dtype = plant.q.dtype
    # payload spatial inertia: the plant truth always carries it; the
    # controller's dynamics see it only when payload_known
    plant_extra = (None if payload is None
                   else dyn.point_mass_spatial(payload, dtype=dtype))
    ctl_extra = plant_extra if payload_known else None
    ctl_mass = (None if (payload is None or not payload_known)
                else jnp.asarray(model.total_mass, dtype) + payload)
    phase = ctl.phase
    contacts = contacts_at(gait_id, phase).astype(dtype)

    q_ctl = est.q if use_estimator else plant.q
    v_ctl = est.v if use_estimator else plant.v
    feet_now = dyn.foot_positions(tree, q_ctl)
    x_srb = srb_state(q_ctl, v_ctl)

    # lift-off bookkeeping at stance->swing transitions
    to_swing = (contacts < 0.5) & (ctl.prev_contacts > 0.5)
    liftoff = jnp.where(to_swing[:, None], feet_now, ctl.liftoff)

    # Offset-free velocity tracking (config.py CascadeConfig.ki_vint): the
    # penalty plant's contact drag leaves a ~25% steady-state velocity sag
    # under pure proportional MPC tracking.  Integrate the body-frame
    # velocity error once per period and bias the command fed to the
    # planner + reference rollout; the clamp bounds windup.  Mirrored in
    # oracle/cascade.py for tick parity.
    cy, sy = jnp.cos(x_srb[5]), jnp.sin(x_srb[5])
    v_meas = jnp.stack([cy * x_srb[6] + sy * x_srb[7],
                        -sy * x_srb[6] + cy * x_srb[7],
                        x_srb[11]])
    t_period = cfg.cascade.mpc_every * cfg.cascade.wbc_dt
    v_int = jnp.clip(
        ctl.v_int + cfg.cascade.ki_vint * t_period * (v_cmd - v_meas),
        -cfg.cascade.v_int_max, cfg.cascade.v_int_max).astype(dtype)
    v_used = v_cmd + v_int

    # footstep plan + touchdown targets for swinging feet
    fsteps, next_td = plan_footsteps_horizon(
        model, cfg.mpc, cfg.cascade, gait_id, phase, x_srb, v_used, feet_now)
    touchdown = jnp.where((contacts < 0.5)[:, None], next_td, ctl.touchdown)

    # MPC solve from the current state (one-solve-stale: consumed NEXT period)
    x_ref = reference_rollout(model, cfg.mpc, x_srb, v_used)
    cont_h = jnp.stack([contacts_at(gait_id, phase + k).astype(dtype)
                        for k in range(cfg.mpc.horizon)])
    P, q_lin, A, l, u = build_mpc_qp(model, cfg.mpc, x_srb, x_ref, fsteps,
                                     cont_h, total_mass=ctl_mass)
    mpc_sol = admm_solve(P, q_lin, A, l, u,
                         x0=ctl.mpc_warm_x, y0=ctl.mpc_warm_y,
                         iters=mpc_iters, adapt_rounds=mpc_rounds, rho=0.1)
    # Infeasible/diverged-QP policy (SURVEY.md §5.3): on a bad solve, carry
    # the LAST FEASIBLE plan forward one period (shift columns, hold the
    # tail) instead of adopting garbage, and keep the previous warm start.
    # mpc_sol.ok is per-scenario under vmap, so one diverged scenario never
    # poisons its own rollout (let alone the batch).
    mpc_ok = mpc_sol.ok
    plan_solved = mpc_sol.x.reshape(cfg.mpc.horizon, 4, 3)
    plan_fallback = jnp.concatenate([ctl.f_plan[1:], ctl.f_plan[-1:]], axis=0)
    new_plan = jnp.where(mpc_ok, plan_solved, plan_fallback)
    mpc_warm_x = jnp.where(mpc_ok, mpc_sol.x, ctl.mpc_warm_x)
    mpc_warm_y = jnp.where(mpc_ok, mpc_sol.y, ctl.mpc_warm_y)

    # WBC consumes the stale plan's column covering the current period
    f_used = ctl.f_plan[1] * contacts[:, None]

    back, fwd, dur, stance_steps = swing_tables(gait_id, phase)
    T_swing = dur.astype(dtype) * cfg.mpc.dt
    mpc_every = cfg.cascade.mpc_every
    wbc_dt = cfg.cascade.wbc_dt

    def tick(carry, t):
        plant, est_s, wx, wy = carry
        if use_estimator:
            gyro, accel = imu_from_plant(tree, plant.q, plant.v)
            est_s = estimator_update(
                tree, est_s, gyro, accel, plant.q[7:], plant.v[6:],
                contacts, dt=wbc_dt,
                base_pos_hint=plant.q[0:3] if est_mocap else None)
            q_t, v_t = est_s.q, est_s.v
        else:
            q_t, v_t = plant.q, plant.v
        frac = t.astype(dtype) / mpc_every
        s = jnp.where(dur > 0, (back.astype(dtype) + frac)
                      / jnp.maximum(dur.astype(dtype), 1.0), 0.0)
        pos, vel, acc = swing_foot_ref(liftoff, touchdown, s, T_swing,
                                       cfg.cascade.swing_height)
        refs = WbcRefs(
            contacts=contacts, f_mpc=f_used,
            foot_pos_ref=pos, foot_vel_ref=vel, foot_acc_ref=acc,
            q_posture=jnp.asarray(model.q_stand, dtype),
            base_rpy_ref=jnp.zeros(2, dtype),
            h_ref=jnp.asarray(model.h_ref, dtype))
        tau_ff, qdd, f_wbc, wbc_sol = solve_wbc(
            tree, cfg.wbc, q_t, v_t, refs,
            iters=wbc_iters, adapt_rounds=wbc_rounds,
            warm_x=wx, warm_y=wy,
            extra_base_inertia=ctl_extra)
        # WBC failure containment (SURVEY.md §5.3): a non-finite/diverged
        # tick falls back to pure joint impedance toward the standing
        # posture (safety-damping analog of the reference's QP-failure
        # previous-plan policy) and keeps the previous warm start.
        wbc_ok = wbc_sol.ok
        tau_ff = jnp.where(wbc_ok,
                           jnp.clip(tau_ff, -cfg.wbc.tau_max, cfg.wbc.tau_max),
                           0.0)
        qdd_j = jnp.where(wbc_ok, qdd[6:], 0.0)
        # joint-impedance actuator (oracle/cascade.py ActuatorCommand)
        qd_des = jnp.where(wbc_ok, v_t[6:] + qdd_j * wbc_dt, 0.0)
        q_des = jnp.where(
            wbc_ok,
            q_t[7:] + v_t[6:] * wbc_dt + 0.5 * qdd_j * wbc_dt**2,
            jnp.asarray(model.q_stand, dtype))
        tau = jnp.clip(tau_ff + 6.0 * (q_des - plant.q[7:])
                       + 0.3 * (qd_des - plant.v[6:]),
                       -cfg.wbc.tau_max, cfg.wbc.tau_max)
        plant, f_ground = plant_step(tree, plant, tau, dt=wbc_dt,
                                     params=contact_params,
                                     extra_base_inertia=plant_extra)
        wx = jnp.where(wbc_ok, wbc_sol.x, wx)
        wy = jnp.where(wbc_ok, wbc_sol.y, wy)
        return (plant, est_s, wx, wy), (tau, f_ground, wbc_ok)

    (plant, est, wbc_wx, wbc_wy), (taus, f_grounds, wbc_oks) = jax.lax.scan(
        tick, (plant, est, ctl.wbc_warm_x, ctl.wbc_warm_y),
        jnp.arange(mpc_every))

    new_ctl = ControllerState(
        phase=phase + 1,
        liftoff=liftoff, touchdown=touchdown, prev_contacts=contacts,
        f_plan=new_plan,
        mpc_warm_x=mpc_warm_x, mpc_warm_y=mpc_warm_y,
        wbc_warm_x=wbc_wx, wbc_warm_y=wbc_wy, v_int=v_int)
    metrics = {
        "x_srb": x_srb,
        "tau_rms": jnp.sqrt(jnp.mean(taus ** 2)),
        "fz_sum": f_grounds[..., 2].sum(axis=-1).mean(),
        "mpc_prim_res": mpc_sol.prim_res,
        # dual (stationarity) residual |Px + q + A'y|_inf: guards quoted
        # numbers against "0.0 primal residual" being the only correctness
        # signal (VERDICT.md round-3 weak #4 — strictly-interior solutions
        # have prim 0 regardless of solution quality)
        "mpc_dual_res": mpc_sol.dual_res,
        # per-scenario solve-status vector (SURVEY.md §5.3)
        "mpc_ok": mpc_ok,
        "wbc_ok_frac": wbc_oks.astype(dtype).mean(),
    }
    if use_estimator:
        # odometry-frame drift of the hint-free estimator vs plant truth
        # (bounded by tests/test_estimator.py; stays 0 with est_mocap)
        metrics["est_xy_err"] = jnp.linalg.norm(est.q[0:2] - plant.q[0:2])
    return new_ctl, plant, est, metrics


@f32_matmuls
def cascade_rollout(cc: CascadeConfigured, ctl: ControllerState,
                    plant: PlantState, gait_id, v_cmd,
                    contact_params: ContactParams, n_periods: int,
                    est=None, use_estimator: bool = False,
                    payload=None, **solver_kw):
    """Roll n_periods MPC periods (n_periods * mpc_every WBC ticks).

    Returns (ctl, plant, metrics stacked over periods).  Single-scenario;
    vmap + shard_map over scenario batches (dist/).  payload: per-scenario
    base point mass (kg) — see cascade_period."""

    # v_cmd may be a single (3,) command or an (n_periods, 3) profile
    # (the reference's joystick / scripted velocity profiles,
    # SURVEY.md §2.1 "Command source")
    v_seq = jnp.broadcast_to(v_cmd, (n_periods, 3)) \
        if v_cmd.ndim == 1 else v_cmd

    def body(carry, v_k):
        ctl, plant, est_s = carry
        ctl, plant, est_s, metrics = cascade_period(
            cc, ctl, plant, gait_id, v_k, contact_params,
            est=est_s, use_estimator=use_estimator, payload=payload,
            **solver_kw)
        return (ctl, plant, est_s), metrics

    (ctl, plant, est), metrics = jax.lax.scan(body, (ctl, plant, est), v_seq)
    return ctl, plant, metrics

"""Host-side single-robot controller: the reference's `Controller.compute()`
surface (SURVEY.md §3.2, L6) wired to device solves through the native
real-time runtime.

Deployment shape (SURVEY.md §2.2 "MPC async wrapper"):

    1 kHz loop (RtExecutor / robot driver)          planner thread
    ------------------------------------            -----------------------
    sensors -> estimator -> HostController.compute  snapshot queue ->
      reads latest COMPLETED plan                     jitted device MPC solve
      (native PlanBuffer, one-solve-stale,            -> PlanBuffer.publish
       wait-free seqlock read)
      jitted device WBC solve -> torques

The batched simulation path (cascade/engine.py) fuses all of this into one
device program; THIS module is the deployment path for one physical robot,
where the 1 kHz loop is a host loop by necessity and the MPC must never block
it — the reference solved that with a second process + shared memory, here it
is a planner thread + the native wait-free PlanBuffer (native/rt_runtime.cc).

Use async_mpc=False for a synchronous (blocking) MPC at period boundaries —
deterministic, useful for tests and parity checks; async_mpc=True for the
deployment behavior.
"""

from __future__ import annotations

import functools
import queue
import threading

import numpy as np

import jax
import jax.numpy as jnp

from mpctsid_tpu import dyn
from mpctsid_tpu.cascade.engine import (N_MPC_ROWS, N_MPC_VARS, srb_state)
from mpctsid_tpu.config import EngineConfig
from mpctsid_tpu.model.gaits import GAIT_IDS
from mpctsid_tpu.model.solo12 import Solo12Model
from mpctsid_tpu.model.tree import build_tree
from mpctsid_tpu.mpc.srb import build_mpc_qp, reference_rollout
from mpctsid_tpu.plan.footsteps import plan_footsteps_horizon
from mpctsid_tpu.plan.gait import contacts_at, swing_tables
from mpctsid_tpu.plan.swing import swing_foot_ref
from mpctsid_tpu.qp.admm import admm_solve
from mpctsid_tpu.utils import f32_matmuls
from mpctsid_tpu.wbc.tsid import WbcRefs, solve_wbc

F32 = jnp.float32


class HostController:
    """compute(q, v) -> torques at the WBC rate; MPC solves never block."""

    # telemetry record layout (TELEM_LEN floats per 1 kHz tick):
    # [tick, phase, wbc_ok, tau_0..tau_11]
    TELEM_LEN = 15

    @f32_matmuls
    def __init__(self, model: Solo12Model, cfg: EngineConfig,
                 q0: np.ndarray, async_mpc: bool = False,
                 mpc_iters: int = None, mpc_rounds: int = None,
                 wbc_iters: int = None, wbc_rounds: int = None,
                 telemetry: bool = False):
        # solver budgets default from the config tree (engine.py parity)
        mpc_iters = cfg.solver.mpc_iters if mpc_iters is None else mpc_iters
        mpc_rounds = (cfg.solver.mpc_adapt_rounds if mpc_rounds is None
                      else mpc_rounds)
        wbc_iters = cfg.solver.wbc_iters if wbc_iters is None else wbc_iters
        wbc_rounds = (cfg.solver.wbc_adapt_rounds if wbc_rounds is None
                      else wbc_rounds)
        self.model = model
        self.cfg = cfg
        self.tree = build_tree(model)
        self.gid = jnp.int32(GAIT_IDS[cfg.gait])
        self.async_mpc = async_mpc
        self.k = 0                     # WBC tick counter
        self.n_plans = 0               # solved plans the planner published
        self.phase = 0                 # gait phase (MPC periods)
        self.horizon = cfg.mpc.horizon

        q0 = jnp.asarray(q0, F32)
        feet0 = dyn.foot_positions(self.tree, q0) * jnp.asarray([1, 1, 0],
                                                                F32)
        self.liftoff = feet0
        self.touchdown = feet0
        c0 = contacts_at(self.gid, jnp.int32(0)).astype(F32)
        self.prev_contacts = c0

        # gravity-compensation fallback plan, id -1 (period it covers: all)
        n_st = float(jnp.maximum(c0.sum(), 1.0))
        fb = np.zeros((self.horizon, 4, 3), np.float32)
        fb[:, :, 2] = model.total_mass * model.g / n_st * np.asarray(c0)
        self.f_plan = fb
        self.plan_period = 0           # period the current f_plan was solved in
        self._pending_plan = None      # sync mode: plan awaiting its period
        self.v_int = np.zeros(3, np.float32)  # velocity-error integral

        self.mpc_warm = (jnp.zeros(N_MPC_VARS, F32),
                         jnp.zeros(N_MPC_ROWS, F32))
        # zeros (not None): a zero warm start IS the cold start, and a
        # consistent pytree lets the warm buffers be DONATED to the jit —
        # the device reuses them for the outputs instead of allocating +
        # round-tripping fresh ones every tick (SURVEY.md §7.3 "donated
        # buffers" dispatch mitigation; VERDICT.md round-4 weak #6)
        self.wbc_warm = (jnp.zeros(30, F32), jnp.zeros(50, F32))

        # --- jitted device programs (donated warm starts) -----------------
        # Each is wrapped at its jit boundary by f32_matmuls, like every
        # public entry point (utils/__init__.py); the host-side eager ops in
        # compute() run under the same policy.
        # The ok-selection (keep the previous warm start on a failed solve)
        # happens IN-GRAPH so the caller can unconditionally adopt the
        # returned buffers: with donation, the passed-in warm arrays are
        # invalid after the call, so the old host-side `if ok:` pattern
        # would hand a donated buffer back to the next tick.
        @f32_matmuls
        @functools.partial(jax.jit, donate_argnums=(4, 5))
        def _mpc(x_srb, feet, phase, v_cmd, warm_x, warm_y):
            fsteps, next_td = plan_footsteps_horizon(
                model, cfg.mpc, cfg.cascade, self.gid, phase, x_srb, v_cmd,
                feet)
            x_ref = reference_rollout(model, cfg.mpc, x_srb, v_cmd)
            cont = jnp.stack([
                contacts_at(self.gid, phase + i).astype(F32)
                for i in range(self.horizon)])
            P, q_lin, A, l, u = build_mpc_qp(model, cfg.mpc, x_srb, x_ref,
                                             fsteps, cont)
            sol = admm_solve(P, q_lin, A, l, u, x0=warm_x, y0=warm_y,
                             iters=mpc_iters, adapt_rounds=mpc_rounds,
                             rho=0.1)
            wx = jnp.where(sol.ok, sol.x, warm_x)
            wy = jnp.where(sol.ok, sol.y, warm_y)
            return (sol.x.reshape(self.horizon, 4, 3), wx, wy, sol.ok,
                    next_td)

        @f32_matmuls
        @functools.partial(jax.jit, donate_argnums=(7, 8))
        def _wbc(q, v, contacts, f_used, pos, vel, acc, warm_x, warm_y):
            refs = WbcRefs(
                contacts=contacts, f_mpc=f_used,
                foot_pos_ref=pos, foot_vel_ref=vel, foot_acc_ref=acc,
                q_posture=jnp.asarray(model.q_stand, F32),
                base_rpy_ref=jnp.zeros(2, F32),
                h_ref=jnp.asarray(model.h_ref, F32))
            tau, qdd, f, sol = solve_wbc(self.tree, cfg.wbc, q, v, refs,
                                         iters=wbc_iters,
                                         adapt_rounds=wbc_rounds,
                                         warm_x=warm_x, warm_y=warm_y)
            tau = jnp.clip(tau, -cfg.wbc.tau_max, cfg.wbc.tau_max)
            wx = jnp.where(sol.ok, sol.x, warm_x)
            wy = jnp.where(sol.ok, sol.y, warm_y)
            return tau, qdd, wx, wy, sol.ok

        @f32_matmuls
        @jax.jit
        def _swing_ref(phase, t_frac, liftoff, touchdown):
            back, fwd, dur, _ = swing_tables(self.gid, phase)
            T_swing = dur.astype(F32) * cfg.mpc.dt
            s = jnp.where(dur > 0, (back.astype(F32) + t_frac)
                          / jnp.maximum(dur.astype(F32), 1.0), 0.0)
            return swing_foot_ref(liftoff, touchdown, s, T_swing,
                                  cfg.cascade.swing_height)

        self._mpc = _mpc
        self._wbc = _wbc
        self._swing_ref = _swing_ref

        # per-tick telemetry through the native wait-free ring (SURVEY.md
        # §5.5 host path): push costs no allocation/locks in the 1 kHz loop;
        # drain_telemetry() from any other thread
        self._telem = None
        if telemetry:
            from mpctsid_tpu.native import TelemetryRing
            self._telem = TelemetryRing(self.TELEM_LEN, capacity=8192)

        if async_mpc:
            from mpctsid_tpu.native import PlanBuffer
            self._buf = PlanBuffer(self.horizon * 12)
            self._buf.publish(fb.reshape(-1), 0)
            self._q: "queue.Queue" = queue.Queue(maxsize=2)
            self._stop = threading.Event()
            self._planner = threading.Thread(target=self._planner_loop,
                                             daemon=True)
            self._planner.start()

    # --- planner thread (async mode): device MPC solve -> PlanBuffer -------
    def _planner_loop(self):
        while not self._stop.is_set():
            try:
                snap = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            x_srb, feet, phase, v_cmd = snap
            plan, wx, wy, ok, _ = self._mpc(x_srb, feet, jnp.int32(phase),
                                            v_cmd, *self.mpc_warm)
            # warm buffers are donated: always adopt the returned pair (the
            # in-graph ok-select already kept the old values on failure)
            self.mpc_warm = (wx, wy)
            if bool(ok):
                self._buf.publish(np.asarray(plan).reshape(-1), phase)
                self.n_plans += 1
            # a failed solve publishes nothing: the consumer keeps the last
            # feasible plan (SURVEY.md §5.3)

    def close(self):
        if self.async_mpc:
            self._stop.set()
            self._planner.join(timeout=2.0)

    # --- the 1 kHz surface --------------------------------------------------
    @f32_matmuls
    def compute(self, q: np.ndarray, v: np.ndarray,
                v_cmd: np.ndarray | None = None) -> np.ndarray:
        """One WBC tick from measured state; returns 12 joint torques."""
        cfg = self.cfg
        mpc_every = cfg.cascade.mpc_every
        v_cmd = jnp.asarray(cfg.v_ref if v_cmd is None else v_cmd, F32)
        q = jnp.asarray(q, F32)
        v = jnp.asarray(v, F32)

        if self.k % mpc_every == 0:
            self._on_period_boundary(q, v, v_cmd)

        contacts = contacts_at(self.gid, jnp.int32(self.phase)).astype(F32)
        # the plan solved in period p covers period p+k with column k; the
        # nominal staleness is one period -> column 1 (engine.py parity).  An
        # older plan (planner behind, failed solves) reads deeper columns.
        col = int(np.clip(self.phase - self.plan_period, 1,
                          self.horizon - 1))
        f_used = jnp.asarray(self.f_plan[col]) * contacts[:, None]

        t_frac = (self.k % mpc_every) / mpc_every
        pos, vel, acc = self._swing_ref(jnp.int32(self.phase),
                                        jnp.float32(t_frac),
                                        self.liftoff, self.touchdown)
        tau, qdd, wx, wy, ok = self._wbc(q, v, contacts, f_used,
                                         pos, vel, acc, *self.wbc_warm)
        # donated warm buffers: always adopt (ok-select happens in-graph)
        self.wbc_warm = (wx, wy)
        if bool(ok):
            qdd_j = np.asarray(qdd)[6:]
            tau_ff = np.asarray(tau)
        else:  # impedance fallback (SURVEY.md §5.3)
            qdd_j = np.zeros(12, np.float32)
            tau_ff = np.zeros(12, np.float32)

        # joint-impedance actuator command (matches cascade/engine.py)
        wbc_dt = cfg.cascade.wbc_dt
        qn = np.asarray(q)
        vn = np.asarray(v)
        qd_des = vn[6:] + qdd_j * wbc_dt
        q_des = qn[7:] + vn[6:] * wbc_dt + 0.5 * qdd_j * wbc_dt ** 2
        if not bool(ok):
            q_des = np.asarray(self.model.q_stand, np.float32)
            qd_des = np.zeros(12, np.float32)
        tau_cmd = np.clip(tau_ff + 6.0 * (q_des - qn[7:])
                          + 0.3 * (qd_des - vn[6:]),
                          -cfg.wbc.tau_max, cfg.wbc.tau_max)
        if self._telem is not None:
            rec = np.empty(self.TELEM_LEN, np.float32)
            rec[0] = self.k
            rec[1] = self.phase
            rec[2] = float(bool(ok))
            rec[3:15] = tau_cmd
            self._telem.push(rec)
        self.k += 1
        return tau_cmd

    def drain_telemetry(self, max_records: int = 4096) -> np.ndarray:
        """(n, TELEM_LEN) records accumulated since the last drain (empty
        array when telemetry is off)."""
        if self._telem is None:
            return np.empty((0, self.TELEM_LEN), np.float32)
        return self._telem.pop(max_records)

    def _on_period_boundary(self, q, v, v_cmd):
        cfg = self.cfg
        if self.k > 0:
            self.phase += 1
        contacts = contacts_at(self.gid, jnp.int32(self.phase)).astype(F32)
        feet_now = dyn.foot_positions(self.tree, q)
        to_swing = (np.asarray(contacts) < 0.5) & \
            (np.asarray(self.prev_contacts) > 0.5)
        self.liftoff = jnp.where(jnp.asarray(to_swing)[:, None], feet_now,
                                 self.liftoff)
        x_srb = srb_state(q, v)

        # offset-free velocity integrator (cascade/engine.py twin): bias
        # the command handed to the planner thread / sync solve
        xs = np.asarray(x_srb)
        cy, sy = np.cos(xs[5]), np.sin(xs[5])
        v_meas = np.array([cy * xs[6] + sy * xs[7],
                           -sy * xs[6] + cy * xs[7], xs[11]],
                          dtype=np.float32)
        t_period = cfg.cascade.mpc_every * cfg.cascade.wbc_dt
        self.v_int = np.clip(
            self.v_int + cfg.cascade.ki_vint * t_period
            * (np.asarray(v_cmd) - v_meas),
            -cfg.cascade.v_int_max, cfg.cascade.v_int_max).astype(np.float32)
        v_cmd = jnp.asarray(np.asarray(v_cmd) + self.v_int, F32)

        if self.async_mpc:
            # consume the latest COMPLETED plan (one-solve-stale), then hand
            # the planner a fresh snapshot — never block the tick
            pid, flat = self._buf.read_latest()
            if pid >= 0 and pid > self.plan_period:
                self.f_plan = np.asarray(flat, np.float32).reshape(
                    self.horizon, 4, 3)
                self.plan_period = int(pid)
            try:
                self._q.put_nowait((x_srb, feet_now, self.phase, v_cmd))
            except queue.Full:
                pass  # planner is behind; skip this period's solve
            # touchdown targets update synchronously (cheap planner op)
            _, next_td = plan_footsteps_horizon(
                self.model, cfg.mpc, cfg.cascade, self.gid,
                jnp.int32(self.phase), x_srb, v_cmd, feet_now)
        else:
            # synchronous: the plan solved THIS boundary becomes consumable
            # at the NEXT boundary (one-solve-stale, engine.py parity) — the
            # pending slot holds it for one period
            if self._pending_plan is not None:
                self.f_plan, self.plan_period = self._pending_plan
                self._pending_plan = None
            plan, wx, wy, ok, next_td = self._mpc(
                x_srb, feet_now, jnp.int32(self.phase), v_cmd,
                *self.mpc_warm)
            self.mpc_warm = (wx, wy)   # donated buffers: always adopt
            if bool(ok):
                self._pending_plan = (np.asarray(plan), self.phase)
            # a failed solve leaves the pending slot empty: the current
            # f_plan keeps being consumed at deeper columns (SURVEY.md §5.3)

        self.touchdown = jnp.where(
            (np.asarray(contacts) < 0.5)[:, None], next_td, self.touchdown)
        self.prev_contacts = contacts

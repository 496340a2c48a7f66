"""Benchmark harness: throughput, latency, scaling presets (SURVEY.md §7.2.8).

Default mode prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...},
   "upright_frac": f, "mean_mpc_res": r, "mpc_fail_frac": f, ...}
The correctness guards ride along in the same line so a falling or diverging
batch can never again produce a clean headline number (VERDICT.md round-1
weak #2).

Modes:
  python bench.py                 headline throughput + guards (B=1024 trot)
  python bench.py --latency       p50 single-solve latency vs the 2 ms tick
  python bench.py --full          headline + every BASELINE config preset at
                                  its own batch size, one JSON line each
  python bench.py --batch-sweep   trot throughput at several batch sizes
  python bench.py --profile DIR   jax.profiler.trace around the headline run

It needs a GPU and exits without one.  JAX_PLATFORMS=cpu set explicitly runs
it as a CPU rehearsal; every line then says platform "cpu" and no number in
it is a device metric.

Measurement protocol (BASELINE.md): times are DIFFERENTIAL — an N-period and
a 1-period program, median over reps; the difference cancels dispatch and
transfer overhead.  One "cascade solve" is one full control tick: a WBC
(TSID) QP solve + plant step plus its amortized 1/20th share of the 50 Hz
centroidal MPC solve (QP build + footstep plan + adaptive-rho ADMM at the
production budget, config.py SolverConfig).
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from mpctsid_tpu.qp.admm import admm_solve
from mpctsid_tpu.utils import (configure_compile_cache, device_info,
                               f32_matmuls, require_gpu)

TICK_BUDGET_MS = 2.0


# ---------------------------------------------------------------------------
# scenario-batch construction
# ---------------------------------------------------------------------------

def build_batch(cfg, B, gait_mix=None, mu_spread=False, payload_spread=False,
                seed=0):
    """(cc, args) for a B-scenario batch; args is (ctl, plant, gid, v_cmd,
    contact_params) plus a per-scenario payload array when payload_spread.

    gait_mix: list of gait names cycled across the batch (per-scenario gait id
    is DATA, BASELINE.json:8); mu_spread: per-scenario friction in [0.4, 1.0];
    payload_spread: per-scenario base point mass in [0, 0.5] kg — the "load"
    half of BASELINE.json:9's mu/load perturbation batches."""
    from mpctsid_tpu.cascade import CascadeConfigured, init_controller
    from mpctsid_tpu.env.plant import ContactParams, PlantState
    from mpctsid_tpu.model.gaits import GAIT_IDS
    from mpctsid_tpu.model.solo12 import SOLO12

    model = SOLO12
    cc = CascadeConfigured(model, cfg)
    q0 = np.zeros(19, np.float32)
    q0[2] = model.h_ref
    q0[6] = 1.0
    q0[7:] = model.q_stand
    q0 = jnp.asarray(q0)

    names = gait_mix or [cfg.gait]
    gids_np = np.array([GAIT_IDS[names[i % len(names)]] for i in range(B)],
                       np.int32)
    rep = lambda x: jnp.broadcast_to(x, (B,) + x.shape)  # noqa: E731

    plant_b = jax.tree_util.tree_map(rep, PlantState.init(q0))

    rng = np.random.default_rng(seed)
    vmax = np.where(gids_np == GAIT_IDS.get("static", -1), 0.0, 1.0)
    vc_b = jnp.asarray(np.stack([
        rng.uniform(0.0, 0.35, B) * vmax,
        rng.uniform(-0.1, 0.1, B) * vmax,
        rng.uniform(-0.3, 0.3, B) * vmax], -1).astype(np.float32))
    cp = ContactParams.default()
    cp_b = jax.tree_util.tree_map(rep, cp)
    if mu_spread:
        import dataclasses
        cp_b = dataclasses.replace(
            cp_b, mu=jnp.asarray(rng.uniform(0.4, 1.0, B), jnp.float32))
    # controller init is gait-dependent (initial stance set) and, for
    # payload batches, mass-dependent (the initial vertical-force warm start
    # should assume the per-scenario mass, matching sweep.py); vmap it
    if payload_spread:
        payload_b = jnp.asarray(rng.uniform(0.0, 0.5, B), jnp.float32)
        ctl_b = jax.vmap(lambda g, pl: init_controller(
            model, cfg, cc.tree, q0, g, payload=pl))(
            jnp.asarray(gids_np), payload_b)
        return cc, (ctl_b, plant_b, jnp.asarray(gids_np), vc_b, cp_b,
                    payload_b)
    ctl_b = jax.vmap(lambda g: init_controller(model, cfg, cc.tree, q0, g))(
        jnp.asarray(gids_np))
    return cc, (ctl_b, plant_b, jnp.asarray(gids_np), vc_b, cp_b)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def diff_time(make_run, n_short, n_long, reps=3):
    """Median differential seconds-per-unit between n_short and n_long."""
    run_s = make_run(n_short)
    run_l = make_run(n_long)
    float(np.asarray(run_s()))   # compile + warm
    float(np.asarray(run_l()))
    ts = []
    for _ in range(reps):
        t0 = time.time()
        float(np.asarray(run_s()))
        t_s = time.time() - t0
        t0 = time.time()
        float(np.asarray(run_l()))
        t_l = time.time() - t0
        ts.append((t_l - t_s) / (n_long - n_short))
    return float(np.median(ts))


def measure_cascade(cc, args, periods=5, reps=3):
    """(ticks_per_s, guards) for a batched cascade rollout.

    args: 5-tuple (ctl, plant, gid, v_cmd, cp) or 6-tuple with a trailing
    per-scenario payload array (build_batch payload_spread=True)."""
    from mpctsid_tpu.cascade import cascade_rollout

    gid_b = args[2]
    B = int(gid_b.shape[0])
    mpc_every = cc.cfg.cascade.mpc_every

    def rollout_fn(n):
        if len(args) == 6:
            return jax.jit(jax.vmap(
                lambda c, p, g, v, cp, pl: cascade_rollout(
                    cc, c, p, g, v, cp, n_periods=n, payload=pl)))
        return jax.jit(jax.vmap(functools.partial(
            cascade_rollout, cc, n_periods=n)))

    def make_run(n):
        f = rollout_fn(n)
        return lambda: f(*args)[2]["x_srb"].sum()

    per_period = max(diff_time(make_run, 1, periods + 1, reps), 1e-9)
    ticks_per_s = B * mpc_every / per_period

    # correctness guards: same batch, but a LONGER rollout than the timed
    # one — trot-from-standstill needs ~20 MPC periods (0.4 s) to converge
    # to its steady-state velocity (measured: vx reaches ~0.20 of a 0.30
    # command by period ~20), so a 6-period guard window would report the
    # transient (vx_track ~0.02) and read as "the robot never moves"
    n_g = max(periods + 1, 31)
    _, _, metrics = rollout_fn(n_g)(*args)
    x = np.asarray(metrics["x_srb"])
    # velocity-tracking guard (VERDICT.md round-4 weak #7: upright_frac alone
    # scores a standing robot 1.0): body-frame forward velocity vs the
    # commanded vx, averaged over the second half of the rollout (the first
    # periods are transient from standstill)
    vc = np.asarray(args[3])                     # (B, 3) commands
    h = x.shape[1] // 2
    yaw = x[:, h:, 5]
    vx_body = (np.cos(yaw) * x[:, h:, 6] + np.sin(yaw) * x[:, h:, 7])
    vx_err = np.abs(vx_body - vc[:, None, 0]).mean()
    # transient-insensitive companion: fraction of the commanded forward
    # velocity actually reached in steady state (mean of the last 8 sampled
    # periods — a single last state aliases the within-gait vx oscillation),
    # averaged over scenarios with a meaningful command.  A standing batch
    # scores ~0 here no matter how long the rollout; mean_vx_err alone
    # cannot separate "still accelerating from standstill" from "not
    # moving".
    moving = np.abs(vc[:, 0]) > 0.05
    if moving.any():
        vx_ss = vx_body[moving, -8:].mean(axis=1)
        frac = np.clip(vx_ss / vc[moving, 0], 0.0, 1.5)
        vx_track = float(frac.mean())
    else:
        vx_track = 1.0
    guards = {
        "upright_frac": round(float((x[:, -1, 2] > 0.15).mean()), 4),
        "mean_vx_err": round(float(vx_err), 4),
        "vx_track_frac": round(vx_track, 3),
        "mean_mpc_res": float(np.asarray(metrics["mpc_prim_res"]).mean()),
        # dual/stationarity residual + WBC success fraction (VERDICT.md
        # round-3 item 10): prim 0.0 alone proves nothing for
        # strictly-interior solutions
        "mean_mpc_dual_res": float(
            f"{np.asarray(metrics['mpc_dual_res']).mean():.3g}"),
        "wbc_ok_frac": round(
            float(np.asarray(metrics["wbc_ok_frac"]).mean()), 4),
        "mpc_fail_frac": round(
            float((~np.asarray(metrics["mpc_ok"])).mean()), 4),
    }
    return ticks_per_s, guards


def measure_latency():
    """p50 single-solve (B=1) device latencies vs the 2 ms tick budget.

    Returns ms per full cascade tick (WBC QP + plant + amortized MPC) and ms
    per standalone MPC QP solve, both from scan-chained differential timing,
    and the dispatch-inclusive time of one single-period call."""
    from mpctsid_tpu.cascade import cascade_rollout
    from mpctsid_tpu.config import EngineConfig

    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, args = build_batch(cfg, 1)
    ctl_b, plant_b, gid_b, vc_b, cp_b = args
    ctl = jax.tree_util.tree_map(lambda x: x[0], ctl_b)
    plant = jax.tree_util.tree_map(lambda x: x[0], plant_b)
    gid, vc = gid_b[0], vc_b[0]
    cp = jax.tree_util.tree_map(lambda x: x[0], cp_b)

    # --- full cascade tick (B=1) ------------------------------------------
    def make_run_tick(n):
        f = jax.jit(functools.partial(cascade_rollout, cc, n_periods=n))
        return lambda: f(ctl, plant, gid, vc, cp)[2]["x_srb"].sum()

    per_period = diff_time(make_run_tick, 2, 12, reps=5)
    tick_ms = per_period / cfg.cascade.mpc_every * 1e3

    # --- standalone MPC QP solve (B=1), warm-started chain ----------------
    P, q_lin, A, l, u = [x[0] for x in mpc_qp_batch(cc, args)]

    def make_run_mpc(n):
        return lambda: mpc_solve_chain(
            P, q_lin, A, l, u, n=n, iters=cfg.solver.mpc_iters,
            adapt_rounds=cfg.solver.mpc_adapt_rounds).sum()

    mpc_ms = diff_time(make_run_mpc, 2, 22, reps=5) * 1e3

    # dispatch-inclusive p50 of a single one-period call (for context)
    f1 = jax.jit(functools.partial(cascade_rollout, cc, n_periods=1))
    float(np.asarray(f1(ctl, plant, gid, vc, cp)[2]["x_srb"].sum()))
    e2e = []
    for _ in range(7):
        t0 = time.time()
        float(np.asarray(f1(ctl, plant, gid, vc, cp)[2]["x_srb"].sum()))
        e2e.append(time.time() - t0)
    dispatch_ms = float(np.median(e2e)) * 1e3

    return {
        "tick_ms_p50": round(tick_ms, 4),
        "mpc_solve_ms_p50": round(mpc_ms, 4),
        "budget_ms": TICK_BUDGET_MS,
        "rt_headroom": round(TICK_BUDGET_MS / max(tick_ms, 1e-9), 1),
        "e2e_dispatch_ms_p50": round(dispatch_ms, 2),
    }


def measure_host_loop(n_ticks=300):
    """Deployment-path loop rate: HostController.compute driven by the
    native RtExecutor with async MPC (VERDICT.md round-4 weak #6: the 1 kHz
    claim rested on device time only; this measures what the HOST loop
    achieves on this hardware).

    Reports the free-running rate, plus RtExecutor jitter/overrun stats at
    the 1 kHz contract period and at the achievable period (1.25x the
    free-running mean)."""
    from mpctsid_tpu.config import EngineConfig
    from mpctsid_tpu.host import HostController
    from mpctsid_tpu.model.solo12 import SOLO12
    from mpctsid_tpu.native import RtExecutor

    cfg = EngineConfig(gait="trot", v_ref=(0.2, 0.0, 0.0))
    q0 = np.zeros(19, np.float32)
    q0[2] = SOLO12.h_ref
    q0[6] = 1.0
    q0[7:] = SOLO12.q_stand
    hc = HostController(SOLO12, cfg, q0, async_mpc=True)
    q = np.asarray(q0)
    v = np.zeros(18, np.float32)
    try:
        for _ in range(30):                    # compile + warm both programs
            hc.compute(q, v)
        t0 = time.time()
        for _ in range(n_ticks):
            hc.compute(q, v)
        per = (time.time() - t0) / n_ticks
        hz = 1.0 / per

        ex1k = RtExecutor(0.001)
        ex1k.run(100, lambda k: hc.compute(q, v))
        s1k = ex1k.stats

        exa = RtExecutor(per * 1.25)
        exa.run(n_ticks, lambda k: hc.compute(q, v))
        sa = exa.stats
    finally:
        hc.close()
    return {
        "host_loop_hz": round(hz, 1),
        "budget_hz": 1000.0,
        "rt_1khz_overrun_frac": round(s1k["overruns"]
                                      / max(s1k["ticks"], 1), 3),
        "rt_sustainable_period_ms": round(per * 1.25 * 1e3, 2),
        "rt_sustainable_overrun_frac": round(sa["overruns"]
                                             / max(sa["ticks"], 1), 3),
        "rt_mean_jitter_us": round(sa["mean_jitter_us"], 1),
        "rt_max_jitter_us": round(sa["max_jitter_us"], 1),
    }


@functools.partial(jax.jit, static_argnames=("n", "iters", "adapt_rounds"))
def mpc_solve_chain(P, q, A, l, u, n, iters, adapt_rounds):
    """n warm-started solves of one MPC QP, chained through a scan so each
    solve depends on the last; returns the final x."""
    def body(carry, _):
        x_p, y_p = carry
        sol = admm_solve(P, q + 1e-7 * x_p.mean(), A, l, u, x0=x_p, y0=y_p,
                         iters=iters, adapt_rounds=adapt_rounds, rho=0.1)
        return (sol.x, sol.y), ()

    (x, _), _ = jax.lax.scan(
        body, (jnp.zeros_like(q), jnp.zeros_like(l)), None, length=n)
    return x


def mpc_qp_batch(cc, args):
    """Build a (B,...)-batched MPC QP from the batch's initial states."""
    from mpctsid_tpu.cascade.engine import srb_state
    from mpctsid_tpu.mpc.srb import build_mpc_qp, reference_rollout
    from mpctsid_tpu.plan.footsteps import plan_footsteps_horizon
    from mpctsid_tpu.plan.gait import contacts_at
    from mpctsid_tpu import dyn

    model, cfg = cc.model, cc.cfg
    ctl_b, plant_b, gid_b, vc_b, _ = args

    def one(plant_q, plant_v, gid, vc):
        x_srb = srb_state(plant_q, plant_v)
        feet = dyn.foot_positions(cc.tree, plant_q)
        fsteps, _ = plan_footsteps_horizon(model, cfg.mpc, cfg.cascade, gid,
                                           jnp.int32(0), x_srb, vc, feet)
        x_ref = reference_rollout(model, cfg.mpc, x_srb, vc)
        cont = jnp.stack([contacts_at(gid, jnp.int32(k)).astype(jnp.float32)
                          for k in range(cfg.mpc.horizon)])
        return build_mpc_qp(model, cfg.mpc, x_srb, x_ref, fsteps, cont)

    # foot positions, footstep plan and reference rollout trace dots outside
    # build_mpc_qp, so this program carries the policy itself
    return f32_matmuls(jax.jit(jax.vmap(one)))(plant_b.q, plant_b.v, gid_b,
                                               vc_b)


# ---------------------------------------------------------------------------
# preset benchmarks (BASELINE.json:7-11; config presets in config.py PRESETS)
# ---------------------------------------------------------------------------

def run_presets():
    """One row per BASELINE config preset, each at its own batch size."""
    from mpctsid_tpu.config import PRESETS

    rows = []

    def add(name, metric, value, unit, extra=None):
        row = {"config": name, "metric": metric,
               "value": round(value, 2), "unit": unit,
               "device": device_info()}
        row.update(extra or {})
        rows.append(row)
        print(json.dumps(row), flush=True)

    # config1: single-rollout trot — latency vs the 2 ms tick and the
    # deployment host-loop rate under the native RtExecutor
    lat = measure_latency()
    extra1 = {"budget_ms": lat["budget_ms"],
              "mpc_solve_ms_p50": lat["mpc_solve_ms_p50"],
              "e2e_dispatch_ms_p50": lat["e2e_dispatch_ms_p50"],
              **measure_host_loop()}
    add("config1_trot_single", "p50 cascade tick latency", lat["tick_ms_p50"],
        "ms", extra1)

    # config2: 256-QP gait sweep (trot/walk/bound/static as per-scenario data)
    cfg = PRESETS["config2_gait_sweep"]
    cc, args = build_batch(cfg, cfg.batch,
                           gait_mix=["trot", "walk", "bound", "static"])
    tps, guards = measure_cascade(cc, args, periods=5)
    add("config2_gait_sweep", "cascade ticks/s (mixed gaits)", tps,
        "solves/s", guards)

    # config3: robustness — simultaneous mu AND payload perturbations,
    # warm-started cascade (BASELINE.json:9 "mu/load perturbation batches")
    cfg = PRESETS["config3_robustness"]
    cc, args = build_batch(cfg, cfg.batch, mu_spread=True,
                           payload_spread=True)
    tps, guards = measure_cascade(cc, args, periods=5)
    add("config3_robustness",
        "cascade ticks/s (mu in [0.4,1.0], payload in [0,0.5] kg)", tps,
        "solves/s", guards)

    # config4: 4k-scenario cascade on one chip
    cfg = PRESETS["config4_cascade_4k"]
    cc, args = build_batch(cfg, cfg.batch)
    tps, guards = measure_cascade(cc, args, periods=3)
    add("config4_cascade_4k", "cascade ticks/s (B=4096, 1 chip)", tps,
        "solves/s", guards)

    return rows


def batch_sweep(sizes=(256, 1024, 4096, 8192)):
    """Trot-only single-chip throughput at several batch sizes -> SCALING.json.

    Same workload at every point (ADVICE.md round-4: the old knee claim
    compared the mixed-gait config2 batch against trot-only rows, so
    workload mix confounded the batch-size conclusion), and the B=8192
    point measures the real per-chip HBM capacity claim (VERDICT.md round-4
    weak #2: "~8k scenarios/chip" was asserted, never run)."""
    from mpctsid_tpu.config import EngineConfig

    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    out = {}
    for B in sizes:
        try:
            cc, args = build_batch(cfg, B)
            tps, guards = measure_cascade(
                cc, args, periods=5 if B <= 1024 else 3)
            out[str(B)] = {"ticks_per_s": round(tps, 1), **guards}
        except Exception as e:  # e.g. HBM OOM at the capacity edge
            out[str(B)] = {"error": str(e)[:300]}
        print(f"  B={B}: {out[str(B)]}", file=sys.stderr, flush=True)
    with open("SCALING.json", "w") as f:
        json.dump(out, f, indent=1)
    return out


def headline(profile_dir=None):
    from mpctsid_tpu.config import EngineConfig

    B = 1024
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, args = build_batch(cfg, B)
    if profile_dir:
        with jax.profiler.trace(profile_dir):
            tps, guards = measure_cascade(cc, args, periods=5)
    else:
        tps, guards = measure_cascade(cc, args, periods=5)
    row = {
        "metric": "cascade MPC+TSID control ticks/s per chip "
                  f"(B={B}, trot, incl. MPC QP + WBC QP + plant)",
        "value": round(tps, 1),
        "unit": "solves/s",
        "device": device_info(),
    }
    row.update(guards)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--batch-sweep", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    a = ap.parse_args()

    # JAX_PLATFORMS=cpu set explicitly is a rehearsal; nothing falls back
    if os.environ.get("JAX_PLATFORMS") != "cpu":
        require_gpu("bench.py")
    configure_compile_cache()
    if a.latency:
        print(json.dumps({"metric": "p50 single-solve latency",
                          "device": device_info(), **measure_latency()}))
        return 0
    if a.batch_sweep:
        print(json.dumps({"metric": "trot-only batch sweep",
                          "device": device_info(), **batch_sweep()}))
        return 0

    if a.full:
        run_presets()
    print(json.dumps(headline(profile_dir=a.profile)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

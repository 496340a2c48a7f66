"""Smoke run of the batched MPC+TSID cascade on a GPU, through the entry
points a user calls, at the sizes users run.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded 32k Monte
                                      # Carlo and its comparison, nothing else

Phases, one JSON line each with its guards (value, limit, ok):
  device        JAX's backend must be a GPU, or the script exits non-zero
                at once; it has no CPU mode.
  single_robot  mpctsid_tpu.run.main: trot at 0.3 m/s for 2 s on ground
                truth and with the estimator in the loop.
  sweep         mpctsid_tpu.sweep.run_sweep: 2048 scenarios in chunks of
                1024, checkpointed after the first chunk and resumed; the
                first 64 scenarios rerun on the host CPU.
  host          HostController(async_mpc=True): 300 compute() ticks with the
                native PlanBuffer planner thread.
  parity        MPC QP (n=192, m=320) against the f64 oracle, the WBC QP
                (n=30) in its f64 tier and its f32 warm sequence against the
                oracle, one cascade period on the GPU against the same
                program on the host CPU, and an f32-vs-TF32 matmul probe.
  four_gpus     (--four-gpus only) sharded_cascade_rollout over a 4-device
                mesh at B=32,768 for 3 periods, each card running its 8,192
                scenarios in vmapped chunks of 1,024, against the first
                1,024 scenarios of every shard run unsharded on one card.

Every line with a time or rate carries the card's name and power limit.
Times are smoke readings, not benchmark cells.  The last line is
{"ok": true, "device": {...}} and is printed only if every phase passed;
otherwise the script exits 1.
"""

import os

# The comparisons run the same program on the host CPU in this process, so
# the CPU backend must load beside the GPU when JAX_PLATFORMS names only
# the GPU.  Must happen before JAX initializes its backends.
_plat = os.environ.get("JAX_PLATFORMS")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

F32 = jnp.float32


def guard(value, op, limit):
    """One guard: value, its limit as text, and whether it holds."""
    ok = {"<": value < limit, "<=": value <= limit, ">": value > limit,
          ">=": value >= limit, "==": value == limit}[op]
    return {"value": value, "limit": f"{op} {limit}", "ok": bool(ok)}


def memory_fields(compiled):
    """memory_analysis() of a compiled program as a dict of byte counts."""
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {k: int(getattr(m, k)) for k in dir(m)
            if k.endswith("_in_bytes")}


def standing_q0():
    from mpctsid_tpu.model.solo12 import SOLO12
    q0 = np.zeros(19, np.float32)
    q0[2] = SOLO12.h_ref
    q0[6] = 1.0
    q0[7:] = SOLO12.q_stand
    return q0


# --------------------------------------------------------------------------
# phases: each returns (fields, guards) and runs on the default device
# --------------------------------------------------------------------------

def phase_single_robot(seconds=2.0, vx=0.3):
    """run.main twice (ground truth, estimator); trot bounds of
    tests/test_cascade_jax.py, without its forward-progress bound."""
    from mpctsid_tpu import run

    fields, guards = {}, {}
    for name, extra in (("truth", []), ("estimator", ["--estimator"])):
        with contextlib.redirect_stdout(sys.stderr):
            s = run.main(["--gait", "trot", "--vx", str(vx), "--seconds",
                          str(seconds), "--repeat", "2"] + extra)
        fields[name] = {
            "compile_s": s["compile_s"], "run_s": s["run_s"],
            "steady_s_per_period": s["run_s"][-1] / s["periods"],
            "steady_ms_per_tick": s["run_s"][-1] / s["periods"] / 20 * 1e3,
            "final_pos": s["final_pos"], "vx_ss": s["vx_ss"]}
        guards[f"{name}_min_height"] = guard(s["min_height"], ">", 0.15)
        guards[f"{name}_max_abs_roll_pitch"] = guard(
            s["max_abs_roll_pitch"], "<", 0.15)
        guards[f"{name}_vx_ss_err"] = guard(abs(s["vx_ss"] - vx), "<", 0.06)
    return fields, guards


def phase_sweep(total=2048, chunk=1024, periods=25, cpu_n=64, seed=0):
    """Chunked Monte-Carlo sweep with checkpoint/resume, and the first
    cpu_n scenarios of the same seed on the host CPU."""
    from mpctsid_tpu.sweep import (METRIC_KEYS, SweepState, _chunk_runner,
                                   run_sweep, scenario_params, summarize)

    runner = _chunk_runner(chunk, periods)
    t0 = time.perf_counter()
    compiled = runner.lower(*scenario_params(seed, np.arange(chunk))).compile()
    compile_s = time.perf_counter() - t0

    ref = run_sweep(SweepState.fresh(seed, total, periods), chunk,
                    verbose=False)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sweep_ckpt.npz")
        st = run_sweep(SweepState.fresh(seed, total, periods), chunk,
                       ckpt_path=ckpt, max_chunks=1, verbose=False)
        first_cursor = st.cursor
        # steady state: the runner is compiled and traced by now
        t0 = time.perf_counter()
        resumed = run_sweep(SweepState.load(ckpt), chunk, ckpt_path=ckpt,
                            verbose=False)
        resume_s = time.perf_counter() - t0
    n_diff = sum(int((~np.isclose(resumed.metrics[k], ref.metrics[k],
                                  rtol=0, atol=0, equal_nan=True)).sum())
                 for k in METRIC_KEYS)
    summary = summarize(ref)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        on_cpu = run_sweep(SweepState.fresh(seed, cpu_n, periods), cpu_n,
                           verbose=False)
    up_dev = float(ref.metrics["upright"][:cpu_n].sum())
    up_cpu = float(on_cpu.metrics["upright"].sum())

    fields = {"total": total, "chunk": chunk, "periods": periods,
              "compile_s": compile_s,
              "memory_analysis": memory_fields(compiled),
              "resume_s": resume_s,
              "ticks_per_s": (total - chunk) * periods * 20 / resume_s,
              "summary": summary, "upright_first_n": [up_dev, up_cpu]}
    guards = {
        "resumed_after_chunk": guard(first_cursor, "==", chunk),
        "resumed_equals_uninterrupted_mismatches": guard(n_diff, "==", 0),
        "summary_finite": guard(
            bool(np.isfinite(list(summary.values())).all()), "==", True),
        f"upright_first_{cpu_n}_vs_cpu": guard(abs(up_dev - up_cpu),
                                               "<=", 1.0),
    }
    return fields, guards


def phase_host(n_ticks=300, warm_timeout_s=900.0):
    """HostController with the async planner thread: finite torques and at
    least one solved plan published through the native PlanBuffer."""
    from mpctsid_tpu.config import EngineConfig
    from mpctsid_tpu.host import HostController
    from mpctsid_tpu.model.solo12 import SOLO12

    q = standing_q0()
    v = np.zeros(18, np.float32)
    t0 = time.perf_counter()
    hc = HostController(SOLO12, EngineConfig(gait="trot"), q,
                        async_mpc=True)
    try:
        # warm-up: compile the WBC programs here and wait for the planner
        # thread's first solved plan (its compile runs concurrently)
        while hc.n_plans == 0:
            hc.compute(q, v)
            if time.perf_counter() - t0 > warm_timeout_s:
                raise TimeoutError("planner published no plan during warm-up")
        warm_s = time.perf_counter() - t0
        plans0 = hc.n_plans
        taus = []
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            taus.append(hc.compute(q, v))
        loop_s = time.perf_counter() - t0
        plans = hc.n_plans
    finally:
        hc.close()
    taus = np.asarray(taus)
    fields = {"ticks": n_ticks, "warmup_s": warm_s, "loop_s": loop_s,
              "loop_hz": n_ticks / loop_s,
              "plans_published": plans,
              "plans_published_in_loop": plans - plans0}
    guards = {"tau_finite": guard(bool(np.isfinite(taus).all()), "==", True),
              "plans_published": guard(plans, ">=", 1)}
    return fields, guards


def _refs_as(refs, dtype):
    from mpctsid_tpu.wbc.tsid import WbcRefs
    return WbcRefs(*[jnp.asarray(np.asarray(getattr(refs, f)), dtype)
                     for f in WbcRefs.__dataclass_fields__])


def _tau_of(x, Mm, h, JcT):
    from mpctsid_tpu.model.tree import NV
    return Mm[6:] @ x[:NV] + h[6:] - JcT[6:] @ x[NV:]


def phase_parity(cascade_batch=8):
    """Device solves against the plain references at real widths."""
    from bench import build_batch
    from mpctsid_tpu.cascade import cascade_period
    from mpctsid_tpu.config import WBC_PARITY_SOLVER, EngineConfig
    from mpctsid_tpu.model.solo12 import SOLO12
    from mpctsid_tpu.model.tree import build_tree
    from mpctsid_tpu.mpc.srb import build_mpc_qp
    from mpctsid_tpu.oracle.mpc import solve_mpc
    from mpctsid_tpu.oracle.scenarios import mpc_scenario, wbc_trot_ticks
    from mpctsid_tpu.qp.admm import admm_solve
    from mpctsid_tpu.utils import f32_matmuls
    from mpctsid_tpu.wbc.tsid import build_wbc_qp, solve_wbc

    fields, guards = {}, {}

    # (a) MPC QP, six scenarios of tests/test_mpc_jax.py, same settings
    cfg = EngineConfig()
    build = jax.jit(lambda *a: build_mpc_qp(SOLO12, cfg.mpc, *a))
    solve = jax.jit(lambda P, q, A, l, u: admm_solve(
        P, q, A, l, u, iters=100, adapt_rounds=4, rho=0.1, polish_kkt=True))
    errs = []
    for seed in range(6):
        x0, xref, fsteps, cont = mpc_scenario(seed)
        _, res_o = solve_mpc(SOLO12, cfg.mpc, cfg.solver, x0, xref, fsteps,
                             cont)
        sol = solve(*build(*[jnp.asarray(a, F32)
                             for a in (x0, xref, fsteps, cont)]))
        errs.append(float(np.abs(np.asarray(sol.x) - res_o.x).max()))
    fields["mpc_x_err"] = errs
    guards["mpc_x_max_abs_err"] = guard(max(errs), "<", 1e-4)

    # (b) WBC QP on the oracle trot tick sequence of tests/test_wbc_jax.py
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    tree = build_tree(SOLO12)
    ticks = wbc_trot_ticks(2 * cfg.cascade.mpc_every, SOLO12, cfg)
    jax.config.update("jax_enable_x64", True)
    try:
        build64 = jax.jit(lambda q, v, r: build_wbc_qp(tree, cfg.wbc, q, v, r))
        qps = [[np.asarray(a, np.float64) for a in build64(
            jnp.asarray(q, jnp.float64), jnp.asarray(v, jnp.float64),
            _refs_as(refs, jnp.float64))] for q, v, refs, _ in ticks]
        solve64 = jax.jit(lambda H, g, A, l, u, x0, y0: admm_solve(
            H, g, A, l, u, x0=x0, y0=y0, iters=WBC_PARITY_SOLVER.wbc_iters,
            adapt_rounds=WBC_PARITY_SOLVER.wbc_adapt_rounds,
            rho=WBC_PARITY_SOLVER.rho, polish_kkt=True))
        wx = jnp.zeros(qps[0][0].shape[0], jnp.float64)
        wy = jnp.zeros(qps[0][2].shape[0], jnp.float64)
        errs = []
        for (H, g, A, l, u, Mm, h, JcT), tick in zip(qps, ticks):
            s = solve64(H, g, A, l, u, wx, wy)
            wx, wy = s.x, s.y
            errs.append(float(np.abs(_tau_of(np.asarray(s.x), Mm, h, JcT)
                                     - tick[3]).max()))
    finally:
        jax.config.update("jax_enable_x64", False)
    fields["wbc_f64_tau_err_mean"] = float(np.mean(errs))
    guards["wbc_f64_tau_max_abs_err"] = guard(max(errs), "<", 1e-4)

    step = jax.jit(functools.partial(
        solve_wbc, tree, cfg.wbc, iters=cfg.solver.wbc_iters,
        adapt_rounds=cfg.solver.wbc_adapt_rounds))
    wx, wy = jnp.zeros(30, F32), jnp.zeros(50, F32)
    errs = []
    for q, v, refs, o_tau in ticks:
        tau, _, _, sol = step(jnp.asarray(q, F32), jnp.asarray(v, F32),
                              _refs_as(refs, F32), warm_x=wx, warm_y=wy)
        wx, wy = sol.x, sol.y
        errs.append(float(np.abs(np.asarray(tau, np.float64) - o_tau).max()))
    fields["wbc_f32_tau_err_max"] = max(errs)
    guards["wbc_f32_warm_tau_mean_err"] = guard(float(np.mean(errs)), "<",
                                                3e-3)

    # (c) one cascade period on the device and on the host CPU.  The bound
    # is the sharded-vs-unsharded one of tests/test_dist.py: only reduction
    # order (here also the GPU's library choice of algorithm) may differ.
    cc, args = build_batch(EngineConfig(gait="trot", v_ref=(0.25, 0.0, 0.0)),
                           cascade_batch, gait_mix=["trot", "walk"],
                           mu_spread=True)
    period = jax.jit(jax.vmap(functools.partial(cascade_period, cc)))
    _, plant_dev, _, _ = period(*args)
    _, plant_cpu, _, _ = period(*jax.device_put(args, jax.devices("cpu")[0]))
    dq = float(np.abs(np.asarray(plant_dev.q) - np.asarray(plant_cpu.q)).max())
    guards["cascade_period_dq_vs_cpu"] = guard(dq, "<", 1e-3)

    # (d) a 192x192 f32 product through the wrapped path must be f32-exact
    # to ~1e-6 relative; TF32 would sit near 1e-3
    r = np.random.default_rng(0)
    a, b = r.normal(size=(2, 192, 192)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    wrapped = np.asarray(f32_matmuls(jax.jit(jnp.matmul))(a, b), np.float64)
    plain = np.asarray(jax.jit(jnp.matmul)(a, b), np.float64)
    fields["matmul_rel_err_default_precision"] = float(
        np.abs(plain - ref).max() / scale)
    guards["matmul_rel_err_f32_matmuls"] = guard(
        float(np.abs(wrapped - ref).max() / scale), "<", 1e-5)
    return fields, guards


def phase_four_gpus(batch=32768, periods=3, ref_per_shard=1024, n_dev=4,
                    chunk=1024):
    """Sharded Monte Carlo over an n-device mesh, each device running its
    scenarios in vmapped chunks of `chunk`, against the first ref_per_shard
    scenarios of every shard run unsharded, in chunks of the same width, on
    one device."""
    from concurrent.futures import ThreadPoolExecutor

    from bench import build_batch
    from mpctsid_tpu.config import EngineConfig
    from mpctsid_tpu.dist import (batched_rollout, scenario_mesh,
                                  shard_scenarios, sharded_cascade_rollout)

    cfg = EngineConfig(gait="trot", v_ref=(0.25, 0.0, 0.0))
    mesh = scenario_mesh(n_dev)
    fields = {"requested_batch": batch}
    # the largest multiple of n_dev * 1024 (at most `batch`) whose compiled
    # program fits each device's memory
    step = n_dev * min(1024, ref_per_shard)
    limit = jax.devices()[0].memory_stats()
    limit = limit.get("bytes_limit") if limit else None
    pool = ThreadPoolExecutor(1)
    for B in range(batch, 0, -step):
        per = B // n_dev
        n_ref = min(ref_per_shard, per)
        cc, args = build_batch(cfg, B, gait_mix=["trot", "walk"],
                               mu_spread=True)
        s_args = shard_scenarios(mesh, args)
        run = sharded_cascade_rollout(cc, mesh, n_periods=periods,
                                      chunk=min(chunk, per))
        # the reference: the first n_ref scenarios of every shard, unsharded
        # on the first device; it compiles beside the sharded program
        idx = np.concatenate([s * per + np.arange(n_ref)
                              for s in range(n_dev)])
        ref_args = jax.tree_util.tree_map(lambda x: x[idx], args)
        ref = jax.jit(batched_rollout(cc, periods, min(chunk, n_ref)))
        t0 = time.perf_counter()
        ref_compiling = pool.submit(ref.lower(*ref_args).compile)
        compiled = run.lower(*s_args).compile()
        compile_s = time.perf_counter() - t0
        mem = memory_fields(compiled)
        print(json.dumps({"phase": "four_gpus", "batch": B,
                          "compile_s": compile_s,
                          "memory_analysis": mem}), flush=True)
        need = None if mem is None else mem.get("peak_memory_in_bytes") or (
            mem.get("temp_size_in_bytes", 0)
            + mem.get("argument_size_in_bytes", 0)
            + mem.get("output_size_in_bytes", 0))
        if limit is None or need is None or need < limit:
            break
        ref_compiling.result()
    ref_compiled = ref_compiling.result()
    pool.shutdown()
    fields.update(batch=B, chunk=min(chunk, per), compile_s=compile_s,
                  ref_compile_done_s=time.perf_counter() - t0,
                  memory_analysis=mem, bytes_limit=limit)
    if B != batch:
        fields["cut"] = f"batch {batch} -> {B}: compiled program exceeds " \
                        f"the device memory limit"

    t0 = time.perf_counter()
    _, plant_s, met_s, summary = jax.block_until_ready(compiled(*s_args))
    run_s = time.perf_counter() - t0
    fields.update(run_s=run_s, ticks_per_s=B * periods * 20 / run_s)

    _, plant_u, met_u = ref_compiled(*ref_args)

    q_s = np.asarray(plant_s.q)
    x_s = np.asarray(met_s["x_srb"])
    res_s = np.asarray(met_s["mpc_prim_res"])
    x_u = np.asarray(met_u["x_srb"])
    res_u = np.asarray(met_u["mpc_prim_res"])
    ddq = np.abs(q_s[idx] - np.asarray(plant_u.q)).max(axis=1)
    ddx = np.abs(x_s[idx] - x_u)
    dq, dx = float(ddq.max()), float(ddx.max())
    # the same per shard: (max dq, max dx, scenarios that differ at all)
    dx_scen = ddx.max(axis=(1, 2))
    per_shard = [[float(ddq[s * n_ref:(s + 1) * n_ref].max()),
                  float(dx_scen[s * n_ref:(s + 1) * n_ref].max()),
                  int((dx_scen[s * n_ref:(s + 1) * n_ref] > 0).sum())]
                 for s in range(n_dev)]
    up_s = float((x_s[idx, -1, 2] > 0.1).sum())
    up_u = float((x_u[:, -1, 2] > 0.1).sum())
    ms, mx = float(res_s[idx].max()), float(res_u.max())
    fields.update(reference_scenarios=int(len(idx)), dq=dq, dx=dx,
                  # where the largest difference sits: (scenario, period,
                  # state component), and how many scenarios differ at all
                  dx_argmax=[int(i) for i in np.unravel_index(ddx.argmax(),
                                                              ddx.shape)],
                  scenarios_differing=int((dx_scen > 0).sum()),
                  per_shard_dq_dx_differing=per_shard,
                  summary={k: float(np.asarray(v)) for k, v in
                           summary.items()})

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    host = {
        "n_upright": float((x_s[:, -1, 2] > 0.1).sum()),
        "n_total": float(B),
        "max_mpc_prim_res": float(res_s.max()),
        "mean_mpc_prim_res": float(res_s.mean()),
        "mean_tau_rms": float(np.asarray(met_s["tau_rms"]).mean()),
        "n_mpc_fail": float(np.any(~np.asarray(met_s["mpc_ok"]),
                                   axis=1).sum()),
        "min_wbc_ok_frac": float(np.asarray(met_s["wbc_ok_frac"]).min()),
    }
    got = fields["summary"]
    guards = {
        "dq_vs_unsharded": guard(dq, "<", 0.05),
        "dx_vs_unsharded": guard(dx, "<", 0.10),
        "n_upright_vs_unsharded": guard(abs(up_s - up_u), "<=", 1.0),
        "max_mpc_prim_res_vs_unsharded": guard(
            abs(ms - mx), "<", max(0.1 * abs(mx), 1e-4)),
    }
    for k in ("n_upright", "n_total", "max_mpc_prim_res", "n_mpc_fail",
              "min_wbc_ok_frac"):
        guards[f"summary_{k}_vs_host"] = guard(abs(got[k] - host[k]), "==",
                                               0.0)
    for k in ("mean_mpc_prim_res", "mean_tau_rms"):
        guards[f"summary_{k}_vs_host_rel"] = guard(rel(got[k], host[k]), "<",
                                                   1e-4)
    return fields, guards


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded 4-GPU Monte Carlo path")
    a = ap.parse_args(argv)
    from mpctsid_tpu.utils import (card_label, configure_compile_cache,
                                   device_info, require_gpu)

    require_gpu("chip_smoke.py", 4 if a.four_gpus else 1)

    cache_dir = configure_compile_cache()
    cards = card_label()
    card = cards[0]
    print(json.dumps({"phase": "device", "ok": True, "card": cards,
                      "jax": jax.__version__, "compile_cache": cache_dir,
                      "device": device_info()}), flush=True)

    if a.four_gpus:
        phases = [("four_gpus", phase_four_gpus)]
    else:
        phases = [("single_robot", phase_single_robot),
                  ("sweep", phase_sweep), ("host", phase_host),
                  ("parity", phase_parity)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fields, guards = fn()
        except Exception as e:  # report the phase, run the rest, exit 1
            traceback.print_exc()
            fields, guards = {"error": f"{type(e).__name__}: {e}"}, {}
            failed.append(name)
        ok = name not in failed and all(g["ok"] for g in guards.values())
        if not ok and name not in failed:
            failed.append(name)
        print(json.dumps({"phase": name, "ok": ok, "card": card,
                          "phase_s": time.perf_counter() - t0,
                          "guards": guards, **fields}, default=float),
              flush=True)

    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    for line in cards:
        print(line)
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

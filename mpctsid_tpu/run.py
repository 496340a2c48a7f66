"""Entry script: run the closed-loop cascade in simulation from the CLI
(replaces the reference's main_solo12_control.py demo entry, SURVEY.md §2.1
"Entry script" / §3.1).

    python -m mpctsid_tpu.run --gait trot --vx 0.3 --seconds 2
    python -m mpctsid_tpu.run --gait walk --profile weave --estimator \
        --jsonl run.jsonl --plot run.png --batch 16

Metrics are accumulated in-scan (one device->host transfer per run,
SURVEY.md §5.5) and optionally emitted as JSONL per MPC period plus a
matplotlib summary plot.  `main` returns a summary dict (compile and run
seconds, final pose, attitude and velocity guards); the process exits 1 if
the robot fell."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gait", default="trot",
                   choices=["trot", "walk", "bound", "static", "pace"])
    p.add_argument("--vx", type=float, default=0.3)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--profile", default="constant",
                   choices=["constant", "ramp", "weave"])
    p.add_argument("--estimator", action="store_true",
                   help="run the complementary filter in the loop")
    p.add_argument("--batch", type=int, default=1,
                   help="number of identical scenarios (throughput check)")
    p.add_argument("--mu", type=float, default=0.7, help="ground friction")
    p.add_argument("--jsonl", default=None, help="write per-period metrics")
    p.add_argument("--plot", default=None, help="write a summary plot PNG")
    p.add_argument("--repeat", type=int, default=1,
                   help="timed executions of the compiled rollout")
    p.add_argument("--cpu", action="store_true", help="force CPU")
    args = p.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mpctsid_tpu.utils import configure_compile_cache, device_info
    configure_compile_cache()
    print(json.dumps({"device": device_info()}), file=sys.stderr)

    from mpctsid_tpu import command
    from mpctsid_tpu.cascade import (CascadeConfigured, cascade_rollout,
                                     init_controller)
    from mpctsid_tpu.config import EngineConfig
    from mpctsid_tpu.env.plant import ContactParams, PlantState
    from mpctsid_tpu.est.filter import estimator_init
    from mpctsid_tpu.model.gaits import GAIT_IDS
    from mpctsid_tpu.model.solo12 import SOLO12

    model = SOLO12
    cfg = EngineConfig(gait=args.gait, v_ref=(args.vx, args.vy, args.wz))
    cc = CascadeConfigured(model, cfg)
    n_periods = max(int(round(args.seconds / cfg.mpc.dt)), 1)

    if args.profile == "constant":
        v_seq = command.constant(n_periods, args.vx, args.vy, args.wz)
    elif args.profile == "ramp":
        v_seq = command.ramp(n_periods, (args.vx, args.vy, args.wz),
                             t_ramp_periods=n_periods // 3)
    else:
        v_seq = command.weave(n_periods, vx=args.vx)

    q0 = np.zeros(19, np.float32)
    q0[2] = model.h_ref
    q0[6] = 1.0
    q0[7:] = model.q_stand
    q0 = jnp.asarray(q0)
    gid = jnp.int32(GAIT_IDS[args.gait])
    ctl = init_controller(model, cfg, cc.tree, q0, gid)
    plant = PlantState.init(q0)
    est = estimator_init(q0) if args.estimator else None
    cp = ContactParams.default()
    cp = ContactParams(kp_n=cp.kp_n, kd_n=cp.kd_n, kp_t=cp.kp_t,
                       kd_t=cp.kd_t, mu=jnp.asarray(args.mu, jnp.float32))

    def single(ctl, plant, gid, v, cp, est):
        return cascade_rollout(cc, ctl, plant, gid, v, cp,
                               n_periods=n_periods, est=est,
                               use_estimator=args.estimator)

    v_seq_d = jnp.asarray(v_seq)
    if args.batch > 1:
        rep = lambda x: jnp.broadcast_to(x, (args.batch,) + x.shape)
        ctl = jax.tree_util.tree_map(rep, ctl)
        plant = jax.tree_util.tree_map(rep, plant)
        est = jax.tree_util.tree_map(rep, est) if est is not None else None
        cp = jax.tree_util.tree_map(rep, cp)
        gid = jnp.full((args.batch,), gid, jnp.int32)
        v_seq_d = rep(v_seq_d)
        est_ax = 0 if est is not None else None
        single = jax.vmap(single, in_axes=(0, 0, 0, 0, 0, est_ax))
    call_args = (ctl, plant, gid, v_seq_d, cp, est)
    t0 = time.perf_counter()
    run = jax.jit(single).lower(*call_args).compile()
    compile_s = time.perf_counter() - t0
    run_s = []
    for _ in range(max(args.repeat, 1)):
        t0 = time.perf_counter()
        _, _, metrics = jax.block_until_ready(run(*call_args))
        run_s.append(time.perf_counter() - t0)
    metrics_np = {k: np.asarray(v) for k, v in metrics.items()}
    if args.batch > 1:
        metrics_np = {k: v[0] for k, v in metrics_np.items()}
    x = metrics_np["x_srb"]

    n_ss = min(16, n_periods)
    summary = {
        "gait": args.gait, "profile": args.profile, "periods": n_periods,
        "batch": args.batch, "estimator": args.estimator,
        "compile_s": compile_s, "run_s": run_s,
        "final_pos": [float(x[-1, 0]), float(x[-1, 1])],
        "min_height": float(x[:, 2].min()),
        "max_abs_roll_pitch": float(np.abs(x[:, 3:5]).max()),
        "mean_vx": float(x[n_periods // 3:, 6].mean()),
        "vx_ss": float(x[-n_ss:, 6].mean()),
        "fell": bool((x[:, 2] < 0.12).any()),
    }
    ticks = args.batch * n_periods * cfg.cascade.mpc_every
    print(f"gait={args.gait} profile={args.profile} periods={n_periods} "
          f"batch={args.batch} estimator={args.estimator}")
    print(f"  compile {compile_s:.1f}s | run {run_s[-1]:.3f}s | "
          f"{ticks / run_s[-1]:,.0f} ticks/s")
    print(f"  final pos ({x[-1, 0]:+.3f}, {x[-1, 1]:+.3f}) m | "
          f"height {x[-1, 2]:.3f} m | mean vx {summary['mean_vx']:+.3f} "
          f"(cmd {args.vx}) | fell={summary['fell']}")

    if args.jsonl:
        with open(args.jsonl, "w") as f:
            for k in range(n_periods):
                f.write(json.dumps({
                    "period": k, "t": k * cfg.mpc.dt,
                    "x_srb": metrics_np["x_srb"][k].tolist(),
                    "tau_rms": float(metrics_np["tau_rms"][k]),
                    "fz_sum": float(metrics_np["fz_sum"][k]),
                    "mpc_prim_res": float(metrics_np["mpc_prim_res"][k]),
                }) + "\n")
        print(f"  wrote {args.jsonl}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t = np.arange(n_periods) * cfg.mpc.dt
        fig, axes = plt.subplots(2, 2, figsize=(10, 6))
        axes[0, 0].plot(t, x[:, 6], label="vx")
        axes[0, 0].plot(t, v_seq[:, 0], "--", label="vx cmd")
        axes[0, 0].set_title("forward velocity [m/s]")
        axes[0, 0].legend()
        axes[0, 1].plot(t, x[:, 2])
        axes[0, 1].axhline(SOLO12.h_ref, ls="--", c="gray")
        axes[0, 1].set_title("base height [m]")
        axes[1, 0].plot(t, x[:, 3], label="roll")
        axes[1, 0].plot(t, x[:, 4], label="pitch")
        axes[1, 0].set_title("attitude [rad]")
        axes[1, 0].legend()
        axes[1, 1].plot(t, metrics_np["fz_sum"])
        axes[1, 1].axhline(SOLO12.total_mass * 9.81, ls="--", c="gray")
        axes[1, 1].set_title("total normal force [N]")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=110)
        print(f"  wrote {args.plot}")

    return summary


if __name__ == "__main__":
    sys.exit(1 if main()["fell"] else 0)

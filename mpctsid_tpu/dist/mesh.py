"""Multi-device scenario sharding: Mesh + shard_map over the scenario axis.

The reference has NO distributed backend (single-host CPU; SURVEY.md §2.2);
this build's parallel dimension is the SCENARIO batch (BASELINE.json:5
"shards scenario batches across chips with psum/all-gather reductions",
:11 "32k+ scenarios sharded across N>=2 hosts").  The cascade itself is
embarrassingly parallel across scenarios; cross-chip communication is used for
the global reductions the contract names: batch-wide QP residual norms (global
convergence monitoring) and Monte-Carlo metric aggregation, via `psum` on the
scenario axis inside `shard_map`.

Multi-host: call jax.distributed.initialize() before building the mesh; the
same code path then spans the processes' devices.  The mesh is 1-D over
scenarios: the only traffic is the small per-period summaries, so the device
interconnect (NVLink, all to all on one host) needs no topology-aware layout.
Tested on a virtual 8-device CPU mesh (tests/test_dist.py; SURVEY.md §4.5).

Deliberate non-feature: NO collectives inside the QP solves themselves.
Scenarios are independent optimization problems — a cross-chip reduction
inside the ADMM loop (e.g. globally-pooled rho adaptation) would couple their
convergence for zero algorithmic benefit and serialize every iteration on the
slowest chip's collective.  The contract's "psum/all-gather reductions of QP
residual blocks" (BASELINE.json:5) is realized where it has value:
the per-period residual-block summaries below (psum means, pmax worst-case,
failure counts), which is the global convergence monitor a Monte-Carlo
operator actually consumes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpctsid_tpu.cascade.engine import CascadeConfigured, cascade_rollout

AXIS = "scenario"


def scenario_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (AXIS,))


def shard_scenarios(mesh: Mesh, tree):
    """Device_put a pytree of (B, ...) arrays sharded on the scenario axis."""
    sharding = NamedSharding(mesh, P(AXIS))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def shard_scenarios_multihost(mesh: Mesh, tree):
    """Multi-process variant of shard_scenarios (BASELINE.json:11 "N>=2
    hosts"): each process passes ITS (B_local, ...) slice of the scenario
    batch; returns global jax.Arrays of shape (B_local * process_count, ...)
    sharded over the scenario axis, built without any cross-host data
    movement.  Requires jax.distributed.initialize() to have run and `mesh`
    to span all processes' devices.  Exercised by the two-process CPU test
    (tests/test_dist.py::test_two_process_distributed_cascade)."""
    import numpy as np
    sharding = NamedSharding(mesh, P(AXIS))

    def put(x):
        x = np.asarray(x)
        gshape = (x.shape[0] * jax.process_count(),) + x.shape[1:]
        return jax.make_array_from_process_local_data(sharding, x, gshape)

    return jax.tree_util.tree_map(put, tree)


def batched_rollout(cc: CascadeConfigured, n_periods: int,
                    chunk: int | None = None, **solver_kw):
    """cascade_rollout over a leading scenario axis: one vmap over the whole
    batch, or with `chunk` a sequence of vmapped batches of that size
    (lax.map).  Chunking bounds the compiled program and its working set to
    a `chunk`-wide batch, whatever the batch: at 8,192 scenarios per H100 in
    one vmap, XLA spent over five minutes compiling a single reduce fusion.

    fn(ctl_b, plant_b, gait_id_b, v_cmd_b, contact_params_b) ->
        (ctl_b, plant_b, metrics_b)"""
    one = functools.partial(cascade_rollout, cc, n_periods=n_periods,
                            **solver_kw)
    if chunk is None:
        return jax.vmap(one)
    return lambda *args: jax.lax.map(lambda a: one(*a), args,
                                     batch_size=chunk)


def sharded_cascade_rollout(cc: CascadeConfigured, mesh: Mesh, n_periods: int,
                            chunk: int | None = None, **solver_kw):
    """Returns a jitted function running the batched cascade sharded over the
    mesh, with psum-reduced global summaries.

    fn(ctl_b, plant_b, gait_id_b, v_cmd_b, contact_params_b) ->
        (ctl_b, plant_b, metrics_b, global_summary)

    where global_summary holds scenario-axis psum reductions: mean MPC primal
    residual, mean |tau|, and the global count of scenarios whose final base
    height stayed above 0.1 m (fall detection; SURVEY.md §5.3).

    chunk: each device runs its scenarios in vmapped batches of this size
    (batched_rollout)."""

    vmapped = batched_rollout(cc, n_periods, chunk, **solver_kw)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
        check_vma=False)
    def run(ctl, plant, gait_id, v_cmd, cparams):
        ctl, plant, metrics = vmapped(ctl, plant, gait_id, v_cmd, cparams)
        # global reductions across devices (BASELINE.json:5)
        n_local = metrics["mpc_prim_res"].shape[0] * 1.0
        n_total = jax.lax.psum(jnp.asarray(n_local), AXIS)
        summary = {
            "mean_mpc_prim_res": jax.lax.psum(
                metrics["mpc_prim_res"].sum(), AXIS) / (
                    n_total * metrics["mpc_prim_res"].shape[1]),
            # global convergence monitor: worst primal residual across every
            # scenario on every chip (pmax of the per-shard residual block)
            "max_mpc_prim_res": jax.lax.pmax(
                metrics["mpc_prim_res"].max(), AXIS),
            "mean_tau_rms": jax.lax.psum(
                metrics["tau_rms"].sum(), AXIS) / (
                    n_total * metrics["tau_rms"].shape[1]),
            "n_upright": jax.lax.psum(
                (metrics["x_srb"][:, -1, 2] > 0.1).sum().astype(jnp.float32),
                AXIS),
            # failure-detection rollup (SURVEY.md §5.3): scenarios with any
            # failed MPC solve, and the worst per-period WBC success fraction
            "n_mpc_fail": jax.lax.psum(
                jnp.any(~metrics["mpc_ok"], axis=1).sum().astype(jnp.float32),
                AXIS),
            "min_wbc_ok_frac": jax.lax.pmin(
                metrics["wbc_ok_frac"].min(), AXIS),
            "n_total": n_total,
        }
        return ctl, plant, metrics, summary

    return jax.jit(run)

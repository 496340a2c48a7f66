"""Oracle-generated parity inputs shared by the tests and chip_smoke.py.

`mpc_scenario(seed)` is one randomized centroidal-MPC problem (state, command,
gait phase) with its oracle footstep plan, contact horizon and reference
rollout.  `wbc_trot_ticks(n)` captures the first n WBC ticks of the oracle
cascade trotting from standstill: each tick's state, task references and the
oracle's torques, covering stance/swing transitions and mid-swing references.
"""

from __future__ import annotations

import numpy as np

from mpctsid_tpu.config import EngineConfig
from mpctsid_tpu.model.gaits import TROT
from mpctsid_tpu.model.solo12 import SOLO12


def mpc_scenario(seed: int, model=SOLO12, cfg: EngineConfig = EngineConfig()):
    """(x0, xref, fsteps, contacts) of one random trot MPC problem."""
    from mpctsid_tpu.oracle.mpc import reference_rollout
    from mpctsid_tpu.oracle.planner import (GaitScheduler,
                                            plan_footsteps_horizon)

    r = np.random.default_rng(seed)
    x0 = np.zeros(12)
    x0[2] = model.h_ref + r.normal() * 0.01
    x0[6:8] = r.normal(size=2) * 0.2
    x0[3:5] = r.normal(size=2) * 0.05
    vc = np.array([r.uniform(-0.5, 0.5), r.uniform(-0.2, 0.2),
                   r.uniform(-0.5, 0.5)])
    g = GaitScheduler(TROT, phase=int(r.integers(0, 16)))
    feet0 = model.shoulder_offsets.copy()
    feet0[:, 2] = 0.0
    fsteps, _ = plan_footsteps_horizon(model, cfg.mpc, cfg.cascade, g, x0,
                                       vc, feet0)
    cont = g.horizon(cfg.mpc.horizon)
    xref = reference_rollout(model, cfg.mpc, x0, vc)
    return x0, xref, fsteps, cont


def wbc_trot_ticks(n_ticks: int, model=SOLO12,
                   cfg: EngineConfig = EngineConfig(gait="trot",
                                                    v_ref=(0.3, 0.0, 0.0))):
    """[(q, v, refs, oracle_tau)] for the oracle cascade's first n ticks."""
    import mpctsid_tpu.oracle.cascade as ocas
    from mpctsid_tpu.model.tree import build_tree
    from mpctsid_tpu.oracle.sim import SimState, step

    captured = []
    orig = ocas.solve_wbc

    def hook(tree, cfgw, q, v, refs, **kw):
        out = orig(tree, cfgw, q, v, refs, **kw)
        captured.append((q.copy(), v.copy(), refs, out[0].copy()))
        return out

    tree = build_tree(model)
    ocas.solve_wbc = hook
    try:
        q0 = np.zeros(19)
        q0[2] = model.h_ref
        q0[6] = 1.0
        q0[7:] = model.q_stand
        ctl = ocas.OracleController(model, cfg, q0)
        sim = SimState.init(q0)
        for _ in range(n_ticks):
            cmd, _ = ctl.compute(sim.q, sim.v)
            sim, _ = step(tree, sim, cmd.torque(sim.q[7:], sim.v[6:]))
    finally:
        ocas.solve_wbc = orig
    return captured

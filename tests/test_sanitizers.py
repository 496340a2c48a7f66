"""Numerical sanitizers (SURVEY.md §5.2): the cascade under jax_debug_nans
and chex finite-tree assertions on every public output.

The functional design has no shared mutable state (no data races by
construction); the sanitizer surface that remains is NaN/Inf production, which
these tests run as a CI gate.
"""

import functools

import chex
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpctsid_tpu.cascade import (CascadeConfigured, cascade_rollout,
                                 init_controller)
from mpctsid_tpu.config import EngineConfig
from mpctsid_tpu.env.plant import ContactParams, PlantState
from mpctsid_tpu.model.gaits import GAIT_IDS
from mpctsid_tpu.model.solo12 import SOLO12

M = SOLO12
F32 = jnp.float32


def _rollout(n_periods=3, gait="trot"):
    cfg = EngineConfig(gait=gait, v_ref=(0.25, 0.0, 0.0))
    cc = CascadeConfigured(M, cfg)
    q0 = np.zeros(19, np.float32)
    q0[2] = M.h_ref
    q0[6] = 1.0
    q0[7:] = M.q_stand
    q0 = jnp.asarray(q0)
    gid = jnp.int32(GAIT_IDS[gait])
    ctl = init_controller(M, cfg, cc.tree, q0, gid)
    plant = PlantState.init(q0)
    roll = jax.jit(functools.partial(cascade_rollout, cc,
                                     n_periods=n_periods))
    return roll(ctl, plant, gid, jnp.asarray(cfg.v_ref, F32),
                ContactParams.default())


def test_cascade_under_debug_nans():
    """jax_debug_nans re-checks every jitted output; a NaN anywhere in the
    cascade's results raises instead of silently propagating."""
    jax.config.update("jax_debug_nans", True)
    try:
        ctl, plant, metrics = _rollout(2)
        float(np.asarray(metrics["x_srb"]).sum())
    finally:
        jax.config.update("jax_debug_nans", False)


def test_all_outputs_finite_chex():
    ctl, plant, metrics = _rollout(3)
    chex.assert_tree_all_finite((ctl, plant, metrics))


def test_qp_solution_finite_on_perturbed_batch():
    """Random (valid) QPs through the production solver: finite outputs and
    coherent status across the batch."""
    from mpctsid_tpu.qp.admm import admm_solve
    from tests.test_admm import random_qp

    qps = [random_qp(s) for s in range(8)]
    Ps, qs, As, ls, us = [jnp.stack([qp[i] for qp in qps]) for i in range(5)]
    sol = jax.jit(jax.vmap(lambda *a: admm_solve(
        *a, iters=80, adapt_rounds=2, rho=0.1)))(Ps, qs, As, ls, us)
    chex.assert_tree_all_finite((sol.x, sol.y, sol.z))
    assert np.asarray(sol.ok).all()

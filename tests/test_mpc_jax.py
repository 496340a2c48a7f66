"""JAX MPC QP builder + batched ADMM vs the oracle (SURVEY.md §4.1, §4.4).

The contract number: per-solve control (force) error < 1e-4 vs the CPU
reference at identical inputs (BASELINE.json:5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpctsid_tpu.config import EngineConfig
from mpctsid_tpu.model.solo12 import SOLO12
from mpctsid_tpu.mpc.srb import build_mpc_qp as j_build
from mpctsid_tpu.mpc.srb import reference_rollout as j_rollout
from mpctsid_tpu.oracle.mpc import reference_rollout as o_rollout
from mpctsid_tpu.oracle.mpc import solve_mpc as o_solve
from mpctsid_tpu.oracle.scenarios import mpc_scenario as scenario
from mpctsid_tpu.qp.admm import admm_solve

M = SOLO12
CFG = EngineConfig()
F32 = jnp.float32

_build = jax.jit(lambda *a: j_build(M, CFG.mpc, *a))
_solve = jax.jit(lambda P, q, A, l, u: admm_solve(
    P, q, A, l, u, iters=100, adapt_rounds=4, rho=0.1, polish_kkt=True))
_solve_batch = jax.jit(jax.vmap(lambda P, q, A, l, u: admm_solve(
    P, q, A, l, u, iters=100, adapt_rounds=4, rho=0.1, polish_kkt=True)))


def to_dev(x0, xref, fsteps, cont):
    return (jnp.asarray(x0, F32), jnp.asarray(xref, F32),
            jnp.asarray(fsteps, F32), jnp.asarray(cont, F32))


def test_rollout_parity():
    x0, *_ = scenario(0)
    vc = np.array([0.3, 0.1, -0.2])
    ref = o_rollout(M, CFG.mpc, x0, vc)
    out = jax.jit(lambda x: j_rollout(M, CFG.mpc, x, jnp.asarray(vc, F32)))(
        jnp.asarray(x0, F32))
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


def test_qp_builder_parity():
    from mpctsid_tpu.oracle.mpc import build_mpc_qp as o_build
    x0, xref, fsteps, cont = scenario(1)
    Po, qo, Ao, lo, uo = o_build(M, CFG.mpc, x0, xref, fsteps, cont)
    P, q, A, l, u = _build(*to_dev(x0, xref, fsteps, cont))
    np.testing.assert_allclose(np.asarray(q), qo, atol=1e-5)
    np.testing.assert_allclose(np.asarray(A), Ao, atol=1e-6)
    # P differs only by the deliberate swing-force ridge (documented in srb.py)
    dP = np.asarray(P, np.float64) - Po
    off = ~np.eye(dP.shape[0], dtype=bool)
    assert np.abs(dP[off]).max() < 1e-5
    diag = np.diag(dP)
    pinned = ~np.repeat(cont.reshape(-1) > 0.5, 3)
    assert np.all(diag[pinned] > 1e5)
    assert np.abs(diag[~pinned]).max() < 1e-5


@pytest.mark.parametrize("seed", range(6))
def test_solve_parity_under_1e4(seed):
    """BASELINE.json:5 — control error < 1e-4 vs the CPU reference."""
    x0, xref, fsteps, cont = scenario(seed)
    _, res_o = o_solve(M, CFG.mpc, CFG.solver, x0, xref, fsteps, cont)
    P, q, A, l, u = _build(*to_dev(x0, xref, fsteps, cont))
    sol = _solve(P, q, A, l, u)
    assert np.max(np.abs(np.asarray(sol.x) - res_o.x)) < 1e-4


def test_batched_vs_single_consistency():
    """SURVEY.md §4.4: vmapped solve == per-sample solve."""
    datas = [to_dev(*scenario(s)) for s in range(4)]
    Ps, qs, As, ls, us = [jnp.stack([_build(*d)[i] for d in datas])
                          for i in range(5)]
    batch = _solve_batch(Ps, qs, As, ls, us)
    for i, d in enumerate(datas):
        single = _solve(*_build(*d))
        np.testing.assert_allclose(np.asarray(batch.x[i]),
                                   np.asarray(single.x), atol=3e-4)


def test_swing_forces_near_zero():
    x0, xref, fsteps, cont = scenario(2)
    P, q, A, l, u = _build(*to_dev(x0, xref, fsteps, cont))
    sol = _solve(P, q, A, l, u)
    F = np.asarray(sol.x).reshape(16, 4, 3)
    swing = np.asarray(cont) < 0.5
    assert np.abs(F[swing]).max() < 1e-5  # ridge-pinned, not exactly 0

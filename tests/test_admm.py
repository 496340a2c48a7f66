"""The batched f32 ADMM solver (qp/admm.py) against the f64 oracle
(oracle/qp.py) on the same random QPs, with and without equality rows,
unbatched and under vmap."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpctsid_tpu.oracle.qp import solve_qp
from mpctsid_tpu.qp.admm import admm_solve

F32 = jnp.float32
# the MPC parity budget (tests/test_mpc_jax.py): polished, well inside the
# 1e-4 control contract.  Measured worst |dx| 1.5e-7 over these problems.
KW = dict(iters=100, adapt_rounds=4, rho=0.1, polish_kkt=True)
ATOL = 1e-5


def random_qp(seed, n=24, m=40, eq=True):
    r = np.random.default_rng(seed)
    Q = r.normal(size=(n, n))
    P = Q @ Q.T / n + 0.1 * np.eye(n)
    q = r.normal(size=n)
    A = r.normal(size=(m, n))
    x_feas = r.normal(size=n) * 0.1
    margin = np.abs(r.normal(size=m)) + 0.1
    l = A @ x_feas - margin
    u = A @ x_feas + margin
    if eq:
        # a few equality rows exercise the rho boost
        l[:4] = u[:4] = (A @ x_feas)[:4]
    return [jnp.asarray(a, F32) for a in (P, q, A, l, u)]


def oracle_x(qp):
    """f64 oracle solution of the f32-cast problem the device solves."""
    return solve_qp(*[np.asarray(a, np.float64) for a in qp]).x


_solve = jax.jit(lambda *a: admm_solve(*a, **KW))
_solve_batch = jax.jit(jax.vmap(lambda *a: admm_solve(*a, **KW)))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "vmap"])
@pytest.mark.parametrize("eq", [True, False], ids=["eq", "ineq"])
@pytest.mark.parametrize("seed", range(3))
def test_admm_matches_oracle(seed, eq, batched):
    if batched:
        qps = [random_qp(seed + 10 * k, eq=eq) for k in range(4)]
        sol = _solve_batch(*[jnp.stack(parts) for parts in zip(*qps)])
        xs = np.asarray(sol.x)
        assert np.asarray(sol.ok).all()
    else:
        qps = [random_qp(seed, eq=eq)]
        sol = _solve(*qps[0])
        xs = np.asarray(sol.x)[None]
        assert bool(sol.ok)
    for x, qp in zip(xs, qps):
        np.testing.assert_allclose(x, oracle_x(qp), atol=ATOL)

"""JAX rigid-body layer vs the MuJoCo-validated numpy oracle (SURVEY.md §4.1).

Fast checks run in f32 (the production dtype) with tolerances sized to the
1e-4 control-error budget; one combined x64 test proves exact parity (1e-11)
with a single jit compile (the unrolled graphs compile slowly under x64 on CPU;
results land in the persistent compile cache set by conftest.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpctsid_tpu import dyn as jdyn
from mpctsid_tpu.model.solo12 import SOLO12
from mpctsid_tpu.model.tree import build_tree
from mpctsid_tpu.oracle import dynamics as odyn

TREE = build_tree(SOLO12)


def random_state(seed):
    rng = np.random.default_rng(seed)
    q = np.zeros(19)
    q[0:3] = rng.normal(size=3)
    quat = rng.normal(size=4)
    q[3:7] = quat / np.linalg.norm(quat)
    q[7:] = rng.uniform(-1.5, 1.5, size=12)
    v = rng.normal(size=18)
    a = rng.normal(size=18)
    return q, v, a


def _all_quantities(q, v, a):
    return (jdyn.crba(TREE, q), jdyn.rnea(TREE, q, v, a),
            jdyn.foot_positions(TREE, q), jdyn.foot_jacobians(TREE, q),
            jdyn.foot_drifts(TREE, q, v), jdyn.integrate_q(q, v, 0.013))


_jit_all_f32 = jax.jit(_all_quantities)


def oracle_quantities(q, v, a):
    st = odyn.DynState(TREE, q)
    return (odyn.crba(TREE, st), odyn.rnea(TREE, st, v, a),
            st.foot_positions(),
            np.stack([odyn.foot_jacobian(TREE, st, i) for i in range(4)]),
            np.stack([odyn.foot_drift(TREE, st, v, i) for i in range(4)]),
            odyn.integrate_q(q, v, 0.013))


@pytest.mark.parametrize("seed", range(6))
def test_f32_parity_within_budget(seed):
    q, v, a = random_state(seed)
    outs = _jit_all_f32(q.astype(np.float32), v.astype(np.float32),
                        a.astype(np.float32))
    refs = oracle_quantities(q, v, a)
    tols = (1e-6, 2e-5, 1e-6, 1e-6, 5e-6, 1e-6)
    for out, ref, tol in zip(outs, refs, tols):
        assert np.asarray(out).dtype == np.float32
        np.testing.assert_allclose(np.asarray(out), ref, atol=tol)


def test_x64_exact_parity():
    """Strict correctness: all six quantities match the oracle at ~1e-11."""
    with _x64():
        f = jax.jit(_all_quantities)
        for seed in range(3):
            q, v, a = random_state(seed)
            outs = f(q, v, a)
            refs = oracle_quantities(q, v, a)
            for out, ref in zip(outs, refs):
                np.testing.assert_allclose(np.asarray(out), ref, atol=1e-10)


class _x64:
    def __enter__(self):
        self._old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *a):
        jax.config.update("jax_enable_x64", self._old)


def test_vmap_batch_consistency():
    """vmapped dynamics == per-sample (SURVEY.md §4.4)."""
    qs = np.stack([random_state(s)[0] for s in range(8)]).astype(np.float32)
    vs = np.stack([random_state(s)[1] for s in range(8)]).astype(np.float32)
    zeros = np.zeros((8, 18), np.float32)
    Mb, hb = jax.jit(jax.vmap(
        lambda q, v, a: (jdyn.crba(TREE, q), jdyn.rnea(TREE, q, v, a))))(
            qs, vs, zeros)
    for i in range(8):
        out = _jit_all_f32(qs[i], vs[i], zeros[i])
        np.testing.assert_allclose(np.asarray(Mb[i]), np.asarray(out[0]),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(hb[i]), np.asarray(out[1]),
                                   atol=1e-5)

"""Every public jitted entry point traces its f32 matmuls at HIGHEST.

At DEFAULT precision XLA may run an f32 dot in TF32 on GPUs with tensor
cores, about 1e-3 relative error per product — far outside the 1e-4 control
contract (mpctsid_tpu/utils/__init__.py).  The check reads the lowered
StableHLO, so it holds for the program as compiled, not as written.  Every
entry point returns its whole output, so no dot can be dropped as dead code
before the text is read.
"""

import functools
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpctsid_tpu.config import EngineConfig
from mpctsid_tpu.model.solo12 import SOLO12

F32 = jnp.float32
CFG = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
_DOT = re.compile(r"stablehlo\.dot(_general)?\b")


def f32_dot_precisions(text):
    """precision attribute of every dot with an f32 operand in `text`."""
    out = []
    for line in text.splitlines():
        if _DOT.search(line) and "xf32>" in line.split(" : ")[-1]:
            m = re.search(r"precision = \[([A-Z]+), ([A-Z]+)\]", line)
            out.append(m.groups() if m else ("DEFAULT", "DEFAULT"))
    return out


def _batch(B):
    from bench import build_batch
    return build_batch(CFG, B)


def lower_cascade_period():
    from mpctsid_tpu.cascade import cascade_period
    cc, args = _batch(2)
    return jax.jit(jax.vmap(functools.partial(cascade_period, cc))).lower(
        *args)


def lower_cascade_rollout():
    from mpctsid_tpu.cascade import cascade_rollout
    cc, args = _batch(1)
    one = jax.tree_util.tree_map(lambda x: x[0], args)
    return jax.jit(functools.partial(cascade_rollout, cc,
                                     n_periods=1)).lower(*one)


def lower_sharded_rollout():
    from mpctsid_tpu.dist import scenario_mesh, sharded_cascade_rollout
    cc, args = _batch(2)
    return sharded_cascade_rollout(cc, scenario_mesh(1), n_periods=1).lower(
        *args)


def _host():
    from mpctsid_tpu.host import HostController
    q0 = np.zeros(19, np.float32)
    q0[2] = SOLO12.h_ref
    q0[6] = 1.0
    q0[7:] = SOLO12.q_stand
    return HostController(SOLO12, CFG, q0, async_mpc=False)


def lower_host_mpc():
    z = functools.partial(jnp.zeros, dtype=F32)
    x_srb = z(12).at[2].set(SOLO12.h_ref)
    return _host()._mpc.lower(x_srb, z((4, 3)), jnp.int32(0), z(3),
                              z(192), z(320))


def lower_host_wbc():
    z = functools.partial(jnp.zeros, dtype=F32)
    q = z(19).at[6].set(1.0).at[2].set(SOLO12.h_ref)
    return _host()._wbc.lower(q, z(18), jnp.ones(4, F32), z((4, 3)),
                              z((4, 3)), z((4, 3)), z((4, 3)), z(30), z(50))


def lower_host_swing_ref():
    z = functools.partial(jnp.zeros, dtype=F32)
    return _host()._swing_ref.lower(jnp.int32(0), jnp.float32(0.5),
                                    z((4, 3)), z((4, 3)))


def lower_sweep_chunk():
    from mpctsid_tpu.sweep import _chunk_runner, scenario_params
    gids, vcs, mus, payloads = scenario_params(0, np.arange(2))
    return _chunk_runner(2, 1).lower(gids, vcs, mus, payloads)


def lower_bench_mpc_chain():
    from bench import mpc_qp_batch, mpc_solve_chain
    cc, args = _batch(1)
    P, q, A, l, u = [x[0] for x in mpc_qp_batch(cc, args)]
    return mpc_solve_chain.lower(P, q, A, l, u, n=2, iters=4,
                                 adapt_rounds=2)


ENTRY_POINTS = {
    "cascade_period": (lower_cascade_period, True),
    "cascade_rollout": (lower_cascade_rollout, True),
    "sharded_cascade_rollout": (lower_sharded_rollout, True),
    "host_mpc": (lower_host_mpc, True),
    "host_wbc": (lower_host_wbc, True),
    # the swing-reference program is polynomial evaluation: it may hold no
    # dot at all, and then there is nothing to pin
    "host_swing_ref": (lower_host_swing_ref, False),
    "sweep_chunk": (lower_sweep_chunk, True),
    "bench_mpc_solve_chain": (lower_bench_mpc_chain, True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_f32_dots_are_highest(name):
    lower, has_dots = ENTRY_POINTS[name]
    precs = f32_dot_precisions(lower().as_text())
    if has_dots:
        assert precs, f"{name}: no f32 dot found in the lowering"
    bad = [p for p in precs if p != ("HIGHEST", "HIGHEST")]
    assert not bad, f"{name}: {len(bad)}/{len(precs)} f32 dots not HIGHEST"


def test_unwrapped_dot_is_default():
    """The check can fail: a dot outside the policy lowers at DEFAULT."""
    a = jnp.ones((4, 4), F32)
    text = jax.jit(lambda x: x @ x).lower(a).as_text()
    assert f32_dot_precisions(text) == [("DEFAULT", "DEFAULT")]

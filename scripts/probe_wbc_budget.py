"""WBC solver-budget trim experiment (round 5): warm-sequence torque error
vs the oracle at candidate (iters, adapt_rounds) budgets.  The round-4 MPC
budget cut (100/4 -> 80/2) was justified by measured residuals; this probes
the same for the WBC stage.

CPU-only (error measurement); the time side needs an on-chip measurement
(the WBC solve time scales ~linearly in iters + rounds x factorization).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402


def main():
    from tests.test_wbc_jax import CFG, M, TREE, jax_refs, F32
    from mpctsid_tpu.oracle.scenarios import wbc_trot_ticks
    from mpctsid_tpu.wbc.tsid import solve_wbc

    ticks = wbc_trot_ticks(2 * CFG.cascade.mpc_every, M, CFG)

    for iters, rounds in [(60, 3), (50, 2), (40, 2), (30, 2), (40, 3),
                          (60, 2)]:
        errs = []
        wx = wy = None
        for q, v, refs, o_tau in ticks:
            tau, qdd, f, sol = solve_wbc(
                TREE, CFG.wbc, jnp.asarray(q, F32), jnp.asarray(v, F32),
                jax_refs(refs), iters=iters, adapt_rounds=rounds,
                warm_x=wx, warm_y=wy)
            wx, wy = sol.x, sol.y
            errs.append(np.abs(np.asarray(tau, np.float64) - o_tau).max())
        e = np.asarray(errs)
        print(f"wbc iters={iters} rounds={rounds}: mean={e.mean():.2e} "
              f"max={e.max():.2e}")


if __name__ == "__main__":
    main()

"""Time what XLA makes of the plain ADMM solve path on the GPU.

    python scripts/xla_solve_timing.py [--out timings.json]

Cases (production budgets, config.py SolverConfig):
  mpc_b1024   the MPC QP (n=192, m=320), B=1024, 60 iterations / 2 adapt rounds
  wbc_b1      the WBC QP (n=30, m=50),   B=1,    40 iterations / 3 adapt rounds
  wbc_b1024   the WBC QP,                B=1024, 40 iterations / 3 adapt rounds

Each case reports the median wall time of a solve batch (block_until_ready
around each call, after a warm-up call), the bytes the solve must move
counted from its shapes (`solve_bytes`), and the rate that implies against
the H100's 3.35 TB/s.  The WBC B=1 solve is also traced with jax.profiler to
count device kernels per solve.  Each line carries the card's name and power
limit.  It needs a GPU; JAX_PLATFORMS=cpu runs it as a rehearsal whose
numbers are not device metrics.
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import build_batch, mpc_qp_batch  # noqa: E402
from mpctsid_tpu.config import EngineConfig  # noqa: E402
from mpctsid_tpu.qp.admm import admm_solve  # noqa: E402
from mpctsid_tpu.utils import (card_label,  # noqa: E402
                               configure_compile_cache, device_info,
                               require_gpu)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
RUIZ_ITERS = 8                 # admm_solve's equilibrate_iters default


def solve_bytes(n, m, iters, rounds):
    """f32 bytes one solve reads or writes, each matrix once per use.

    Per iteration: K^-1 twice and K once (the refined K-solve), A twice
    (A'v and Ax).  Per adapt round: A read and K written by the assembly,
    K read and K^-1 written by the inverse, K^-1 read by its Newton-Schulz
    correction.  Per Ruiz round: P once and A twice.  Vectors are ignored."""
    per_iter = 3 * n * n + 2 * m * n
    per_round = m * n + 4 * n * n
    per_ruiz = n * n + 2 * m * n
    return 4 * (iters * per_iter + rounds * per_round + RUIZ_ITERS * per_ruiz)


def wbc_qp_batch(B):
    """B WBC QPs: the 40 oracle trot ticks, built in f32, tiled to B."""
    from mpctsid_tpu.model.solo12 import SOLO12
    from mpctsid_tpu.model.tree import build_tree
    from mpctsid_tpu.oracle.scenarios import wbc_trot_ticks
    from mpctsid_tpu.wbc.tsid import WbcRefs, build_wbc_qp

    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    tree = build_tree(SOLO12)
    build = jax.jit(lambda q, v, r: build_wbc_qp(tree, cfg.wbc, q, v, r)[:5])
    qps = []
    for q, v, refs, _ in wbc_trot_ticks(2 * cfg.cascade.mpc_every):
        r32 = WbcRefs(*[jnp.asarray(np.asarray(getattr(refs, f)),
                                    jnp.float32)
                        for f in WbcRefs.__dataclass_fields__])
        qps.append(build(jnp.asarray(q, jnp.float32),
                         jnp.asarray(v, jnp.float32), r32))
    idx = np.arange(B) % len(qps)
    return [jnp.stack([qps[i][k] for i in idx]) for k in range(5)]


def solver(iters, rounds, status_tol):
    return jax.jit(jax.vmap(
        lambda P, q, A, l, u: admm_solve(P, q, A, l, u, iters=iters,
                                         adapt_rounds=rounds, rho=0.1,
                                         status_tol=status_tol).x))


def time_case(fn, args, reps):
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first_s, ts


def device_kernels_per_call(fn, args, calls=5):
    """Device events per call from a jax.profiler trace of `calls` calls."""
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            for _ in range(calls):
                jax.block_until_ready(fn(*args))
        path = sorted(glob.glob(os.path.join(tmp, "**", "*.xplane.pb"),
                                recursive=True))[-1]
        pd = ProfileData.from_file(path)
    lines = {}
    kernels = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            names = [ev.name for ev in line.events]
            lines[f"{plane.name} | {line.name}"] = len(names)
            if line.name.startswith("Stream"):
                kernels += sum(1 for nm in names
                               if "memcpy" not in nm.lower()
                               and "memset" not in nm.lower())
    return kernels / calls, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    a = ap.parse_args(argv)
    rehearsal = os.environ.get("JAX_PLATFORMS") == "cpu"
    if not rehearsal:
        require_gpu("xla_solve_timing.py")
    configure_compile_cache()
    card = "none: CPU rehearsal" if rehearsal else card_label()[0]
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    s = cfg.solver

    cc, args = build_batch(cfg, a.batch)
    mpc_qp = mpc_qp_batch(cc, args)
    wbc_qp = wbc_qp_batch(a.batch)
    cases = [
        ("mpc_b%d" % a.batch, mpc_qp, 192, 320, s.mpc_iters,
         s.mpc_adapt_rounds, 0.05),
        ("wbc_b1", [x[:1] for x in wbc_qp], 30, 50, s.wbc_iters,
         s.wbc_adapt_rounds, 0.5),
        ("wbc_b%d" % a.batch, wbc_qp, 30, 50, s.wbc_iters,
         s.wbc_adapt_rounds, 0.5),
    ]
    out = {"card": card, "device": device_info(), "jax": jax.__version__,
           "cases": {}}
    for name, qp, n, m, iters, rounds, tol in cases:
        fn = solver(iters, rounds, tol)
        first_s, ts = time_case(fn, qp, a.reps)
        B = int(qp[0].shape[0])
        med = float(np.median(ts))
        nbytes = B * solve_bytes(n, m, iters, rounds)
        row = {"case": name, "card": card, "B": B, "n": n, "m": m,
               "iters": iters, "adapt_rounds": rounds,
               "first_call_s": first_s, "median_s": med,
               "min_s": float(np.min(ts)), "max_s": float(np.max(ts)),
               "solve_bytes": nbytes, "bytes_per_s": nbytes / med,
               "share_of_3.35TB/s": nbytes / med / HBM_BYTES_PER_S}
        if name == "wbc_b1":
            row["device_kernels_per_solve"], row["trace_lines"] = \
                device_kernels_per_call(fn, qp)
        out["cases"][name] = row
        print(json.dumps(row), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

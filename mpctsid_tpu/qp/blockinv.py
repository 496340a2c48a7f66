"""Matmul-only SPD matrix inversion: blocked Gauss-Jordan (sweep operator).

Why not jnp.linalg.inv / cholesky: XLA's batched LU and triangular solves
run n scalar pivot steps in sequence.  Blocked Gauss-Jordan does the same
O(n^3) work as ~n/b matmul-shaped pivot steps, so the batch dimension feeds
batched matmuls and the sequential depth drops from n scalar pivots to n/b
block pivots.  Whether this beats batched Cholesky on a given device is a
measurement (ROADMAP 1.4), not a property of the algorithm.

Why no pivoting is safe: every pivot block of an SPD matrix is SPD (principal
submatrices of SPD matrices are SPD, and the trailing matrix after a block
elimination step is a Schur complement, again SPD), so diagonal block pivots
are always invertible — the same argument that makes Cholesky pivot-free.
Accuracy matches the LU route to ~cond(K)*eps_f32, verified in
tests/test_blockinv.py.

Structure: `spd_inverse(K)` eliminates fixed-size diagonal blocks in order;
each step inverts one (b, b) pivot (recursively, down to a closed-form 2x2 /
3x3 base case) and applies a rank-b update to the rest — two (n, b) @ (b, n)
matmuls.  Everything is static-shaped and vmaps/batches cleanly.

Replaces: reference OSQP's AMD + sparse LDL' factorization and eiquadprog's
dense decompositions (SURVEY.md §2.1 native-component table) — here the
factorization is replaced by an explicit inverse so each ADMM iteration is a
pure matmul (qp/admm.py).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["spd_inverse", "spd_inverse_sorted", "chol_blocked",
           "tri_lower_inverse", "spd_inverse_chol"]


def _inv1(A):
    return 1.0 / A


def _inv2(A):
    a, b = A[0, 0], A[0, 1]
    c, d = A[1, 0], A[1, 1]
    det = a * d - b * c
    return jnp.stack([jnp.stack([d, -b]), jnp.stack([-c, a])]) / det


def _inv3(A):
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    adj = jnp.stack([jnp.stack([A00, A01, A02]),
                     jnp.stack([A10, A11, A12]),
                     jnp.stack([A20, A21, A22])])
    return adj / det


def _schur_inverse(A, b: int):
    """Inverse of SPD A (n, n) by 2x2 block partition at row b (recursive)."""
    n = A.shape[0]
    A11 = A[:b, :b]
    A12 = A[:b, b:]
    A22 = A[b:, b:]
    B11 = spd_inverse(A11)
    W = B11 @ A12                       # (b, n-b)
    S = A22 - A12.T @ W                 # SPD Schur complement
    S_inv = spd_inverse(S)
    U = W @ S_inv                       # (b, n-b)
    top = jnp.concatenate([B11 + U @ W.T, -U], axis=1)
    bot = jnp.concatenate([-U.T, S_inv], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def spd_inverse(K):
    """Explicit inverse of a symmetric positive-definite matrix (n, n).

    Recursive blocked Schur elimination with closed-form 1/2/3 base cases;
    matmul-only, so batched use (vmap) maps to batched GEMMs instead of
    XLA's serialized LU pivots.  Use for the QP KKT matrices and the 18x18
    mass matrices (all SPD by construction)."""
    n = K.shape[0]
    if n == 1:
        return _inv1(K)
    if n == 2:
        return _inv2(K)
    if n == 3:
        return _inv3(K)
    # split as evenly as possible while keeping both halves >= 1
    half = n // 2
    return _schur_inverse(K, half)


def chol_blocked(K):
    """Lower Cholesky factor of SPD K (n, n), recursive blocked form.

    [[K11, K21'], [K21, K22]] -> [[L11, 0], [K21 L11^-T, chol(S)]] with
    S = K22 - L21 L21'.  Each level is two matmul-shaped updates plus two
    half-size recursions, so the batched (vmap) form runs as batched GEMMs
    with sequential depth log2(n) — against n serialized pivot steps in
    XLA's batched `cholesky`/LU lowering.  Unpivoted Cholesky is
    backward-stable for SPD input (unlike the raw Schur-inverse recursion
    above, which loses ~cond(K) accuracy when small diagonals are eliminated
    first), so this is the production path for the QP KKT matrices.

    Closed-form 2x2 / 3x3 bases (round 5): the recursion below size 3 used
    to spawn ~12 ops per size-3 leaf (and a 192x192 factorization has 64 of
    them) — the small-op tail made the whole inverse launch-bound.  The explicit
    formulas are a handful of elementwise ops each.  Pivot floor 1e-10 as
    in the n == 1 base."""
    n = K.shape[0]
    if n == 1:
        # floor keeps a rounding-negative trailing pivot (reachable at
        # f32 cond ~ 1e7) from NaN-ing the whole factor; callers Jacobi-scale
        # first so diag(K) ~ 1 and the floor is ~eps-sized when it triggers
        return jnp.sqrt(jnp.maximum(K, 1e-10))
    if n == 2:
        l11 = jnp.sqrt(jnp.maximum(K[0, 0], 1e-10))
        l21 = K[1, 0] / l11
        l22 = jnp.sqrt(jnp.maximum(K[1, 1] - l21 * l21, 1e-10))
        z = jnp.zeros((), K.dtype)
        return jnp.stack([jnp.stack([l11, z]), jnp.stack([l21, l22])])
    if n == 3:
        l11 = jnp.sqrt(jnp.maximum(K[0, 0], 1e-10))
        l21 = K[1, 0] / l11
        l31 = K[2, 0] / l11
        l22 = jnp.sqrt(jnp.maximum(K[1, 1] - l21 * l21, 1e-10))
        l32 = (K[2, 1] - l31 * l21) / l22
        l33 = jnp.sqrt(jnp.maximum(K[2, 2] - l31 * l31 - l32 * l32, 1e-10))
        z = jnp.zeros((), K.dtype)
        return jnp.stack([jnp.stack([l11, z, z]),
                          jnp.stack([l21, l22, z]),
                          jnp.stack([l31, l32, l33])])
    half = n // 2
    K11 = K[:half, :half]
    K21 = K[half:, :half]
    K22 = K[half:, half:]
    L11 = chol_blocked(K11)
    L11_inv = tri_lower_inverse(L11)
    L21 = K21 @ L11_inv.T
    S = K22 - L21 @ L21.T
    L22 = chol_blocked(S)
    z = jnp.zeros((half, n - half), dtype=K.dtype)
    return jnp.concatenate(
        [jnp.concatenate([L11, z], axis=1),
         jnp.concatenate([L21, L22], axis=1)], axis=0)


_TRI_NEUMANN_BASE = 12


def tri_lower_inverse(L):
    """Inverse of a lower-triangular L (n, n), recursive blocked form.

    inv([[L11, 0], [L21, L22]]) = [[X11, 0], [-X22 L21 X11, X22]].
    Matmul-only, depth log2(n); cond(L) = sqrt(cond(K)) for a Cholesky
    factor, which is what buys the f32 stability of `spd_inverse_chol`.

    Base case n <= 12 (round 5; was 24):
    L = D (I + N) with N strictly lower
    NILPOTENT (N^n = 0), so inv(I + N) = prod_j (I + M^(2^j)) with M = -N —
    an EXACT log-depth product of ~2 ceil(log2(n)) matmuls, then a diagonal
    column scale.  The old recursion spawned ~45 ops (matmuls + concats)
    per size-12 subtree and dominated the factorization's launch-bound
    cost; the product form is ~10 uniform batched matmuls."""
    n = L.shape[0]
    if n == 1:
        return 1.0 / L
    if n <= _TRI_NEUMANN_BASE:
        d = jnp.diagonal(L)
        eye = jnp.eye(n, dtype=L.dtype)
        M = eye - L / d[:, None]           # M = -N, strictly lower
        X = eye + M
        k = 1
        while k < n - 1:                   # product covers M^0 .. M^(2k-1)
            M = M @ M
            X = X @ (eye + M)
            k *= 2
        return X / d[None, :]
    half = n // 2
    X11 = tri_lower_inverse(L[:half, :half])
    X22 = tri_lower_inverse(L[half:, half:])
    X21 = -X22 @ (L[half:, :half] @ X11)
    z = jnp.zeros((half, n - half), dtype=L.dtype)
    return jnp.concatenate(
        [jnp.concatenate([X11, z], axis=1),
         jnp.concatenate([X21, X22], axis=1)], axis=0)


def spd_inverse_chol(K, ns_steps: int = 1):
    """SPD inverse via blocked Cholesky + triangular inverse + NS polish.

    K^-1 = L^-T L^-1 with L from `chol_blocked`.  Because the triangular
    inverse only faces cond(L) = sqrt(cond(K)), the f32 result stays at
    ~sqrt(cond) * eps instead of the cond * eps (or worse) of the raw Schur
    recursion; `ns_steps` Newton-Schulz corrections X <- X (2I - K X) then
    quadratically tighten it.  This is the default factorization for both QP
    stages (qp/admm.py) — replaces OSQP's sparse LDL' and eiquadprog's dense
    decompositions (SURVEY.md §2.1) with an explicit matmul-only inverse.

    Symmetric Jacobi pre-scaling Ks = S K S, S = diag(K)^-1/2, comes first:
    the WBC KKT's conditioning is diagonal-scale-driven (1e6 swing-force
    ridge, 1e3 equality-rho boost → cond ~ 1e7, at f32 Cholesky's breakdown
    edge), and the scaling collapses it before the factorization sees it."""
    d = jnp.diagonal(K)
    s = 1.0 / jnp.sqrt(jnp.maximum(d, 1e-30))
    Ks = K * s[:, None] * s[None, :]
    L = chol_blocked(Ks)
    L_inv = tri_lower_inverse(L)
    X = L_inv.T @ L_inv
    if ns_steps:
        eye = jnp.eye(K.shape[0], dtype=K.dtype)
        X0 = X
        for _ in range(ns_steps):
            X = X @ (2.0 * eye - Ks @ X)
        # NS diverges iff ||I - Ks X|| >= 1 (only reachable when Ks is
        # numerically indefinite in f32); fall back to the unpolished
        # Cholesky inverse, which ADMM degrades gracefully under.
        bad = ~(jnp.sum((eye - Ks @ X) ** 2)
                < jnp.sum((eye - Ks @ X0) ** 2) * 4.0 + 1.0)
        X = jnp.where(bad, X0, X)
    # Last-resort finite fallback: at f32-indefinite input (cond >~ 1e9) the
    # floored base-case pivots cascade-overflow through the Schur updates and
    # L itself goes non-finite.  Fall back to the Jacobi inverse diag(1/diag K)
    # — identity in the scaled frame — which ADMM degrades gracefully under,
    # instead of poisoning every scenario sharing the vmapped batch
    # (tests/test_blockinv.py::test_ns_safeguard_no_nan_on_indefinite).
    nonfinite = ~jnp.all(jnp.isfinite(X))
    X = jnp.where(nonfinite, jnp.eye(K.shape[0], dtype=K.dtype), X)
    return X * s[:, None] * s[None, :]


def spd_inverse_sorted(K, ns_steps: int = 2):
    """SPD inverse with diagonal pivot ordering + Newton-Schulz refinement.

    Unpivoted Schur elimination loses accuracy when small diagonal entries are
    eliminated before large ones (measured |I - XK| ~ 1.4 on the WBC KKT
    matrix, cond ~ 4e4, whose diagonal spans the rho equality boost + swing
    ridge).  Eliminating in DESCENDING diagonal order — the complete-pivoting
    order for SPD Gauss-Jordan — plus `ns_steps` quadratic Newton-Schulz
    corrections X <- X (2I - K X) lands BELOW the batched-LU inverse error on
    that same matrix (3.8e-6 vs 1.0e-5 relative) at ~1/9 the device time.

    The permutation is data (argsort of diag), so the whole routine vmaps.
    Use this for QP KKT matrices; plain `spd_inverse` suffices for mass
    matrices (cond ~ 1e2, uniform diagonal)."""
    n = K.shape[0]
    perm = jnp.argsort(-jnp.diagonal(K))
    Kp = K[perm][:, perm]
    X = spd_inverse(Kp)
    eye = jnp.eye(n, dtype=K.dtype)
    # Safeguard before refining: Newton-Schulz contracts only when
    # ||I - K X|| < 1.  On near-singular K (f32 cond >~ 1e5) the elimination
    # can return garbage whose residual is >> 1, and NS would then amplify it
    # to NaN.  Fall back to the always-convergent cold start X0 = I/||K||_inf
    # (valid for SPD K) in that case — the refined inverse is then coarse,
    # which ADMM degrades gracefully under, instead of poisoning the batch.
    Y = Kp @ X
    r = jnp.sqrt(jnp.sum((eye - Y) ** 2))
    cold = eye / jnp.max(jnp.sum(jnp.abs(Kp), axis=1))
    bad = ~(r < 1.0)  # catches NaN in r as well
    X = jnp.where(bad, cold, X)
    for _ in range(ns_steps):
        X = X @ (2.0 * eye - Kp @ X)
    inv_perm = jnp.argsort(perm)
    return X[inv_perm][:, inv_perm]

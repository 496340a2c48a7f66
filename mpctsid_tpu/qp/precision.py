"""Double-float (df32) building blocks for f32 tail accuracy.

The solver runs in f32.  The polish step's iterative refinement needs the KKT
residual  r = b - K x  to much better than plain f32: at the solution, r is
~1e-6 while the individual products K_ij x_j are O(1), so a plain f32 matvec
leaves an accumulation-error floor of ~n*eps*|terms| ~ 1e-5..1e-4 — which
was the measured parity floor vs the CPU oracle (1–2.5e-4 on the MPC QP).

Classic error-free transformations fix this in pure f32:

  * Dekker product split: with a = a_hi + a_lo (12-bit hi mantissa),
    a*b = fl(a*b) + err where err = ((a_hi*b_hi - fl(a*b)) + a_hi*b_lo
    + a_lo*b_hi) + a_lo*b_lo is EXACT in f32 arithmetic.
  * Neumaier two-sum accumulation: carries a compensation term so the sum
    error is O(eps^2 * n) instead of O(eps * n).

`residual_matvec` combines both: the returned  b - K x  is accurate to
~eps*|r| + eps^2*n*|terms| — effectively f64-quality — using only f32 adds
and multiplies.  Cost: one scan over column chunks; used a few
times per solve in the polish tail only, so throughput impact is nil.

No reference counterpart (OSQP polishes in native f64; SURVEY.md §2.1 row
"OSQP" — this module is how the f32 build reaches the same tail accuracy
without leaving f32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 has a 24-bit mantissa; split at 12 bits so hi*hi products are exact.
_SPLIT = jnp.float32((1 << 12) + 1)


def _split(a):
    """Dekker split a = hi + lo with hi holding the top 12 mantissa bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + e == a*b exactly (f32, no FMA needed)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _two_sum(a, b):
    """s + e == a + b exactly (Knuth two-sum, branch-free)."""
    s = a + b
    t = s - a
    e = (a - (s - t)) + (b - t)
    return s, e


def residual_matvec(b, K, x, chunk: int = 32):
    """Compute  b - K @ x  with df32 accuracy (pure f32 ops).

    K: (m, n), x: (n,), b: (m,).  Columns are processed `chunk` at a time
    inside a lax.scan; per chunk every product is Dekker-split and the main
    parts are Neumaier-accumulated, so both product rounding and summation
    rounding are compensated.
    """
    m, n = K.shape
    pad = (-n) % chunk
    if pad:
        K = jnp.pad(K, ((0, 0), (0, pad)))
        x = jnp.pad(x, (0, pad))
    nc = (n + pad) // chunk
    Kc = K.reshape(m, nc, chunk).transpose(1, 0, 2)   # (nc, m, chunk)
    xc = x.reshape(nc, chunk)

    def body(carry, inp):
        s, comp = carry                 # running sum + compensation, (m,)
        Kb, xb = inp                    # (m, chunk), (chunk,)
        p, e = _two_prod(Kb, xb[None, :])
        perr = jnp.sum(e, axis=1)       # product errors: tiny, plain sum ok

        def add_one(j, sc):
            s, comp = sc
            s2, err = _two_sum(s, p[:, j])
            return s2, comp + err

        s, comp = jax.lax.fori_loop(0, chunk, add_one, (s, comp))
        return (s, comp + perr), None

    (s, comp), _ = jax.lax.scan(
        body, (jnp.zeros(m, K.dtype), jnp.zeros(m, K.dtype)), (Kc, xc))
    # b - (s + comp), keeping the compensation until the very last add
    d, e = _two_sum(b, -s)
    return d + (e - comp)

"""Exact branch-free Gamma variates for the fused kernel (f32 inverse CDF).

The variance-gamma subordinator needs Gamma(a, scale=nu) increments with
a = dt/nu typically *far* below 1 (daily grid, nu ~ 0.2 -> a ~ 0.02).
Rejection samplers (Marsaglia-Tsang, numpy, `jax.random.gamma`) use
data-dependent while-loops — unusable inside the fused kernel's time loop and
incompatible with the (seed, stream, path, t) counter contract (draw count
per step must be static).  This module samples by CDF inversion instead,
split by the boost identity (Devroye 1986, IX.3; numpy uses it for
shape < 1)::

    Gamma(a)  =d  Gamma(1 + a) * U^(1/a),        a in (0, 1]

so the hard inversion happens only at shape b = 1 + a in (1, 2] — where
the density is bounded, unimodal, and Newton converges fast — and the
small-shape singularity is carried by the *algebraically exact* power
``U^(1/a) = exp(log(U)/a)``.

All pieces are fixed-iteration compositions of f32 mul/add plus the
repo's accurate `exp32`/`log32` (DEVNOTES "Transcendental accuracy"),
with no captured constant arrays and no data-dependent control flow, so
they trace inside the kernel and are bitwise identical across CPU, XLA
and the kernel — the same contract as `ndtri32`.

Accuracy (tested against scipy.special.gammaincinv / stats.gamma in
tests/test_gamma_rng.py): quantile relative error <= 1.6e-6 over
u in [1e-6, 1 - 6e-8], b in (1, 2]; sample moments and KS pass at both
moderate and tiny shapes.  Underflow: U^(1/a) for tiny a underflows f32
below exp(-88) — those increments round to 0 (relative error of the
*sum* over a path is ~1e-7; the affected quantiles are <= 1e-38 where
f64 scipy itself is within a few hundred ULPs of underflow).
"""

from __future__ import annotations

import jax.numpy as jnp

from montecarlo.rng.normal import exp32, log32, ndtri32

# Iteration counts tuned to the f32 floor (max quantile error 1.6e-6 vs
# f64 scipy over u in [1e-6, 1-6e-8] x b in (1, 2] — identical to the
# 26/26/6 "safe" setting, ~2x cheaper; re-run the sweep in
# tests/test_gamma_rng.py when touching these).
_N_SERIES = 20   # lower-gamma series terms (x <= b+1 <= 3: term_20 ~ 1e-9)
_N_CF = 18       # upper-gamma Lentz iterations (x >= b+1)
_N_NEWTON = 4    # log-Newton quantile steps (WH / small-u seeded)


def gamma1p32(a):
    """Gamma(1 + a) for a in [0, 1] — Abramowitz-Stegun 6.1.36 minimax
    polynomial (|error| <= 3e-7, below f32 round-off at these magnitudes).
    Scalar python constants only (Pallas-safe)."""
    a = jnp.asarray(a, jnp.float32)
    p = jnp.float32(0.035868343)
    p = p * a + jnp.float32(-0.193527818)
    p = p * a + jnp.float32(0.482199394)
    p = p * a + jnp.float32(-0.756704078)
    p = p * a + jnp.float32(0.918206857)
    p = p * a + jnp.float32(-0.897056937)
    p = p * a + jnp.float32(0.988205891)
    p = p * a + jnp.float32(-0.577191652)
    return p * a + jnp.float32(1.0)


def expneg_wide32(x):
    """exp(x) for x in [-88, 0] — extends `exp32` (domain |x| <= 20) to the
    full f32 underflow range by squaring: exp(x) = exp32(x/8)^8.  Relative
    error ~8x exp32's (~1e-7); below exp(-87.3) the result underflows to 0
    (subnormals may flush to zero on an accelerator), the correct graceful
    limit for the boost
    factor U^(1/a) at tiny shapes."""
    x = jnp.asarray(x, jnp.float32)
    x = jnp.clip(x, jnp.float32(-88.0), jnp.float32(0.0))
    e = exp32(x * jnp.float32(0.125))
    e2 = e * e
    e4 = e2 * e2
    return e4 * e4


def _lower_series(b, x):
    """Sum of the lower-incomplete-gamma series: P(b, x) = prefactor *
    sum_{n>=0} x^n / ((b+1)...(b+n)), accurate for x <= b + 1."""
    term = jnp.ones_like(x)
    acc = jnp.ones_like(x)
    for n in range(1, _N_SERIES):
        term = term * x / (b + jnp.float32(n))
        acc = acc + term
    return acc


def _upper_cf(b, x):
    """Lentz continued fraction for the upper tail: Q(b, x) = prefactor *
    cf, accurate for x >= b + 1 (Numerical Recipes gcf form)."""
    tiny = jnp.float32(1e-30)
    bb = x + jnp.float32(1.0) - b
    c = jnp.full_like(x, jnp.float32(1e30))
    d = jnp.float32(1.0) / jnp.maximum(bb, tiny)
    h = d
    for i in range(1, _N_CF):
        an = -jnp.float32(i) * (jnp.float32(i) - b)
        bb = bb + jnp.float32(2.0)
        d = an * d + bb
        d = jnp.where(jnp.abs(d) < tiny, tiny, d)
        c = bb + an / c
        c = jnp.where(jnp.abs(c) < tiny, tiny, c)
        d = jnp.float32(1.0) / d
        h = h * d * c
    return h


def gamma_icdf_boost32(b, u):
    """Quantile x = P^{-1}(b, u) of Gamma(b, 1) for shape b in (1, 2].

    Newton on the regularized incomplete gamma, branch-free: the residual
    uses the lower series where x < b+1 and the upper continued fraction
    beyond (evaluating the tail as (1-u) - Q avoids the 1-P cancellation
    exactly where it matters), with one shared prefactor x^b e^{-x}.
    Seeds: Wilson-Hilferty in the body, the exact small-x expansion
    (u * Gamma(b+1))^(1/b) below it; 4 damped log-Newton steps land at the
    f32 rounding floor for u in [1e-6, 1 - 6e-8] (tested vs scipy)."""
    u = jnp.asarray(u, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    g1p = gamma1p32(b - jnp.float32(1.0))       # Gamma(b)
    gb1 = b * g1p                               # Gamma(b+1)
    inv_gb = jnp.float32(1.0) / g1p
    inv_gb1 = jnp.float32(1.0) / gb1

    # Wilson-Hilferty seed (clipped positive), small-u seed below it.
    z = ndtri32(jnp.clip(u, jnp.float32(6e-8), jnp.float32(1.0 - 6e-8)))
    c = jnp.float32(1.0) / (jnp.float32(9.0) * b)
    wh = b * (jnp.float32(1.0) - c + z * jnp.sqrt(c)) ** 3
    x_small = exp32(log32(u * gb1) / b)
    x = jnp.where(u < jnp.float32(0.02), x_small,
                  jnp.clip(wh, jnp.float32(1e-8), jnp.float32(40.0)))

    uq = jnp.float32(1.0) - u
    log_u = log32(u)
    log_uq = log32(uq)
    for _ in range(_N_NEWTON):
        logx = log32(jnp.maximum(x, jnp.float32(1e-30)))
        pref = expneg_wide32(jnp.clip(b * logx - x,
                                      jnp.float32(-88.0), jnp.float32(0.0)))
        use_series = x < b + jnp.float32(1.0)
        # Unselected branch still evaluates: keep both finite everywhere.
        p_low = pref * inv_gb1 * _lower_series(b, jnp.minimum(x, b + 1.0))
        q_high = pref * inv_gb * _upper_cf(b, jnp.maximum(x, b + 1.0))
        pdf = pref * inv_gb / jnp.maximum(x, jnp.float32(1e-30))
        # Newton in LOG probability — near-linear in both tails, so no
        # body/tail oscillation (plain Newton overshoots back and forth in
        # the strongly convex upper tail; measured 1.5% residuals there).
        # Residuals: log P - log u (series side), log Q - log uq (CF side,
        # sign flipped since Q decreases in x).
        step = jnp.where(
            use_series,
            (log32(jnp.maximum(p_low, jnp.float32(1e-35))) - log_u)
            * p_low / jnp.maximum(pdf, jnp.float32(1e-35)),
            -(log32(jnp.maximum(q_high, jnp.float32(1e-35))) - log_uq)
            * q_high / jnp.maximum(pdf, jnp.float32(1e-35)))
        # Damp: never move more than a factor of 2 down or +8 up per step.
        step = jnp.clip(step, -jnp.float32(8.0), x * jnp.float32(0.5))
        x = jnp.clip(x - step, jnp.float32(1e-12), jnp.float32(44.0))
    return x


def gamma_from_uniforms32(a, u_w, u_boost):
    """One Gamma(a, 1) variate from two independent uniforms, a in (0, 1]:
    W * U^(1/a) with W = Gamma(1+a) by CDF inversion (exact boost
    identity).  Branch-free, Pallas-safe; returns 0 where the boost factor
    underflows f32 (quantiles <= ~1e-38)."""
    a = jnp.asarray(a, jnp.float32)
    w = gamma_icdf_boost32(a + jnp.float32(1.0), u_w)
    return w * expneg_wide32(log32(u_boost) / a)


# ---------------------------------------------------------------------------
# Table-accelerated inversion: the gamma shape b = 1 + dt/nu is a TRACE-TIME
# constant for every VG simulation, so the quantile function can be
# tabulated once (host-side, f64) and evaluated in-kernel as a cubic-Hermite
# interpolation over four table reads — far cheaper than
# the 4-step log-Newton while holding the same ~1e-6 accuracy bound.
#
# Coordinate design: index by z = Phi^{-1}(u) (the normal quantile the
# kernels already compute cheaply via ndtri32) and store the RESIDUAL
#
#     resid(z) = log Q_b(Phi(z)) - log(Phi(z)) / b
#
# which is asymptotically FLAT in the left tail (Q ~ (u Gamma(b+1))^{1/b}
# is an exact power law, carried analytically by the log(u)/b term added
# back at evaluation time from the *sampled* uniform) and slowly varying on
# the right — total range ~4, so f32 storage costs ~2.4e-7 relative, far
# under the Newton path's 1.6e-6 bound.  ndtri32's own error only enters
# through resid' (small by construction), not through the power law.

_TABLE_Z_LO = -5.45   # ndtri32(6e-8) ~ -5.38: covers the clipped u range
_TABLE_Z_HI = 5.45


def _regularized_gamma_f64(b: float, x, n_series: int = 256,
                           n_cf: int = 256):
    """P(b, x) in f64 numpy (host-side): lower series below b+1, Lentz
    continued fraction above — the f32 kernel algebra at oracle precision
    (self-contained; validated against scipy in tests/test_gamma_rng.py)."""
    import numpy as np

    x = np.asarray(x, np.float64)
    import math

    lg = math.lgamma(b)
    out = np.empty_like(x)
    lo = x < b + 1.0
    # Series: P = x^b e^-x / Gamma(b+1) * sum x^n / prod(b+1..b+n)
    xs = x[lo]
    term = np.ones_like(xs)
    acc = np.ones_like(xs)
    for n in range(1, n_series):
        term = term * xs / (b + n)
        acc += term
    out[lo] = acc * np.exp(b * np.log(np.maximum(xs, 1e-300)) - xs
                           - lg - np.log(b))
    # CF: Q = x^b e^-x / Gamma(b) * cf
    xc = x[~lo]
    tiny = 1e-300
    bb = xc + 1.0 - b
    c = np.full_like(xc, 1e300)
    d = 1.0 / np.maximum(bb, tiny)
    h = d.copy()
    for i in range(1, n_cf):
        an = -i * (i - b)
        bb = bb + 2.0
        d = an * d + bb
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = bb + an / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    out[~lo] = 1.0 - h * np.exp(b * np.log(xc) - xc - lg)
    return out


def gamma_icdf_resid_table64(b: float, n: int = 512):
    """Host-side f64 residual table for Gamma(b, 1) quantiles, b in (1, 2].

    Returns ``(z0, dz, resid, dresid)`` — f32 numpy arrays of the residual
    log-quantile and its z-derivative on ``n`` uniform z knots (n must be a
    multiple of 128 for the kernel row gathers).  Quantiles are solved by
    f64 bisection on :func:`_regularized_gamma_f64` (no scipy dependency).
    """
    import math

    import numpy as np

    if n % 128 != 0:
        raise ValueError("table size must be a multiple of 128 lanes")
    if not 1.0 < b <= 2.0:
        raise ValueError("table covers shapes b in (1, 2]")
    z = np.linspace(_TABLE_Z_LO, _TABLE_Z_HI, n)
    erf = np.vectorize(math.erf)
    u = 0.5 * (1.0 + erf(z / math.sqrt(2.0)))
    phi = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    # Bisection: P(b, .) is strictly increasing on [0, inf).
    lo = np.full(n, 1e-30)
    hi = np.full(n, 80.0)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        below = _regularized_gamma_f64(b, mid) < u
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    q = 0.5 * (lo + hi)
    log_q = np.log(q)
    resid = log_q - np.log(u) / b
    pdf = np.exp((b - 1.0) * log_q - q - math.lgamma(b))
    dlogq = phi / (pdf * q)
    dresid = dlogq - phi / (u * b)
    return (np.float32(z[0]), np.float32(z[1] - z[0]),
            resid.astype(np.float32), dresid.astype(np.float32))


def gamma_from_uniforms_table32(a, u_w, u_boost, z0, dz, resid, dresid):
    """One Gamma(a, 1) variate from two uniforms via the residual table —
    drop-in for :func:`gamma_from_uniforms32` (same boost identity, same
    clipped-u domain, ~1e-6 quantile accuracy) at a fraction of the
    arithmetic.

    ``(z0, dz, resid, dresid)`` come from :func:`gamma_icdf_resid_table64`
    for shape b = 1 + a and must be operands (process pytree leaves), not
    captured constants, to ride the fused path kernel.
    """
    a = jnp.asarray(a, jnp.float32)
    u = jnp.clip(jnp.asarray(u_w, jnp.float32),
                 jnp.float32(6e-8), jnp.float32(1.0 - 6e-8))
    z = ndtri32(u)
    n = resid.shape[0]
    t = (z - z0) / dz
    i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
    frac = jnp.clip(t - i.astype(jnp.float32), jnp.float32(0.0),
                    jnp.float32(1.0))
    g0, g1, d0, d1 = resid[i], resid[i + 1], dresid[i], dresid[i + 1]
    # Cubic Hermite on the knot interval (C1, monotone data well-resolved).
    m0 = d0 * dz
    m1 = d1 * dz
    f2 = frac * frac
    f3 = f2 * frac
    h = (g0 * (jnp.float32(2.0) * f3 - jnp.float32(3.0) * f2 + 1.0)
         + m0 * (f3 - jnp.float32(2.0) * f2 + frac)
         + g1 * (jnp.float32(-2.0) * f3 + jnp.float32(3.0) * f2)
         + m1 * (f3 - f2))
    b = jnp.float32(1.0) + a
    log_w = jnp.clip(h + log32(u) / b, jnp.float32(-20.0),
                     jnp.float32(20.0))
    w = exp32(log_w)
    return w * expneg_wide32(log32(jnp.asarray(u_boost, jnp.float32)) / a)


__all__ = ["gamma1p32", "expneg_wide32", "gamma_icdf_boost32",
           "gamma_from_uniforms32", "gamma_icdf_resid_table64",
           "gamma_from_uniforms_table32"]

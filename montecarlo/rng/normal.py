"""Uniform and normal variates from Threefry counters.

Everything here is pure `jnp` (traces inside Pallas kernels and in plain JAX)
and keyed only by (seed, stream, global path id, draw index), which is what
makes estimates bitwise reproducible under any sharding — unlike the
reference's unseeded global-RNG draws (reference app.py:620).
"""

from __future__ import annotations

import jax.numpy as jnp

from montecarlo.rng.threefry import random_bits

_TWO_PI = 6.283185307179586


def uniform_from_bits(bits, dtype=jnp.float32):
    """Map uint32 bits to a uniform in the *open* interval (0, 1).

    float32 uses the top 23 bits so every value (and the arithmetic producing
    it) is exact: u = ((bits >> 9) + 0.5) * 2^-23  ∈  [2^-24, 1 - 2^-24].
    float64 uses all 32 bits.  Never returns 0 or 1, so log(u) and inverse
    CDFs are always finite.
    """
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64:
        # Split so each half fits in int32 (no uint32->float cast needed).
        hi = (bits >> jnp.uint32(1)).astype(jnp.int32).astype(jnp.float64)
        lo = (bits & jnp.uint32(1)).astype(jnp.int32).astype(jnp.float64)
        return (hi * 2.0 + lo + 0.5) * (2.0 ** -32)
    # Top 23 bits -> non-negative int32 -> float32 is exact.
    hi = (bits >> jnp.uint32(9)).astype(jnp.int32).astype(dtype)
    return (hi + dtype.type(0.5)) * dtype.type(2.0 ** -23)


def boxmuller_pair(b0, b1, dtype=jnp.float32):
    """Two independent standard normals from two uint32 bit arrays."""
    u1 = uniform_from_bits(b0, dtype)
    u2 = uniform_from_bits(b1, dtype)
    r = jnp.sqrt(dtype(-2.0) * jnp.log(u1))
    theta = dtype(_TWO_PI) * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def normal_pair(seed: int, stream: int, c0, c1, dtype=jnp.float32):
    """The canonical Box-Muller pair for counter (c0, c1)."""
    b0, b1 = random_bits(seed, stream, c0, c1)
    return boxmuller_pair(b0, b1, dtype)


def normal_draw(seed: int, stream: int, path_ids, draw_index, dtype=jnp.float32):
    """One standard normal per (global path id, draw index).

    Draw ``m`` of path ``i`` is component ``m & 1`` of the Box-Muller pair
    generated from counter ``(i, m >> 1)``; consecutive draw indices consume
    both halves of each cipher call so no bits are wasted.

    ``draw_index`` may be a scalar or an array broadcastable with
    ``path_ids``.  For a process with ``D`` draws per step the caller passes
    ``draw_index = t * D + d``.
    """
    m = jnp.asarray(draw_index, jnp.uint32)
    z0, z1 = normal_pair(seed, stream, path_ids, m >> jnp.uint32(1), dtype)
    return jnp.where((m & jnp.uint32(1)) == 0, z0, z1)


def normal_matrix(seed: int, stream: int, path_ids, t: int, n_draws: int,
                  dtype=jnp.float32):
    """``n_draws`` standard normals per path for time step ``t``.

    Returns an array of shape ``path_ids.shape + (n_draws,)``.  Uses the
    draw-index convention ``m = t * n_draws + d`` so the stream is identical
    no matter how paths or steps are blocked.
    """
    d = jnp.arange(n_draws, dtype=jnp.uint32)
    m = jnp.asarray(t).astype(jnp.uint32) * jnp.uint32(n_draws) + d  # (n_draws,)
    ids = jnp.asarray(path_ids, jnp.uint32)[..., None]
    return normal_draw(seed, stream, ids, m, dtype)


def uniform_draw(seed: int, stream: int, path_ids, draw_index,
                 dtype=jnp.float32):
    """One uniform(0,1) per (global path id, draw index) — same convention
    as :func:`normal_draw` (component ``m & 1`` of the 64-bit cipher output
    for counter ``(i, m >> 1)``)."""
    m = jnp.asarray(draw_index, jnp.uint32)
    b0, b1 = random_bits(seed, stream, path_ids, m >> jnp.uint32(1))
    bits = jnp.where((m & jnp.uint32(1)) == 0, b0, b1)
    return uniform_from_bits(bits, dtype)


def uniform_pair(seed: int, stream: int, c0, c1, dtype=jnp.float32):
    """Both uniform(0,1) halves of one cipher call — draw indices 2*c1 and
    2*c1 + 1 of :func:`uniform_draw`, computed with ONE Threefry invocation
    (explicit sharing: CSE across separate calls is unreliable in Pallas
    kernel bodies — DEVNOTES)."""
    b0, b1 = random_bits(seed, stream, c0, c1)
    return uniform_from_bits(b0, dtype), uniform_from_bits(b1, dtype)


def exp32(x):
    """Accurate float32 exp, bitwise identical on every backend.

    Runtime `exp` lowerings differ between backends and may be biased; a
    bias of 1e-6 relative, compounded per step or amplified by the ~50x
    spot sensitivity of a call payoff, is a real price bias that QMC
    error bars expose.  This version is Cody-Waite range reduction + the
    Cephes expf minimax polynomial using only IEEE-exact f32 mul/add and
    integer shifts (scalar python constants, no captured arrays — same
    constraint as `ndtri32`), so it traces inside the fused kernel, is
    bitwise identical across CPU, XLA:GPU and the kernel, and unbiased to
    ~1e-8 mean relative (max ~2 ULP).

    Domain: |x| <= 20 (result scaling splits 2^n into two exact int
    shifts, n in [-29, 29]); inputs outside clamp to the boundary value.
    Finance pipelines stay far inside (log-prices, rate decays, jump
    sizes).
    """
    x = jnp.asarray(x)
    if x.dtype == jnp.float64:
        # f64 runtime exp is accurate on every backend (and the fused
        # kernels never run x64) — only f32 needs the replacement.
        return jnp.exp(x)
    x = x.astype(jnp.float32)
    x = jnp.clip(x, jnp.float32(-20.0), jnp.float32(20.0))
    # n = round(x / ln2); nf stays in float for the exact Cody-Waite
    # products (LN2_HI has 9 significant bits; |nf| <= 29 needs 5 more).
    nf = jnp.floor(x * jnp.float32(1.4426950408889634) + jnp.float32(0.5))
    r = x - nf * jnp.float32(0.693359375)          # exact
    r = r - nf * jnp.float32(-2.12194440054690583e-4)
    # Cephes expf minimax on |r| <= ln2/2 + half-ulp slack.
    p = jnp.float32(1.9875691500e-4)
    p = p * r + jnp.float32(1.3981999507e-3)
    p = p * r + jnp.float32(8.3334519073e-3)
    p = p * r + jnp.float32(4.1665795894e-2)
    p = p * r + jnp.float32(1.6666665459e-1)
    p = p * r + jnp.float32(5.0000001201e-1)
    er = p * r * r + r + jnp.float32(1.0)
    # 2^n via two exact integer shifts (n split so both stay in [0, 31]).
    n = nf.astype(jnp.int32)
    n1 = jnp.right_shift(n, 1)  # arithmetic shift: floor(n/2), negatives ok
    n2 = n - n1
    s1 = jnp.left_shift(jnp.int32(1), n1 + jnp.int32(15)).astype(jnp.float32)
    s2 = jnp.left_shift(jnp.int32(1), n2 + jnp.int32(15)).astype(jnp.float32)
    return er * s1 * (s2 * jnp.float32(2.0 ** -30))


def log32(x):
    """Accurate float32 log, bitwise identical on every backend.

    Every log-state process initializes `log_s = log(s0)`; a runtime `log`
    that is off by ~1e-4 additive at price-scale arguments (an
    approximate accelerator lowering can be) becomes, through the ~50x
    spot sensitivity of a 1y call, a ~1e-3 price bias — invisible to
    plain-MC error bars, hundreds of sigma under a bridge-RQMC bar.  XLA
    may hide it by constant-folding log(s0) on host when s0 is a
    compile-time literal; with process params as jit operands (every real
    pipeline) the runtime log executes.

    One Newton step y' = y + (x*exp32(-y) - 1) for f(y) = e^y - x from the
    platform log's seed (any ~1e-4-accurate seed converges): additive
    error lands at the f32 rounding floor (~ULP(log x)/2, mean bias
    ~1e-8).  Traces inside the kernel; domain x in [2.5e-9, 5e8] (so
    -log x stays in exp32's range); inputs clamp to that interval.
    """
    x = jnp.asarray(x)
    if x.dtype == jnp.float64:
        return jnp.log(x)  # accurate in f64 on every backend
    x = x.astype(jnp.float32)
    x = jnp.clip(x, jnp.float32(2.5e-9), jnp.float32(5e8))
    y = jnp.log(x)
    return y + (x * exp32(-y) - jnp.float32(1.0))


def ndtri32(u, dtype=jnp.float32):
    """Inverse standard-normal CDF, Pallas-lowerable.

    Wichura's AS241 PPND7 rational approximation (~1e-7 absolute error —
    below float32 round-off for the QMC use) written with *scalar* python
    constants: `jax.scipy.special.ndtri` captures constant coefficient
    arrays, which `pallas_call` rejects, so the device-Sobol samplers use
    this everywhere (scan engine AND fused kernel) — one implementation,
    bitwise-consistent streams.  Input must be in the open interval (0, 1).
    """
    dtype = jnp.dtype(dtype)
    u = jnp.asarray(u, dtype)
    q = u - dtype.type(0.5)

    # Central region |q| <= 0.425.
    r_c = dtype.type(0.180625) - q * q
    num_c = q * (((dtype.type(59.109374720) * r_c
                   + dtype.type(159.29113202)) * r_c
                  + dtype.type(50.434271938)) * r_c
                 + dtype.type(3.3871327179))
    den_c = (((dtype.type(67.187563600) * r_c
               + dtype.type(78.757757664)) * r_c
              + dtype.type(17.895169469)) * r_c
             + dtype.type(1.0))
    central = num_c / den_c

    # Tails: r = sqrt(-log(min(u, 1-u))), guarded so the unselected branch
    # never produces NaN (min(u,1-u) <= 0.5 in reality).
    p_tail = jnp.minimum(jnp.minimum(u, dtype.type(1.0) - u),
                         dtype.type(0.5))
    # Floor keeps log finite even for u rounding to exactly 0 or 1 (must
    # stay in the *normal* f32 range — subnormals may flush to zero).
    p_tail = jnp.maximum(p_tail, dtype.type(1e-30))
    r_t = jnp.sqrt(-jnp.log(p_tail))

    r1 = r_t - dtype.type(1.6)
    num_m = (((dtype.type(0.17023821103) * r1
               + dtype.type(1.3067284816)) * r1
              + dtype.type(2.7568153900)) * r1
             + dtype.type(1.4234372777))
    den_m = ((dtype.type(0.12021132975) * r1
              + dtype.type(0.73700164250)) * r1
             + dtype.type(1.0))

    r2 = r_t - dtype.type(5.0)
    num_f = (((dtype.type(0.017337203997) * r2
               + dtype.type(0.42868294337)) * r2
              + dtype.type(3.0812263860)) * r2
             + dtype.type(6.6579051150))
    den_f = ((dtype.type(0.012258202635) * r2
              + dtype.type(0.24197894225)) * r2
             + dtype.type(1.0))

    tail = jnp.where(r_t <= dtype.type(5.0), num_m / den_m, num_f / den_f)
    tail = jnp.where(q < 0, -tail, tail)
    return jnp.where(jnp.abs(q) <= dtype.type(0.425), central, tail)


def index_from_uniform(u, n):
    """Map a uniform in (0,1) to an integer index in [0, n) — THE shared
    uniform->index rule (floor(u*n) with an n-1 clamp for the u->1 edge).
    Used by :func:`categorical_draw` and the GARCH bootstrap's resampling
    (processes/garch.py), which must agree for the determinism contract.
    ``n`` may be a traced int32 scalar."""
    nf = (jnp.float32(n) if isinstance(n, int)
          else jnp.asarray(n).astype(jnp.float32))
    idx = jnp.floor(jnp.asarray(u, jnp.float32) * nf).astype(jnp.int32)
    return jnp.minimum(idx, (jnp.asarray(n) - 1).astype(jnp.int32))


def categorical_draw(seed: int, stream: int, path_ids, draw_index, n: int):
    """A uniform integer index in [0, n) per (path, draw) — the
    counter-based replacement for `np.random.choice` (reference app.py:620).  The GARCH
    bootstrap draws its uniform separately (pair-sharing the cipher) but
    maps it through the same :func:`index_from_uniform`."""
    u = uniform_draw(seed, stream, path_ids, draw_index, jnp.float32)
    return index_from_uniform(u, n)

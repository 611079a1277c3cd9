"""Threefry-2x32 counter-based RNG, written once in `jnp` uint32 ops.

The same function traces correctly inside the Pallas path kernel and in plain
JAX on any backend, so the Pallas fast path and the `lax.scan` reference
engine produce *bitwise identical* random streams by construction.

Why counter-based: the reference app draws bootstrap shocks from the
**unseeded global NumPy RNG** (reference app.py:620, `np.random.choice`),
so its Monte Carlo is not reproducible at all.  Here every draw is a pure
function ``draw = f(key, counter)`` where the counter encodes the *global*
path id and time step — therefore any path is independently seedable and the
whole simulation is bitwise reproducible under any mesh shape / sharding.

Algorithm: Threefry-2x32, 20 rounds (Salmon et al., "Parallel Random Numbers:
As Easy as 1, 2, 3", SC'11) — the same generator family JAX's own
`jax.random` uses.  Tests validate against `jax._src.prng.threefry_2x32`.

Counter / key convention used throughout this framework
--------------------------------------------------------
- key   = (k0, k1) = (seed_lo32, seed_hi32 XOR stream)
- c0    = global path id  (uint32)
- c1    = draw index      (uint32)

For a process needing ``D`` draws per path per step, the draw for
(path i, step t, dim d) is component ``m & 1`` of the Box-Muller pair
produced from counter ``c1 = m >> 1`` where ``m = t * D + d``
(see :mod:`montecarlo.rng.normal`).  Both outputs of each cipher call
are consumed, so nothing is wasted.
"""

from __future__ import annotations

import jax.numpy as jnp

# Rotation schedule for Threefry-2x32 (Salmon et al. 2011, table 2).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Threefry key-schedule parity constant (0x1BD11BDA for 32-bit words).
_PARITY = 0x1BD11BDA


def _rotl32(x, r: int):
    """Rotate a uint32 array left by the static amount ``r``."""
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds.

    Args:
      k0, k1: uint32 key words (arrays broadcastable against the counters).
      c0, c1: uint32 counter words.

    Returns:
      (x0, x1): two uint32 arrays of the broadcast shape — 64 bits of output
      per counter.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(c0, jnp.uint32) + k0
    x1 = jnp.asarray(c1, jnp.uint32) + k1
    k2 = k0 ^ k1 ^ jnp.uint32(_PARITY)
    # Key-injection schedule: keys cycle (k0, k1, k2); after 4*j rounds the
    # injection is (ks[j % 3], ks[(j+1) % 3] + j).
    ks = (k0, k1, k2)
    for j in range(5):  # 5 blocks of 4 rounds = 20 rounds
        rots = _ROTATIONS[j % 2]
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl32(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(j + 1) % 3]
        x1 = x1 + ks[(j + 2) % 3] + jnp.uint32(j + 1)
    return x0, x1


def key_from_seed(seed: int, stream: int = 0):
    """Derive the (k0, k1) Threefry key from a 64-bit seed and a stream id.

    Independent logical streams (e.g. the normal shocks vs. the bootstrap
    index draws of the GARCH process, or per-asset substreams) use distinct
    ``stream`` values so their outputs are independent for any seed.
    """
    seed = int(seed)
    k0 = jnp.uint32(seed & 0xFFFFFFFF)
    k1 = jnp.uint32(((seed >> 32) & 0xFFFFFFFF) ^ (int(stream) & 0xFFFFFFFF))
    return k0, k1


def key_from_seed_dynamic(seed, stream=0):
    """Like :func:`key_from_seed` but also accepts traced (runtime) values.

    Traced seeds are treated as 32-bit (k0 = seed, k1 = stream), which agrees
    exactly with :func:`key_from_seed` for any python-int seed < 2**32 — so
    jitted call sites can switch seeds without recompiling.
    """
    if isinstance(seed, int) and isinstance(stream, int):
        return key_from_seed(seed, stream)
    k0 = jnp.asarray(seed).astype(jnp.uint32)
    k1 = jnp.asarray(stream).astype(jnp.uint32)
    return k0, k1


def random_bits(seed, stream, c0, c1):
    """64 bits of pseudo-randomness per (c0, c1) counter pair.

    ``seed``/``stream`` may be python ints (full 64-bit seed space) or traced
    uint32 values (inside jit/Pallas; they become the key words directly —
    identical streams for seeds < 2**32).  Returns two uint32 arrays of the
    broadcast shape of ``c0``/``c1``.
    """
    k0, k1 = key_from_seed_dynamic(seed, stream)
    return threefry2x32(k0, k1, c0, c1)

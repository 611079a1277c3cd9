"""Device-native Sobol sequence generation.

The host-precomputed `SobolSampler` materializes an (n_paths, n_steps,
n_draws) array — fine for QMC studies, impossible at pod scale.  This module
generates Sobol points **on device, per step, from the global path id**:

    point(i, dim) = XOR_{k : bit k of gray(i)} V[dim, k]

where V are Joe-Kuo direction numbers (extracted once from scipy's table at
sampler construction) and gray(i) = i ^ (i >> 1).  Construction is verified
against `scipy.stats.qmc.Sobol` bit-for-bit in tests.

Randomization is a per-dimension hash-based *Owen scramble* (nested uniform
scramble via the Laine-Karras hash, keyed by a Threefry word derived from
(seed, stream, dim) — see `_shifted_normal`): unbiased randomized QMC whose
replications (over seeds) estimate the error, and the stream stays a pure
function of (seed, stream, global path id, dimension) — the framework's
shard-invariance contract.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo.rng.normal import ndtri32
from montecarlo.rng.threefry import random_bits

BITS = 30


def direction_numbers(n_dims: int) -> np.ndarray:
    """(n_dims, 30) uint32 Joe-Kuo direction numbers via scipy's table."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=n_dims, scramble=False, bits=BITS)
    return np.asarray(eng._sv, np.uint32)


def lms_scramble(sv: np.ndarray, seed: int) -> np.ndarray:
    """Matousek linear matrix scramble of Sobol direction numbers.

    Left-multiplies each dimension's generating matrix by a random
    nonsingular lower-triangular bit matrix (ones on the diagonal), host-
    side and once per sampler — Owen-like equidistribution quality with
    zero extra device cost (the device kernel XORs the scrambled direction
    numbers exactly as the plain ones).  Pair with a per-dimension digital
    shift for unbiased randomized QMC.
    """
    rng = np.random.default_rng(seed)
    d, n_bits = sv.shape
    # bits[dim, k, i] = bit i (MSB-first) of direction number k.
    shifts = (n_bits - 1 - np.arange(n_bits, dtype=np.uint32))
    bits = (sv[:, :, None] >> shifts[None, None, :]) & 1  # (d, 30, 30)
    # Random lower-triangular M per dim (MSB-first ordering, unit diagonal).
    m = rng.integers(0, 2, size=(d, n_bits, n_bits), dtype=np.uint32)
    tril = np.tril(np.ones((n_bits, n_bits), np.uint32), -1)
    m = m * tril + np.eye(n_bits, dtype=np.uint32)
    # v'[i] = XOR_j m[i, j] & v[j]  (GF(2) matvec per direction number).
    out_bits = (np.einsum("dij,dkj->dki", m, bits) & 1).astype(np.uint32)
    return (out_bits << shifts[None, None, :]).sum(axis=2).astype(np.uint32)


def sobol_bits(sv_rows, path_ids):
    """Raw Sobol integers in [0, 2^30) for one dimension.

    Args:
      sv_rows: (30,) uint32 direction numbers of the dimension.
      path_ids: uint32 array of point indices (any shape).
    """
    g = path_ids ^ (path_ids >> jnp.uint32(1))  # Gray code
    x = jnp.zeros_like(path_ids)
    for k in range(BITS):
        bit = (g >> jnp.uint32(k)) & jnp.uint32(1)
        x = x ^ (sv_rows[k] * bit)
    return x


def _reverse32(x):
    """Bit-reverse a uint32 array (5-step butterfly — shifts/masks only)."""
    x = ((x >> jnp.uint32(1)) & jnp.uint32(0x55555555)) | \
        ((x & jnp.uint32(0x55555555)) << jnp.uint32(1))
    x = ((x >> jnp.uint32(2)) & jnp.uint32(0x33333333)) | \
        ((x & jnp.uint32(0x33333333)) << jnp.uint32(2))
    x = ((x >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F)) | \
        ((x & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4))
    x = ((x >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF)) | \
        ((x & jnp.uint32(0x00FF00FF)) << jnp.uint32(8))
    return (x >> jnp.uint32(16)) | (x << jnp.uint32(16))


def _scrambled_uniform(x, shift_bits):
    """Owen-scrambled Sobol integer -> uniform in the open interval.

    The per-dimension randomization is a hash-based Owen scramble
    (Laine-Karras hash in the bit-reversed domain — Burley, "Practical
    Hash-based Owen Scrambling", JCGT 2020), keyed by the Threefry word
    ``shift_bits``: each bit is flipped by a nonlinear hash of the more
    significant bits, so base-2 strata are preserved (QMC quality keeps —
    asserted exactly in tests) while WITHIN-stratum offsets are effectively
    independent across cells and replicates.  A plain digital XOR shift is
    NOT enough: composed with any linear matrix scramble it leaves the
    within-stratum offset a GF(2)-LINEAR function of the stratum index,
    and on problems with effective dimension ~1 (Brownian-bridge ordering
    + terminal payoffs, where dim 0 carries all the variance) every
    replicate then shares a midpoint-rule-like error component — observed
    as a ~25-sigma "bias" the replicate spread cannot see.

    The uniform takes the top 23 bits with a half-ulp center, so the
    arithmetic is *exact* in float32 and u ∈ [2⁻²⁴, 1 − 2⁻²⁴] — the naive
    ``(x + 0.5) * 2^-30`` rounds to exactly 1.0f for the largest values and
    ndtri returns NaN.
    """
    # 30-bit Sobol int -> MSB-aligned 32-bit, hash LSB-up in the reversed
    # domain (= Owen MSB-down), reverse back.
    y = _reverse32(x << jnp.uint32(32 - BITS))
    y = y + shift_bits
    y = y ^ (y * jnp.uint32(0x6C50B47C))
    y = y ^ (y * jnp.uint32(0xB82F1E52))
    y = y ^ (y * jnp.uint32(0xC7AFE638))
    y = y ^ (y * jnp.uint32(0x8D22F6E6))
    y = _reverse32(y)
    hi = (y >> jnp.uint32(9)).astype(jnp.int32).astype(jnp.float32)
    return (hi + jnp.float32(0.5)) * jnp.float32(2.0 ** -23)


def _shifted_normal(x, shift_bits, dtype):
    """Owen-scrambled Sobol integer -> standard normal (see
    `_scrambled_uniform`).  Shared by the scan-engine and Pallas-kernel
    paths, so their streams are identical by construction."""
    u = _scrambled_uniform(x, shift_bits)
    return ndtri32(u, jnp.float32).astype(dtype)


class SobolDeviceSampler(NamedTuple("SobolDeviceFields", [
        ("sv", jnp.ndarray),    # (n_dims, 30) uint32 direction numbers
])):
    """Drop-in sampler generating randomized Sobol normals on device.

    Dimension of (step t, draw d) is ``t * n_draws + d``; the Owen-hash
    key word comes from Threefry keyed by (seed, stream, dim), so different
    seeds give independent randomizations of the same point set.

    Runs in the `lax.scan` engine and inside the fused path kernel with the
    same ``draws`` (``self.sv[dim][k]`` is a gather in one and an indexed
    load in the other), so the draw streams are identical.

    NORMALS ONLY: every dimension maps through the inverse CDF — valid for
    NormalDrawsMixin processes only (the engines reject jump/bootstrap
    processes whose draw slots are uniforms).
    """

    normals_only = True

    def draws(self, process, seed, stream, path_ids, t, dtype=jnp.float32):
        D = process.n_draws
        out = []
        for d in range(D):
            dim = jnp.asarray(t).astype(jnp.int32) * D + d
            rows = self.sv[dim]  # (30,)
            x = sobol_bits(rows, path_ids)
            # Owen-hash key: one Threefry word per dimension.
            s0, _ = random_bits(seed, stream, dim.astype(jnp.uint32),
                                jnp.uint32(0x50B0))
            out.append(_shifted_normal(x, s0, dtype))
        return tuple(out)

    @property
    def n_dims(self) -> int:
        return self.sv.shape[0]

    def validate(self, process, n_steps: int) -> None:
        """Trace-time guard called by the engines: ``sv[dim]`` past the
        table is a *clamping* gather — later steps would silently reuse the
        last dimension's point (biased, no error)."""
        need = n_steps * process.n_draws
        if self.n_dims < need:
            raise ValueError(
                f"Sobol table has {self.n_dims} dimensions but this run "
                f"needs n_steps*n_draws = {n_steps}*{process.n_draws} = "
                f"{need}; build with SobolDeviceSampler.create({n_steps}, "
                f"{process.n_draws})")

    @classmethod
    def create(cls, n_steps: int, n_draws: int = 1,
               scramble_seed: int | None = 0) -> "SobolDeviceSampler":
        """``scramble_seed`` applies a linear matrix scramble to the
        direction numbers (None disables it — raw Joe-Kuo)."""
        sv = direction_numbers(n_steps * n_draws)
        if scramble_seed is not None:
            sv = lms_scramble(sv, scramble_seed)
        return cls(sv=jnp.asarray(sv))


def brownian_bridge_matrix(n_steps: int) -> np.ndarray:
    """(T, T) matrix B with ``increments = z @ B.T`` for the bridge ordering.

    Row t of B expresses increment W_{t+1} - W_t as a linear combination of
    the bridge normals z_0..z_{T-1} (z_0 sets the endpoint, then midpoints
    of the widest remaining intervals — the same ordering as
    ``samplers._brownian_bridge_increments``).  Each row has O(log T)
    nonzeros, and the rows are orthonormal (increments stay i.i.d. N(0,1)).
    """
    T = n_steps
    a = np.zeros((T + 1, T))
    a[T, 0] = np.sqrt(float(T))
    k = 1
    segments = [(0, T)]
    while segments:
        nxt = []
        for (l, r) in segments:
            if r - l <= 1:
                continue
            mid = (l + r) // 2
            a[mid] = ((r - mid) * a[l] + (mid - l) * a[r]) / (r - l)
            a[mid, k] += np.sqrt((mid - l) * (r - mid) / (r - l))
            k += 1
            nxt += [(l, mid), (mid, r)]
        segments = nxt
    assert k == T, (k, T)
    return np.diff(a, axis=0)


def _bridge_tables(n_steps: int, scramble_seed):
    """(sv, dims, coeffs) numpy tables of the bridge construction: sv the
    (optionally LMS-scrambled) direction numbers, and per step the O(log T)
    contributing bridge dims + combination weights (rows padded to a fixed
    width with (dim 0, coeff 0) — position j within a row is the dim's tree
    level, levels active at t are contiguous from the root)."""
    b = brownian_bridge_matrix(n_steps)
    nnz = [np.nonzero(row)[0] for row in b]
    width = max(len(ix) for ix in nnz)
    dims = np.zeros((n_steps, width), np.int32)
    coeffs = np.zeros((n_steps, width), np.float32)
    for t, ix in enumerate(nnz):
        dims[t, :len(ix)] = ix
        coeffs[t, :len(ix)] = b[t, ix]
    sv = direction_numbers(n_steps)
    if scramble_seed is not None:
        sv = lms_scramble(sv, scramble_seed)
    return sv, dims, coeffs


class SobolBridgeDeviceSampler(NamedTuple("SobolBridgeFields", [
        ("sv", jnp.ndarray),      # (T, 30) uint32 direction numbers
        ("dims", jnp.ndarray),    # (T, L) int32 contributing bridge dims
        ("coeffs", jnp.ndarray),  # (T, L) f32 combination weights
])):
    """Device-native Sobol with Brownian-bridge ordering (TODO perf item 2).

    The host-precomputed ``SobolSampler(bridge=True)`` materializes the full
    (n_paths, n_steps) draw array; this sampler instead evaluates, at step
    t, only the O(log T) bridge normals that increment t actually depends
    on — each regenerated from the global path id (shard-invariant), mapped
    through the inverse CDF, and combined with the static bridge weights:

        eps_t = sum_j coeffs[t, j] * ndtri(sobol_dim(dims[t, j], path_id))

    The low-index (highest-quality) Sobol dimensions carry the path's
    coarse structure exactly as in the host bridge; randomization is the
    same per-dimension Owen-hash scramble as :class:`SobolDeviceSampler`.
    Single-draw processes only (n_draws == 1).  NORMALS ONLY (see
    SobolDeviceSampler).
    """

    normals_only = True

    def validate(self, process, n_steps: int) -> None:
        """Trace-time guard (see SobolDeviceSampler.validate)."""
        if process.n_draws != 1:
            raise ValueError("bridge sampler supports n_draws == 1")
        if n_steps > self.dims.shape[0]:
            raise ValueError(
                f"bridge sampler built for {self.dims.shape[0]} steps but "
                f"this run has {n_steps}; build with "
                f"SobolBridgeDeviceSampler.create({n_steps})")

    def draws(self, process, seed, stream, path_ids, t, dtype=jnp.float32):
        if process.n_draws != 1:
            raise ValueError("bridge sampler supports n_draws == 1")
        t = jnp.asarray(t).astype(jnp.int32)
        dims_t = self.dims[t]      # (L,)
        coeffs_t = self.coeffs[t]  # (L,)
        L = self.dims.shape[1]
        eps = jnp.zeros(path_ids.shape, dtype)
        for j in range(L):
            dim = dims_t[j]
            rows = self.sv[dim]
            x = sobol_bits(rows, path_ids)
            s0, _ = random_bits(seed, stream, dim.astype(jnp.uint32),
                                jnp.uint32(0x50B0))
            z = _shifted_normal(x, s0, dtype)
            eps = eps + coeffs_t[j].astype(dtype) * z
        return (eps,)

    @classmethod
    def create(cls, n_steps: int,
               scramble_seed: int | None = 0) -> "SobolBridgeDeviceSampler":
        sv, dims, coeffs = _bridge_tables(n_steps, scramble_seed)
        return cls(sv=jnp.asarray(sv), dims=jnp.asarray(dims),
                   coeffs=jnp.asarray(coeffs))

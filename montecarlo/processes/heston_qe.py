"""Heston under Andersen's Quadratic-Exponential (QE) scheme.

The full-truncation Euler scheme (`processes/heston.py`, BASELINE.json
config 4) discretizes the variance SDE directly and pays O(dt) bias —
material at coarse step counts, worst when the Feller condition
``2 kappa theta >= xi^2`` fails (equity calibrations routinely violate
it).  QE (Andersen 2008, "Simple and efficient simulation of the Heston
stochastic volatility process") instead samples ``v_{t+1}`` from a
distribution that matches the EXACT conditional mean and variance of the
CIR transition:

    m  = theta + (v_t - theta) e^{-kappa dt}
    s2 = v_t (xi^2/kappa) e^{-kappa dt} (1 - e^{-kappa dt})
         + theta (xi^2 / 2kappa) (1 - e^{-kappa dt})^2
    psi = s2 / m^2

    psi <= psi_c:  v' = a (b + Z)^2            (moment-matched quadratic)
                   b^2 = 2/psi - 1 + sqrt(2/psi) sqrt(2/psi - 1),
                   a = m / (1 + b^2),  Z = ndtri(U)
    psi >  psi_c:  v' = 0                 with prob p = (psi-1)/(psi+1)
                   v' = log((1-p)/(1-U)) / beta  otherwise,
                   beta = (1-p)/m         (mass at zero + exponential tail)

with the standard switching point ``psi_c = 1.5`` (either branch is valid
on [1, 2]).  Both branches consume ONE uniform, so the per-step draw
budget is 1 normal (asset) + 1 uniform (variance) on separate key streams
— branch-free via elementwise selects, the vectorized form of Andersen's
if/else (cf. the Kou jump kernel, `processes/kou.py`).

The asset leg uses Andersen's central discretization of the exact
log-spot decomposition (gamma1 = gamma2 = 1/2):

    log S' = log S + mu dt + K0 + K1 v + K2 v' + sqrt(K3 v + K4 v') Z_s

with the MARTINGALE CORRECTION (Andersen sec. 4.2, "QE-M"): K0 is chosen
per path so that ``E[S'/S | v] = e^{mu dt}`` holds exactly — the
conditional MGF ``E[e^{A v'} | v]`` (A = K2 + K4/2) is closed-form for
both QE branches.  Where the MGF diverges (only possible for rho large
and positive, ``2 A a >= 1`` or ``A >= beta``) the plain drift constant
``K0 = -rho kappa theta dt / xi`` is used for that path-step; equity-like
``rho <= 0`` never triggers the fallback (A <= 0 there).

Same result contract as `Heston` (the scan and fused engines, samplers,
LSM, and the sharded estimators all take it unchanged); reference analog:
the Euler Heston is the rebuild's config-4 process — QE is the accuracy
upgrade on the same model, priced against the SAME CF oracle
(`engine/heston_analytic.py`).

Determinism note: unlike the short-chain processes, QE's scan and fused
engines agree to f32 ULP level but NOT bitwise — the five-term drift
chain has several mul->add contraction sites and this stack compiles
with --xla_allow_excess_precision=true, so the two programs contract
differently at the last ULP (every individual term measured bitwise;
only the summation flips).  Within one engine results are exactly
reproducible, which is what DEVNOTES' determinism contract pins.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from montecarlo.rng.normal import (exp32, log32, ndtri32, normal_draw,
                                       normal_pair, uniform_draw,
                                       uniform_pair)

#: Key-stream offset for the variance uniforms (distinct from the jump
#: stream 0x6A09E667): normals and uniforms never share cipher calls.
#: Must fit int32 — stream values stay exact under no-x64 tracing.
_V_STREAM = 0x5BE0CD19

#: Andersen's switching point between the quadratic and exponential
#: branches (both are valid on psi in [1, 2]; 1.5 is his recommendation).
PSI_C = 1.5


class HestonQEState(NamedTuple):
    log_s: jnp.ndarray  # (n_paths,)
    v: jnp.ndarray      # (n_paths,) — QE keeps v >= 0 by construction


class QEVarianceMixin:
    """The QE variance transition + martingale-corrected drift constant,
    shared by :class:`HestonQE` and the jump extension
    (:class:`~montecarlo.processes.bates_qe.BatesQE`) — one copy of
    the scheme algebra, parameterized by the precomputed leaves
    ``e_kdt/c1/c2/k0/k1/k3/mgf_a`` both carry."""

    def _next_v(self, v, u, dtype):
        """One QE variance transition: (v_next, quad_mask, a, b2, p, beta).

        The branch intermediates are returned for the martingale
        correction (their conditional MGFs close the drift).

        The algebra is the psi-free rearrangement: the branch test and tail probability are written directly
        in (m^2, s2) — ``psi <= psi_c`` as ``s2 <= psi_c m^2``,
        ``(psi-1)/(psi+1)`` as ``(s2-m^2)/(s2+m^2)`` — saving a divide,
        and ``sqrt(2/psi) sqrt(2/psi-1)`` fuses into one sqrt of the
        product (both factors nonnegative under the clamp)."""
        one = dtype.type(1.0)
        m = self.theta.astype(dtype) + (v - self.theta.astype(dtype)) \
            * self.e_kdt.astype(dtype)                       # > 0
        s2 = v * self.c1.astype(dtype) + self.c2.astype(dtype)
        m2 = jnp.square(m)
        quad = s2 <= dtype.type(PSI_C) * m2                  # psi <= psi_c
        # Quadratic branch (clamps keep the UNUSED lane's algebra finite:
        # 2/psi - 1 < 0 once psi > 2, which only happens when quad=False).
        inv2 = 2.0 * m2 / s2                                 # 2/psi
        tw1 = jnp.maximum(inv2 - one, 0.0)
        b2 = jnp.maximum(inv2 - one + jnp.sqrt(inv2 * tw1), 0.0)
        a = m / (one + b2)
        z_v = ndtri32(u, dtype)
        v_quad = a * jnp.square(jnp.sqrt(b2) + z_v)
        # Exponential branch: mass p at zero + exponential tail.  In the
        # used branch psi > 1.5 so p in (0.2, 1); the (1-p)/(1-u) ratio is
        # finite for open-interval uniforms, and lanes with u <= p take
        # the zero mass.
        p = (s2 - m2) / (s2 + m2)                            # (psi-1)/(psi+1)
        beta = (one - p) / m
        tail = log32((one - p) / (one - u)) / beta
        v_exp = jnp.where(u <= p, 0.0, jnp.maximum(tail, 0.0))
        return jnp.where(quad, v_quad, v_exp), quad, a, b2, p, beta

    def _k0_star(self, v, quad, a, b2, p, beta, dtype):
        """Per-path martingale-corrected drift constant (Andersen 4.2):
        K0* = -log E[e^{A v'} | v] - (K1 + K3/2) v, closed-form per
        branch; falls back to the plain K0 where the MGF diverges (only
        reachable for strongly positive rho).

        The two branches' MGF logs are lane-exclusive, so ONE log32 runs
        on a branch-selected argument (qe_profile.py variant E — log32 is
        a 9-term Newton-over-exp32 chain, the single hottest op here)."""
        one = dtype.type(1.0)
        A = self.mgf_a.astype(dtype)
        den = one - 2.0 * A * a
        ok_q = den > 0.0
        den_s = jnp.where(ok_q, den, one)
        gap = beta - A
        ok_e = gap > 0.0
        mgf_e = jnp.maximum(p + beta * (one - p)
                            / jnp.where(ok_e, gap, one),
                            dtype.type(1e-30))
        lg = log32(jnp.where(quad, den_s, mgf_e))
        lm = jnp.where(quad, A * b2 * a / den_s - 0.5 * lg, lg)
        # Logical ops, not a bool-payload select.
        ok = jnp.logical_or(jnp.logical_and(quad, ok_q),
                            jnp.logical_and(jnp.logical_not(quad), ok_e))
        head = -(self.k1.astype(dtype) + 0.5 * self.k3.astype(dtype)) * v
        return jnp.where(ok, head - lm, self.k0.astype(dtype))


def qe_constants(kappa, theta, xi, rho, dt, dtype):
    """The create-time QE leaves shared by HestonQE and BatesQE:
    (e_kdt, c1, c2, k0, k1, k2, k3/k4, mgf_a)."""
    e = jnp.exp(-kappa * dt)
    c1 = xi * xi * e * (1.0 - e) / kappa
    c2 = theta * xi * xi * jnp.square(1.0 - e) / (2.0 * kappa)
    g = jnp.asarray(0.5, dtype)  # gamma1 = gamma2 = 1/2 (central)
    rx = rho / xi
    k1 = g * dt * (kappa * rx - 0.5) - rx
    k2 = g * dt * (kappa * rx - 0.5) + rx
    k34 = g * dt * (1.0 - jnp.square(rho))
    return e, c1, c2, -rx * kappa * theta * dt, k1, k2, k34, k2 + 0.5 * k34


class HestonQE(QEVarianceMixin, NamedTuple("HestonQEFields", [
        ("s0", jnp.ndarray),
        ("v0", jnp.ndarray),
        ("mu", jnp.ndarray),
        ("kappa", jnp.ndarray),
        ("theta", jnp.ndarray),
        ("xi", jnp.ndarray),
        ("rho", jnp.ndarray),
        ("dt", jnp.ndarray),
        # Precomputed per-step constants (create-time; plain functions of
        # the parameters above, kept as leaves so step() is pure arithmetic
        # and gradients flow through create via their defining formulas).
        ("e_kdt", jnp.ndarray),   # e^{-kappa dt}
        ("c1", jnp.ndarray),      # s2 = v c1 + c2
        ("c2", jnp.ndarray),
        ("k0", jnp.ndarray),      # uncorrected drift constant (fallback)
        ("k1", jnp.ndarray),
        ("k2", jnp.ndarray),
        ("k3", jnp.ndarray),
        ("k4", jnp.ndarray),
        ("mgf_a", jnp.ndarray),   # A = k2 + k4/2 (martingale correction)
])):
    """Heston model under the Andersen QE-M scheme."""

    n_draws = 2  # z_asset (normal) + u_variance (uniform, own stream)
    draw_kinds = ("normal", "uniform")

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, dt,
               dtype=jnp.float32):
        if float(xi) <= 0.0:
            raise ValueError("xi must be positive (xi=0 is BS — use GBM)")
        if float(kappa) <= 0.0:
            raise ValueError("kappa must be positive (QE's conditional "
                             "moments use the mean-reverting transition)")
        as_ = lambda v: jnp.asarray(v, dtype)
        kappa_, theta_, xi_, rho_, dt_ = (as_(kappa), as_(theta), as_(xi),
                                          as_(rho), as_(dt))
        e, c1, c2, k0, k1, k2, k34, mgf_a = qe_constants(
            kappa_, theta_, xi_, rho_, dt_, dtype)
        return cls(s0=as_(s0), v0=as_(v0), mu=as_(mu), kappa=kappa_,
                   theta=theta_, xi=xi_, rho=rho_, dt=dt_, e_kdt=e,
                   c1=c1, c2=c2, k0=k0, k1=k1, k2=k2, k3=k34, k4=k34,
                   mgf_a=mgf_a)

    def init_state(self, path_ids, dtype=jnp.float32) -> HestonQEState:
        shape = path_ids.shape
        return HestonQEState(
            log_s=jnp.full(shape, log32(self.s0).astype(dtype), dtype),
            v=jnp.full(shape, self.v0.astype(dtype), dtype),
        )

    def draws(self, seed, stream, path_ids, t, dtype=jnp.float32):
        tt = jnp.asarray(t).astype(jnp.uint32)
        return (normal_draw(seed, stream, path_ids, tt, dtype),
                uniform_draw(seed, stream ^ _V_STREAM, path_ids, tt,
                             dtype))

    def draws_pair(self, seed, stream, path_ids, j, dtype=jnp.float32):
        """Steps (2j, 2j+1) with explicit cipher sharing (fused kernel):
        the two normals are the Box-Muller halves of counter j, the two
        uniforms the halves of counter j on the variance stream — bitwise
        identical to two :meth:`draws` calls by construction."""
        jj = jnp.asarray(j).astype(jnp.uint32)
        z0, z1 = normal_pair(seed, stream, path_ids, jj, dtype)
        u0, u1 = uniform_pair(seed, stream ^ _V_STREAM, path_ids, jj,
                              dtype)
        return (z0, u0), (z1, u1)

    def antithetic(self, eps):
        z, u = eps
        # Mirror the asset normal, reflect the variance uniform (stays
        # uniform on the open interval and anticorrelates both branches'
        # variance draws — ndtri(1-u) = -ndtri(u)).
        return (-z, 1.0 - u)

    def step(self, state: HestonQEState, eps, t) -> HestonQEState:
        dtype = state.log_s.dtype
        z_s, u = eps[0], eps[1]
        v = state.v
        v_new, quad, a, b2, p, beta = self._next_v(v, u, dtype)
        k0s = self._k0_star(v, quad, a, b2, p, beta, dtype)
        var_s = self.k3.astype(dtype) * v + self.k4.astype(dtype) * v_new
        # Double-where guards sqrt's gradient at 0 (cf. Heston.step).
        positive = var_s > 0
        sq = jnp.where(positive,
                       jnp.sqrt(jnp.where(positive, var_s, 1.0)), 0.0)
        log_s = (state.log_s
                 + (self.mu.astype(dtype) * self.dt.astype(dtype) + k0s
                    + self.k1.astype(dtype) * v
                    + self.k2.astype(dtype) * v_new
                    + sq * z_s))
        return HestonQEState(log_s=log_s, v=v_new)

    def prices(self, state: HestonQEState):
        return exp32(state.log_s)

    def log_prices(self, state):
        """Native log prices for the functional engines."""
        return state.log_s

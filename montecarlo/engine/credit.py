"""Portfolio credit derivatives: one-factor Gaussian-copula default MC.

Products the reference has no analog for (framework extension, same style
as the xVA subsystem): kth-to-default basket CDS and synthetic CDO
tranches on an N-name pool, priced by simulating correlated default
indicators under the one-factor Gaussian copula

    X_i = sqrt(rho) * M + sqrt(1 - rho) * eps_i,        M, eps_i ~ N(0,1)
    name i has defaulted by t  <=>  X_i <= C_i(t),
    C_i(t) = Phi^{-1}(1 - exp(-h_i t))   (flat hazard h_i, so the copula
    marginals reproduce each name's CDS survival curve exactly).

Design: the copula needs ONE factor draw + one idiosyncratic
draw per (path, name) — counter-based (`rng.normal.normal_draw`: factor is
draw 0, name i is draw 1+i of the same all-normal stream), so every path
is independently seedable and the sharded twin
(`parallel.sharded.sharded_credit_legs`) is bitwise mesh-shape-invariant.
Per-date losses are ONE (names,) @ (names, paths) matmul over the
indicator matrix (full f32 precision), `lax.map`-ed over the payment grid; nothing is
ever gathered or sorted.

Default times are discretized to the payment grid (the standard
contract approximation): a default in period j pays protection
discounted at the period MIDPOINT, premium accrues on the survivors at
period END plus half-period accrual-on-default — the conventions are
documented on each function and the exact semi-analytic oracle in
`tests/test_credit.py` uses the same discretization, so the tests pin
the MC against EXACT values (Gauss-Hermite over the factor x conditional
binomial), not against a looser approximation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from montecarlo.engine.precision import HIGHEST, mm
from montecarlo.engine.simulate import path_ids_for
from montecarlo.rng.normal import normal_draw, uniform_draw
from montecarlo.stats.welford import moments_from_array, std_error

#: Stream for the copula normals (factor = draw 0, name i = draw 1 + i;
#: one all-normal stream is dependence-safe — DEVNOTES "RNG convention").
CREDIT_STREAM = 0
#: SEPARATE stream for the Student-t mixing uniforms: a raw-bits uniform
#: must never share a cipher call with a Box-Muller normal (DEVNOTES
#: "RNG convention trap" — the Merton bug).
CREDIT_MIX_STREAM = 1


def t_cdf(x, df, dtype):
    """Student-t CDF via the regularized incomplete beta (jax-native)."""
    x = jnp.asarray(x, dtype)
    df = jnp.asarray(df, dtype)
    ib = jax.scipy.special.betainc(0.5 * df, 0.5, df / (df + x * x))
    return jnp.where(x >= 0, 1.0 - 0.5 * ib, 0.5 * ib)


def t_icdf(p, df, dtype):
    """Inverse Student-t CDF by safeguarded Newton on :func:`t_cdf`.

    Used only for the copula's (names, dates) threshold matrix, so cost
    is irrelevant; accuracy is Newton-to-roundoff from a normal-quantile
    start (validated against scipy.stats.t.ppf in tests).  ``p`` must be
    in (0, 1) — callers mask the p = 0 inception column themselves.
    """
    p = jnp.asarray(p, dtype)
    dff = jnp.asarray(df, dtype)
    log_norm = (jax.scipy.special.gammaln(0.5 * (dff + 1.0))
                - jax.scipy.special.gammaln(0.5 * dff)
                - 0.5 * jnp.log(dff * jnp.pi))
    # Start from the normal quantile, widened by the t's heavier scale.
    x = jax.scipy.special.ndtri(p) * jnp.sqrt(dff / jnp.maximum(dff - 2.0,
                                                                0.5))

    def newton(x, _):
        pdf = jnp.exp(log_norm - 0.5 * (dff + 1.0)
                      * jnp.log1p(x * x / dff))
        step = (t_cdf(x, df, dtype) - p) / jnp.maximum(pdf,
                                                       jnp.finfo(dtype).tiny)
        # Safeguard: the normal start is already near; cap the move at
        # one unit of the current scale so the tail iteration cannot
        # overshoot to a flat-pdf region.
        cap = 1.0 + jnp.abs(x)
        return x - jnp.clip(step, -cap, cap), None

    x, _ = jax.lax.scan(newton, x, None, length=40)
    return x


def default_thresholds(hazards, times, dtype, copula="gaussian",
                       df: int = 4):
    """``C_i(t_j) = F^{-1}(1 - exp(-h_i t_j))`` — (names, dates) — with
    ``F`` the copula's univariate marginal (Phi for Gaussian, Student-t
    for ``copula="student-t"``), so each name's CDS survival curve is
    reproduced EXACTLY under either dependence structure.

    ``t = 0`` gives ``F^{-1}(0) = -inf``: nothing has defaulted at
    inception (the comparison ``x <= -inf`` is False), no special-casing
    for the Gaussian; the t branch masks the inception column itself
    (its Newton needs p in (0, 1)).
    """
    h = jnp.asarray(hazards, dtype)[:, None]
    t = jnp.asarray(times, dtype)[None, :]
    p = 1.0 - jnp.exp(-h * t)
    if copula == "gaussian":
        return jax.scipy.special.ndtri(p)
    p_safe = jnp.where(t > 0, p, 0.5)
    c = t_icdf(p_safe, df, dtype)
    return jnp.where(t > 0, c, -jnp.inf)


class CopulaSobolSampler(NamedTuple):
    """Scrambled-Sobol QMC copula draws for the portfolio-credit engines.

    One Sobol point per PATH (not per step — the copula is a one-shot
    latent structure): dimension 0 drives the systematic factor, 1..N the
    idiosyncratic normals (all via the inverse CDF), and the trailing
    ``df/2`` dimensions stay raw scrambled uniforms for the Student-t
    chi2 mixing (inverse-transform QMC is unbiased for any marginal —
    the `samplers.MixedSobolSampler` argument).  Rows are indexed by
    GLOBAL path id, so the sharded twin gathers its blocks from the same
    table and stays bitwise mesh-invariant.  Build one per replicate with
    a different ``seed`` for the honest replicate-spread error bar
    (`credit_rqmc`).
    """

    z: jnp.ndarray   # (n_paths, 1 + n_names) normals: factor, then names
    u: jnp.ndarray   # (n_paths, df//2) chi2-mixing uniforms (0 cols = Gauss)

    @classmethod
    def create(cls, n_names: int, n_paths: int, *, seed: int = 0,
               copula: str = "gaussian", df: int = 4,
               dtype=jnp.float64) -> "CopulaSobolSampler":
        import numpy as np
        from scipy.special import ndtri
        from scipy.stats import qmc

        n_mix = df // 2 if copula == "student-t" else 0
        eng = qmc.Sobol(d=1 + n_names + n_mix, scramble=True, seed=seed)
        m = max(1, int(np.ceil(np.log2(max(n_paths, 2)))))
        pts = eng.random_base2(m=m)[:n_paths]
        pts = np.clip(pts, 2.0**-24, 1.0 - 2.0**-24)
        return cls(jnp.asarray(ndtri(pts[:, :1 + n_names]), dtype),
                   jnp.asarray(pts[:, 1 + n_names:], dtype))


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "seed", "dtype",
                                   "copula", "df"))
def _loss_count_paths(hazards, loss_w, rho, n_paths, n_steps, *, T, seed,
                      dtype, path_offset=0, copula="gaussian",
                      df: int = 4, sampler=None):
    """Pathwise per-date portfolio loss and default count.

    Returns ``(loss, count)`` each of shape ``(n_steps + 1, n_paths)``:
    ``loss[j]`` is ``sum_i loss_w_i * 1{X_i <= C_i(t_j)}`` and ``count[j]``
    the number of defaulted names by ``t_j``.  Memory is O(names * paths)
    for the copula variables — pod path counts go through the sharded
    twin, which runs this per fixed-width block.

    ``copula="student-t"`` divides the Gaussian vector by
    ``sqrt(W / df)`` with ``W ~ chi2(df)`` built EXACTLY as
    ``2 * sum of df/2 Exp(1)`` variates (-log of uniforms on their own
    stream — a raw-bits uniform must never share a cipher call with a
    Box-Muller normal), hence ``df`` must be a positive even integer;
    marginal thresholds switch to the t quantile so the CDS curves stay
    exact.  The shared division induces the TAIL DEPENDENCE the
    Gaussian copula famously lacks.
    """
    n_names = hazards.shape[0]
    ids = path_ids_for(n_paths, path_offset)
    if sampler is None:
        m = normal_draw(seed, CREDIT_STREAM, ids, 0, dtype)      # (P,)
        d = (1 + jnp.arange(n_names, dtype=jnp.uint32))[:, None]
        eps = normal_draw(seed, CREDIT_STREAM, ids[None, :], d, dtype)
    else:
        if sampler.z.shape[1] != 1 + n_names:
            raise ValueError(
                f"CopulaSobolSampler built for {sampler.z.shape[1] - 1} "
                f"names, pool has {n_names} — rebuild with "
                "CopulaSobolSampler.create(n_names, ...)")
        rows = sampler.z[ids.astype(jnp.int32)].astype(dtype)
        m = rows[:, 0]
        eps = rows[:, 1:].T                                      # (N, P)
    rho = jnp.asarray(rho, dtype)
    x = jnp.sqrt(rho) * m[None, :] + jnp.sqrt(1.0 - rho) * eps   # (N, P)
    if copula == "student-t":
        if df <= 0 or df % 2:
            raise ValueError("student-t copula needs a positive EVEN "
                             f"integer df (exact chi2 from Exp sums); "
                             f"got {df}")
        if sampler is None:
            dmix = jnp.arange(df // 2, dtype=jnp.uint32)[:, None]
            u = uniform_draw(seed, CREDIT_MIX_STREAM, ids[None, :], dmix,
                             dtype)
        else:
            if sampler.u.shape[1] != df // 2:
                raise ValueError(
                    f"CopulaSobolSampler carries {sampler.u.shape[1]} "
                    f"mixing dims, student-t df={df} needs {df // 2} — "
                    "rebuild with copula='student-t', df=df")
            u = sampler.u[ids.astype(jnp.int32)].T.astype(dtype)
        w = 2.0 * jnp.sum(-jnp.log(u), axis=0)                   # chi2(df)
        x = x / jnp.sqrt(w / df)[None, :]
    elif copula != "gaussian":
        raise ValueError(f"unknown copula {copula!r}")
    times = jnp.arange(n_steps + 1, dtype=dtype) * (T / n_steps)
    c = default_thresholds(hazards, times, dtype, copula, df)   # (N, T+1)

    def per_date(c_j):
        ind = (x <= c_j[:, None]).astype(dtype)                  # (N, P)
        return (mm(jnp.asarray(loss_w, dtype), ind),
                jnp.sum(ind, axis=0))

    loss, count = jax.lax.map(per_date, c.T)
    return loss, count


def _leg_arrays(n_steps, T, rate, dtype):
    """Payment-grid times, accrual, end- and midpoint discount factors."""
    dt = T / n_steps
    times = jnp.arange(n_steps + 1, dtype=dtype) * dt
    r = jnp.asarray(rate, dtype)
    disc_end = jnp.exp(-r * times[1:])                           # (T,)
    disc_mid = jnp.exp(-r * (times[1:] - 0.5 * dt))              # (T,)
    return times, dt, disc_end, disc_mid


def _spread_record(prot, prem, n_paths, times, el, el_se, dtype):
    """Legs -> par spread with a LINEARIZED std error.

    ``se(s) = std(prot_path - s * prem_path) / (E[prem] * sqrt(n))`` —
    the delta method on the ratio of means, computed from the pathwise
    residual so the prot/prem covariance is included (not the
    independent-legs upper bound).
    """
    st = moments_from_array(jnp.stack([prot, prem]), axis=-1)
    p_mean, q_mean = st.mean[0], st.mean[1]
    spread = p_mean / q_mean
    resid = moments_from_array(prot - spread * prem, axis=-1)
    return {
        "times": times,
        "expected_loss": el,
        "expected_loss_std_err": el_se,
        "protection_leg": p_mean,
        "protection_leg_std_err": std_error(st)[0],
        "premium_leg_per_spread": q_mean,
        "premium_leg_std_err": std_error(st)[1],
        "par_spread": spread,
        "par_spread_std_err": std_error(resid) / q_mean,
        "n_paths": jnp.asarray(n_paths, dtype),
    }


def _tranche_legs(loss, attach, detach, dt, disc_end, disc_mid, dtype):
    """(prot, prem, tranche_loss) per path — the ONE copy of the tranche
    leg algebra, shared by `_cdo_tranche` and `credit_legs_pathwise` (so
    the sharded twin can never drift from the unsharded engine)."""
    a = jnp.asarray(attach, dtype)
    b = jnp.asarray(detach, dtype)
    tl = jnp.clip(loss - a, 0.0, b - a)                  # (T+1, P)
    # Protection: discounted tranche-loss increments at period midpoints.
    prot = jnp.sum(disc_mid[:, None] * (tl[1:] - tl[:-1]), axis=0)
    # Premium per unit spread: accrual on the AVERAGE outstanding tranche
    # notional over each period (the half-period accrual-on-default
    # convention), discounted at period end.
    out = (b - a) - tl
    prem = jnp.sum(disc_end[:, None] * dt
                   * 0.5 * (out[1:] + out[:-1]), axis=0)
    return prot, prem, tl


def _kth_legs(count, k, recovery, dt, disc_end, disc_mid, dtype):
    """(prot, prem, hit) per path — the ONE copy of the kth-to-default
    leg algebra, shared by `_kth_to_default` and
    `credit_legs_pathwise`."""
    hit = (count >= k).astype(dtype)                     # (T+1, P)
    trig = hit[1:] - hit[:-1]                            # k-th default in j
    lgd = 1.0 - jnp.asarray(recovery, dtype)
    prot = lgd * jnp.sum(disc_mid[:, None] * trig, axis=0)
    # Premium while fewer than k names have defaulted, plus half-period
    # accrual in the trigger period (mirrors the protection midpoint).
    prem = jnp.sum(disc_end[:, None] * dt * (1.0 - hit[1:]), axis=0) \
        + jnp.sum(disc_mid[:, None] * (0.5 * dt) * trig, axis=0)
    return prot, prem, hit


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "seed", "dtype",
                                   "copula", "df"))
def _cdo_tranche(hazards, loss_w, rho, attach, detach, n_paths, n_steps, *,
                 T, seed, rate, dtype, copula, df, sampler=None):
    loss, _ = _loss_count_paths(hazards, loss_w, rho, n_paths, n_steps,
                                T=T, seed=seed, dtype=dtype,
                                copula=copula, df=df, sampler=sampler)
    times, dt, disc_end, disc_mid = _leg_arrays(n_steps, T, rate, dtype)
    prot, prem, tl = _tranche_legs(loss, attach, detach, dt, disc_end,
                                   disc_mid, dtype)
    st = moments_from_array(tl, axis=-1)
    return _spread_record(prot, prem, n_paths, times, st.mean,
                          std_error(st), dtype)


def cdo_tranche(hazards, rho: float, *, attach: float, detach: float,
                T: float, n_steps: int, n_paths: int, seed: int,
                rate: float = 0.0, recovery=0.4, weights=None,
                copula: str = "gaussian", df: int = 4, sampler=None,
                dtype=jnp.float64) -> dict:
    """Synthetic CDO tranche [attach, detach) on an N-name pool.

    Pool notional is normalized to 1: name i contributes
    ``w_i * (1 - R_i)`` to the portfolio loss on default (``weights``
    default to 1/N each; ``recovery`` may be scalar or per-name).  The
    tranche loss at t is ``clip(L(t) - attach, 0, detach - attach)``.
    Legs (discretized to the ``n_steps``-period grid, flat ``rate``):

      protection = E[ sum_j D(t_{j-1/2}) (TL_j - TL_{j-1}) ]
      premium(s) = s * E[ sum_j D(t_j) dt * (O_{j-1} + O_j)/2 ],
                   O_j = tranche notional outstanding = (d - a) - TL_j

    ``par_spread = protection / premium(1)`` with a linearized std error
    (delta method on the pathwise residual).  Returns the spread record
    plus the per-date ``expected_loss`` profile of the TRANCHE (with
    std errs).  Exact-oracle tested for homogeneous pools at any rho
    (Gauss-Hermite x conditional binomial — `tests/test_credit.py`).
    """
    hazards = jnp.asarray(hazards, dtype)
    n = hazards.shape[0]
    w = (jnp.full((n,), 1.0 / n, dtype) if weights is None
         else jnp.asarray(weights, dtype))
    loss_w = w * (1.0 - jnp.broadcast_to(jnp.asarray(recovery, dtype),
                                         (n,)))
    if not 0.0 <= attach < detach:
        raise ValueError("need 0 <= attach < detach")
    return _cdo_tranche(hazards, loss_w, rho, attach, detach, n_paths,
                        n_steps, T=T, seed=seed, rate=rate, dtype=dtype,
                        copula=copula, df=df, sampler=sampler)


@partial(jax.jit, static_argnames=("k", "n_paths", "n_steps", "seed",
                                   "dtype", "copula", "df"))
def _kth_to_default(hazards, rho, k, n_paths, n_steps, *, T, seed, rate,
                    recovery, dtype, copula, df, sampler=None):
    n = hazards.shape[0]
    ones = jnp.ones((n,), dtype)
    _, count = _loss_count_paths(hazards, ones, rho, n_paths, n_steps,
                                 T=T, seed=seed, dtype=dtype,
                                 copula=copula, df=df, sampler=sampler)
    times, dt, disc_end, disc_mid = _leg_arrays(n_steps, T, rate, dtype)
    prot, prem, hit = _kth_legs(count, k, recovery, dt, disc_end,
                                disc_mid, dtype)
    st = moments_from_array(hit, axis=-1)
    return _spread_record(prot, prem, n_paths, times, st.mean,
                          std_error(st), dtype)


def kth_to_default_cds(hazards, rho: float, *, k: int, T: float,
                       n_steps: int, n_paths: int, seed: int,
                       rate: float = 0.0, recovery: float = 0.4,
                       copula: str = "gaussian", df: int = 4, sampler=None,
                       dtype=jnp.float64) -> dict:
    """kth-to-default basket CDS on an N-name pool.

    Protection pays ``1 - recovery`` (homogeneous recovery — the contract
    pays on whichever name defaults k-th, so per-name recoveries would
    need identity tracking; documented restriction) at the midpoint of
    the period in which the k-th default lands; premium accrues per
    period on survival of the basket (fewer than k defaults) plus a
    half-period accrual-on-default.  ``expected_loss`` in the returned
    record is the per-date probability that the basket has triggered,
    ``P(count(t) >= k)``.

    Limits pinned by tests: ``rho = 0, k = 1`` reproduces the
    independent first-to-default closed form (basket survival
    ``exp(-sum_i h_i t)``); ``rho = 1`` on a homogeneous pool collapses
    every k to the single-name CDS (all names default together); any
    (rho, k) on a homogeneous pool matches the exact Gauss-Hermite x
    binomial-tail oracle.
    """
    hazards = jnp.asarray(hazards, dtype)
    if not 1 <= k <= hazards.shape[0]:
        raise ValueError(f"k must be in [1, {hazards.shape[0]}]")
    return _kth_to_default(hazards, rho, k, n_paths, n_steps, T=T,
                           seed=seed, rate=rate, recovery=recovery,
                           dtype=dtype, copula=copula, df=df,
                           sampler=sampler)


def credit_legs_pathwise(hazards, loss_w, rho, *, product: str, attach,
                         detach, k, recovery, n_paths, n_steps, T, seed,
                         rate, dtype, path_offset=0,
                         copula: str = "gaussian", df: int = 4,
                         sampler=None):
    """(prot, prem) per path for one contiguous block of global path ids —
    the unit the sharded twin maps over fixed-width blocks (same draws,
    same leg algebra as the unsharded engines above)."""
    loss, count = _loss_count_paths(hazards, loss_w, rho, n_paths,
                                    n_steps, T=T, seed=seed, dtype=dtype,
                                    path_offset=path_offset,
                                    copula=copula, df=df, sampler=sampler)
    times, dt, disc_end, disc_mid = _leg_arrays(n_steps, T, rate, dtype)
    if product == "tranche":
        prot, prem, _ = _tranche_legs(loss, attach, detach, dt, disc_end,
                                      disc_mid, dtype)
    elif product == "kth":
        prot, prem, _ = _kth_legs(count, k, recovery, dt, disc_end,
                                  disc_mid, dtype)
    else:
        raise ValueError(f"unknown credit product {product!r}")
    return prot, prem


# ---------------------------------------------------------------------------
# Exact homogeneous-pool pricer (Gauss-Hermite x conditional binomial)
# ---------------------------------------------------------------------------

def _gh_nodes(n_nodes, dtype):
    """Host-side Gauss-Hermite nodes for E[f(M)], M ~ N(0,1) (trace-time
    f64 constants — the quadrature rule itself never needs a gradient)."""
    import numpy as np

    x, w = np.polynomial.hermite.hermgauss(n_nodes)
    return (jnp.asarray(np.sqrt(2.0) * x, dtype),
            jnp.asarray(w / np.sqrt(np.pi), dtype))


@partial(jax.jit, static_argnames=("n_names", "n_steps", "n_nodes",
                                   "dtype"))
def _tranche_el_exact(hazard, rho, attach, detach, recovery, *, n_names,
                      T, n_steps, n_nodes, dtype):
    """Exact per-date expected tranche loss for a HOMOGENEOUS pool.

    Conditional on the factor M the default count is
    Binomial(N, p_t(M)) with p_t(m) = Phi((C_t - sqrt(rho) m) /
    sqrt(1 - rho)); the factor integrates out by Gauss-Hermite.  Every
    step is smooth in (hazard, rho, recovery), so `jax.grad` delivers
    credit deltas / correlation sensitivities through this pricer — the
    MC engine's indicator payoffs have zero pathwise derivative, which
    is why the greeks live HERE.  The binomial pmf is computed in log
    space (lgamma + k log p + (N-k) log1p(-p)) with the p = 0 / 1
    endpoints handled exactly (mass collapses to k = 0 / N).
    """
    # Canonicalize: without x64 a requested float64 silently becomes
    # float32, and every finfo-based guard below must follow it.
    dtype = jnp.zeros((), dtype).dtype
    times = jnp.arange(n_steps + 1, dtype=dtype) * (T / n_steps)
    h = jnp.asarray(hazard, dtype)
    q = 1.0 - jnp.exp(-h * times)                        # (T+1,)
    # t = 0 has q = 0 and ndtri'(0) = inf; even though the row is masked
    # below, a masked-branch inf would still NaN the hazard gradient
    # (0-cotangent x inf chain) — sanitize the input BEFORE ndtri.
    q_safe = jnp.where(times > 0, q, 0.5)
    c = jax.scipy.special.ndtri(q_safe)
    m, w = _gh_nodes(n_nodes, dtype)
    rho = jnp.asarray(rho, dtype)
    z = (c[:, None] - jnp.sqrt(rho) * m[None, :]) / jnp.sqrt(1.0 - rho)
    p = jnp.where(times[:, None] > 0,
                  jax.scipy.stats.norm.cdf(z), 0.0)      # (T+1, nodes)
    k = jnp.arange(n_names + 1, dtype=dtype)
    log_comb = (jax.scipy.special.gammaln(n_names + 1.0)
                - jax.scipy.special.gammaln(k + 1.0)
                - jax.scipy.special.gammaln(n_names - k + 1.0))
    # dtype-aware clip: a hard 1e-300 underflows to 0.0 in f32 and the
    # k=0 row becomes 0 * log(0) = NaN (bit the CLI, which runs f32).
    info = jnp.finfo(dtype)
    p_ = jnp.clip(p, info.tiny, 1.0 - info.epsneg)[:, :, None]
    log_pmf = (log_comb + k * jnp.log(p_)
               + (n_names - k) * jnp.log1p(-p_))
    pmf = jnp.exp(log_pmf)
    pmf = jnp.where(p[:, :, None] <= 0.0,
                    jnp.where(k == 0, 1.0, 0.0), pmf)
    pmf = jnp.where(p[:, :, None] >= 1.0,
                    jnp.where(k == n_names, 1.0, 0.0), pmf)
    loss = k * (1.0 - jnp.asarray(recovery, dtype)) / n_names
    tl = jnp.clip(loss - jnp.asarray(attach, dtype), 0.0,
                  jnp.asarray(detach, dtype) - jnp.asarray(attach, dtype))
    return jnp.einsum("tnc,c,n->t", pmf, tl, w, precision=HIGHEST)


def tranche_spread_exact(hazard: float, rho: float, *, n_names: int,
                         attach: float, detach: float, T: float,
                         n_steps: int, rate: float = 0.0,
                         recovery: float = 0.4, n_nodes: int = 160,
                         dtype=jnp.float64) -> dict:
    """EXACT par spread of a homogeneous-pool CDO tranche (no MC).

    Same leg discretization as :func:`cdo_tranche` (midpoint protection,
    average-outstanding premium), so the MC engine converges to exactly
    this number (tested).  Differentiable: the record carries
    ``hazard_delta`` (d spread / d hazard — the credit DV01 per unit
    intensity) and ``rho_sens`` by `jax.grad` through the quadrature.
    """
    def spread_of(h, r):
        e_tl = _tranche_el_exact(h, r, attach, detach, recovery,
                                 n_names=n_names, T=T, n_steps=n_steps,
                                 n_nodes=n_nodes, dtype=dtype)
        times = jnp.arange(n_steps + 1, dtype=dtype) * (T / n_steps)
        dt = T / n_steps
        rr = jnp.asarray(rate, dtype)
        disc_end = jnp.exp(-rr * times[1:])
        disc_mid = jnp.exp(-rr * (times[1:] - 0.5 * dt))
        prot = jnp.sum(disc_mid * (e_tl[1:] - e_tl[:-1]))
        out = (detach - attach) - e_tl
        prem = jnp.sum(disc_end * dt * 0.5 * (out[1:] + out[:-1]))
        return prot / prem, (prot, prem, e_tl)

    h0 = jnp.asarray(hazard, dtype)
    r0 = jnp.asarray(rho, dtype)
    (spread, (prot, prem, e_tl)), grads = jax.value_and_grad(
        spread_of, argnums=(0, 1), has_aux=True)(h0, r0)
    return {"par_spread": spread, "protection_leg": prot,
            "premium_leg_per_spread": prem, "expected_loss": e_tl,
            "hazard_delta": grads[0], "rho_sens": grads[1]}


def base_correlation(target_spread: float, *, n_names: int, detach: float,
                     T: float, n_steps: int, hazard: float,
                     rate: float = 0.0, recovery: float = 0.4,
                     n_nodes: int = 160, dtype=jnp.float64):
    """Implied BASE correlation: the rho at which the [0, detach) equity
    tranche's exact par spread equals ``target_spread``.

    Equity-tranche expected loss is strictly decreasing in rho (more
    correlation pushes loss mass past the detachment), so the spread is
    monotone and the root unique — the reason the market quotes BASE
    rather than tranche-implied correlation (mezzanine spreads are not
    monotone in rho).  60 bisection iterations on rho in (0, 1) — the
    bracket shrinks to ~1e-18, below f64 spacing; returns the rho scalar.
    """
    def spread_of(r):
        return tranche_spread_exact(
            hazard, r, n_names=n_names, attach=0.0, detach=detach, T=T,
            n_steps=n_steps, rate=rate, recovery=recovery,
            n_nodes=n_nodes, dtype=dtype)["par_spread"]

    target = jnp.asarray(target_spread, dtype)
    lo_s = spread_of(jnp.asarray(1.0 - 1e-9, dtype))
    hi_s = spread_of(jnp.asarray(1e-12, dtype))
    if not float(lo_s) <= float(target) <= float(hi_s):
        raise ValueError(
            f"target spread {float(target):.6g} outside the attainable "
            f"equity-tranche range [{float(lo_s):.6g}, {float(hi_s):.6g}]")

    def body(_, ab):
        a, b = ab
        mid = 0.5 * (a + b)
        # spread decreasing in rho: too-high spread => rho too low.
        go_up = spread_of(mid) > target
        return (jnp.where(go_up, mid, a), jnp.where(go_up, b, mid))

    a, b = jax.lax.fori_loop(0, 60, body,
                             (jnp.asarray(1e-12, dtype),
                              jnp.asarray(1.0 - 1e-9, dtype)))
    return 0.5 * (a + b)


def credit_rqmc(hazards, rho: float, *, product: str = "tranche",
                n_paths: int, n_replicates: int = 8, qmc_seed: int = 0,
                copula: str = "gaussian", df: int = 4, **kw) -> dict:
    """CDO-tranche / kth-to-default pricing under randomized QMC with
    HONEST error bars — the `price_to_tolerance_rqmc` pattern on the
    credit engines: ``n_paths`` total paths split into ``n_replicates``
    independently scrambled :class:`CopulaSobolSampler` replicates, each
    running the full pricer; leg/spread scalars return the replicate
    mean, and every ``*_std_err`` key is REPLACED by the replicate-spread
    standard error ``std(values, ddof=1)/sqrt(R)`` (the iid bar would
    overstate QMC error by the full convergence gain).  Profile arrays
    (``expected_loss``) return replicate means with spread bars.

    Measured (tests): >= 2x std-err reduction on the tranche par spread
    at equal paths vs plain MC replicates.

    ``kw`` passes through to `cdo_tranche` / `kth_to_default_cds`
    (attach/detach or k, T, n_steps, seed, rate, recovery, ...).
    """
    if n_replicates < 2:
        raise ValueError("n_replicates must be >= 2 (the error bar is "
                         "the spread across replications)")
    if n_paths % n_replicates:
        raise ValueError(f"n_paths={n_paths} not divisible by "
                         f"n_replicates={n_replicates}")
    per = n_paths // n_replicates
    n_names = jnp.asarray(hazards).shape[0]
    pricer = cdo_tranche if product == "tranche" else kth_to_default_cds
    if product not in ("tranche", "kth"):
        raise ValueError(f"unknown credit product {product!r}")
    recs = []
    for r in range(n_replicates):
        smp = CopulaSobolSampler.create(n_names, per, seed=qmc_seed + r,
                                        copula=copula, df=df,
                                        dtype=kw.get("dtype", jnp.float64))
        recs.append(pricer(hazards, rho, n_paths=per, copula=copula,
                           df=df, sampler=smp, **kw))
    out = {}
    r_f = float(n_replicates)
    for k_ in recs[0]:
        if k_.endswith("_std_err"):
            continue
        stack = jnp.stack([jnp.asarray(rec[k_]) for rec in recs])
        out[k_] = jnp.mean(stack, axis=0)
        if k_ not in ("times", "n_paths"):
            out[k_ + "_std_err"] = (jnp.std(stack, axis=0, ddof=1)
                                    / jnp.sqrt(jnp.asarray(
                                        r_f, stack.dtype)))
    out["n_paths"] = jnp.asarray(float(n_paths))
    out["n_replicates"] = n_replicates
    return out


__all__ = ["CopulaSobolSampler", "cdo_tranche", "credit_rqmc",
           "kth_to_default_cds", "default_thresholds",
           "credit_legs_pathwise", "tranche_spread_exact",
           "base_correlation", "CREDIT_STREAM"]

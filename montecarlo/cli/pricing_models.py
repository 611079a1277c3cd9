"""Process / sampler / closed-form-oracle construction for the `price`
subcommand — the model-building half of the CLI pricer (control flow lives
in :mod:`montecarlo.cli.pricing`, dedicated run modes in
:mod:`montecarlo.cli.pricing_modes`)."""

from __future__ import annotations


def build_process(args, dt):
    """The `--process` table: returns the process pytree, or None for the
    own-simulator branches (rbergomi/hybrid, handled by pricing_modes)."""
    from montecarlo.processes import GBM, Heston, LocalVolGBM, Merton

    if args.process == "gbm":
        proc = GBM.create(s0=args.s0, mu=args.rate, sigma=args.sigma, dt=dt)
    elif args.process == "cev":
        # Constant elasticity of variance via the local-vol surface:
        # sigma_LN(S) = sigma * (S/S0)^(beta-1).
        import numpy as _np

        sigma, beta, s0 = args.sigma, args.beta, args.s0
        proc = LocalVolGBM.create(
            s0, args.rate, dt, args.steps,
            lambda t, s: _np.clip(sigma * (s / s0) ** (beta - 1.0),
                                  1e-4, 4.0))
    elif args.process == "merton":
        proc = Merton.create(s0=args.s0, mu=args.rate, sigma=args.sigma,
                             lam=args.jump_intensity,
                             jump_mean=args.jump_mean,
                             jump_std=args.jump_std, dt=dt)
    elif args.process == "kou":
        from montecarlo.processes import Kou

        proc = Kou.create(s0=args.s0, mu=args.rate, sigma=args.sigma,
                          lam=args.jump_intensity, p_up=args.p_up,
                          eta1=args.eta1, eta2=args.eta2, dt=dt)
    elif args.process == "nig":
        from montecarlo.processes import NIG

        proc = NIG.create(s0=args.s0, mu=args.rate, alpha=args.nig_alpha,
                          beta=args.nig_beta, delta=args.nig_delta, dt=dt)
    elif args.process == "vg":
        from montecarlo.processes import VarianceGamma

        proc = VarianceGamma.create(s0=args.s0, mu=args.rate,
                                    sigma=args.sigma, theta=args.vg_theta,
                                    nu=args.vg_nu, dt=dt)
    elif args.process == "sabr":
        import numpy as _np

        from montecarlo.processes import SABR

        # Forward-measure dynamics (driftless F): simulate the T-forward of
        # the spot, f0 = s0*e^{rT}, so discounting by --rate prices the same
        # risk-neutral spot as the gbm/heston branches (a bare f0 = s0 would
        # silently drop the forward growth — app.py's Derivatives Lab note).
        # --sigma is the lognormal ATM alpha, rescaled by F0^(1-beta) to CEV
        # units.
        f0 = args.s0 * float(_np.exp(args.rate * args.maturity))
        proc = SABR.create(f0=f0,
                           alpha=args.sigma * f0 ** (1.0 - args.beta),
                           beta=args.beta, nu=args.nu, rho=args.rho, dt=dt)
    elif args.process == "heston":
        proc = Heston.create(s0=args.s0, v0=args.v0, mu=args.rate,
                             kappa=args.kappa, theta=args.theta, xi=args.xi,
                             rho=args.rho, dt=dt)
    elif args.process == "heston-qe":
        # Same model/CF oracle as `heston`; Andersen's QE-M scheme trades
        # a heavier step (ndtri + martingale-corrected drift) for
        # near-exact variance transitions — the coarse-step choice.
        from montecarlo.processes import HestonQE

        proc = HestonQE.create(s0=args.s0, v0=args.v0, mu=args.rate,
                               kappa=args.kappa, theta=args.theta,
                               xi=args.xi, rho=args.rho, dt=dt)
    elif args.process == "slv":
        # Heston-SLV: leverage particle-calibrated (Gyongy) to a demo
        # skewed IV surface iv(K) = --sigma + --skew * log(K/S0), so the
        # model reprices those vanillas while --v0/--kappa/--theta/--xi/
        # --rho set the smile DYNAMICS (processes/slv.py).
        import numpy as _np

        from montecarlo.processes import LocalVolGBM as _LV
        from montecarlo.processes import calibrate_slv
        from montecarlo.processes.dupire import local_vol_fn_from_ivs

        ks = _np.linspace(0.7, 1.4, 15) * args.s0
        mats = _np.array([0.5, 1.0]) * args.maturity
        ivs = (args.sigma
               + args.skew * _np.log(ks / args.s0))[None, :].repeat(2, 0)
        vol_fn = local_vol_fn_from_ivs(ks, mats, ivs, s0=args.s0,
                                       rate=args.rate)
        lv = _LV.create(args.s0, args.rate, dt, args.steps, vol_fn,
                        x_min=-0.9, x_max=0.9)
        # Exact per-step leverage rows (slv_to_kernel's knot surface is
        # the documented smaller-table approximation).
        proc = calibrate_slv(
            lv, v0=args.v0, kappa=args.kappa, theta=args.theta, xi=args.xi,
            rho=args.rho, n_steps=args.steps,
            n_particles=min(args.paths, 1 << 17), seed=args.seed)
    elif args.process in ("bates", "bates-qe"):
        from montecarlo.processes import Bates, BatesQE

        proc = (Bates if args.process == "bates" else BatesQE).create(
            s0=args.s0, v0=args.v0, mu=args.rate,
            kappa=args.kappa, theta=args.theta,
            xi=args.xi, rho=args.rho,
            lam=args.jump_intensity,
            jump_mean=args.jump_mean,
            jump_std=args.jump_std, dt=dt)
    elif args.process in ("rbergomi", "hybrid"):
        proc = None  # dedicated branches below (own simulators/discounting)
    else:
        raise SystemExit(f"unknown process {args.process!r}")
    return proc


def build_sampler(args, proc):
    """The `--sampler` table (with the jump-process Sobol rejection)."""
    from montecarlo.samplers import (
        AntitheticSampler, PlainSampler, SobolSampler,
    )

    mixed = proc is not None and any(
        k != "normal" for k in getattr(proc, "draw_kinds",
                                       ("normal",) * proc.n_draws))
    if args.sampler in ("sobol-device", "sobol-bridge") and mixed:
        raise SystemExit(
            f"--sampler {args.sampler} substitutes normals for every draw "
            f"in-kernel, but {args.process} consumes non-normal uniforms "
            "(jump counts / subordinator inversions / the QE variance "
            "branch) — use `--sampler sobol` (host mixed-draw QMC) or "
            "plain/antithetic sampling")
    if args.sampler == "plain":
        sampler = PlainSampler()
    elif args.sampler == "antithetic":
        sampler = AntitheticSampler()
    elif args.sampler == "sobol-bridge":
        # Device-native randomized Sobol with Brownian-bridge ordering —
        # O(log T) on-the-fly dimension evaluations per step, no
        # (paths, steps) draw array (pod-scale QMC).
        from montecarlo.rng import SobolBridgeDeviceSampler

        if proc.n_draws != 1:
            raise SystemExit("--sampler sobol-bridge requires a single-draw "
                             "process (gbm)")
        sampler = SobolBridgeDeviceSampler.create(args.steps)
    elif args.sampler == "sobol-device":
        # Device-native randomized Sobol: no (paths, steps) draw array, and
        # on the GPU the draws run *inside* the fused path kernel.
        from montecarlo.rng import SobolDeviceSampler

        sampler = SobolDeviceSampler.create(args.steps, proc.n_draws)
    else:
        # Routes to MixedSobolSampler for processes with uniform slots
        # (jump counts, subordinators, QE variance) — inverse-transform
        # QMC is valid for any marginal, so the jump/Levy/QE families get
        # QMC too, not just the all-normal diffusions.
        sampler = SobolSampler.for_process(proc, args.paths, args.steps,
                                           seed=args.seed)
    return sampler


def sobol_replicate_factory(args, proc, n_per: int):
    """Per-replicate sampler factory for RQMC — a FRESH scramble per
    replicate (a digital shift alone understates the spread; see
    `rqmc_estimate`).  Maps the CLI's three ``--sampler sobol*`` variants."""
    if args.sampler == "sobol-bridge":
        # Array leaves, so replicates stack in one program.
        from montecarlo.rng import SobolBridgeDeviceSampler

        return (lambda r: SobolBridgeDeviceSampler.create(
            args.steps, scramble_seed=args.seed + r))
    if args.sampler == "sobol":
        # Host Owen-scrambled sampler, re-scrambled per replicate.
        from montecarlo.samplers import SobolSampler

        return (lambda r: SobolSampler.for_process(
            proc, n_per, args.steps, seed=args.seed + r))
    from montecarlo.rng import SobolDeviceSampler

    return (lambda r: SobolDeviceSampler.create(
        args.steps, proc.n_draws, scramble_seed=args.seed + r))



def append_oracles(out, args, disc) -> None:
    """Closed-form / characteristic-function companions printed alongside
    the MC estimate (gbm Black-Scholes, digital closed form, Kou/NIG/VG/
    Bates CF prices) — mutates ``out`` in place."""
    from montecarlo.engine import black_scholes_call

    if args.process == "gbm" and args.payoff == "call" and not args.american:
        out["black_scholes"] = float(black_scholes_call(
            args.s0, args.strike, args.rate, args.sigma, args.maturity))
    if (args.process == "gbm" and args.payoff == "digital"
            and not args.american):
        import numpy as _np
        from scipy.stats import norm as _norm

        d2 = ((_np.log(args.s0 / args.strike)
               + (args.rate - 0.5 * args.sigma**2) * args.maturity)
              / (args.sigma * _np.sqrt(args.maturity)))
        out["black_scholes"] = float(disc * _norm.cdf(d2))
    if args.process == "kou" and args.payoff == "call" and not args.american:
        import jax
        import math as _math

        from montecarlo.engine.cf_pricing import cf_call_price, kou_log_cf

        with jax.default_device(jax.devices("cpu")[0]):
            cf = float(cf_call_price(
                kou_log_cf(args.s0, args.rate, args.sigma,
                           args.jump_intensity, args.p_up, args.eta1,
                           args.eta2, args.maturity),
                args.s0, args.strike, args.maturity, args.rate))
        if _math.isfinite(cf):
            out["cf_price"] = cf
    if args.process == "nig" and args.payoff == "call" and not args.american:
        import jax
        import math as _math

        from montecarlo.engine.cf_pricing import cf_call_price, nig_log_cf

        with jax.default_device(jax.devices("cpu")[0]):
            cf = float(cf_call_price(
                nig_log_cf(args.s0, args.rate, args.nig_alpha,
                           args.nig_beta, args.nig_delta, args.maturity),
                args.s0, args.strike, args.maturity, args.rate))
        if _math.isfinite(cf):
            out["cf_price"] = cf
    if args.process == "vg" and args.payoff == "call" and not args.american:
        import jax
        import math as _math

        from montecarlo.engine.cf_pricing import cf_call_price, vg_log_cf

        with jax.default_device(jax.devices("cpu")[0]):
            cf = float(cf_call_price(
                vg_log_cf(args.s0, args.rate, args.sigma, args.vg_theta,
                          args.vg_nu, args.maturity),
                args.s0, args.strike, args.maturity, args.rate))
        if _math.isfinite(cf):
            out["cf_price"] = cf
    if (args.process in ("bates", "bates-qe") and args.payoff == "call"
            and not args.american):
        import jax
        import math as _math

        from montecarlo.engine.cf_pricing import cf_call_price
        from montecarlo.processes import bates_log_cf

        # The complex trap-form CF can NaN in complex64 on an
        # accelerator; this scalar oracle runs on the CPU backend instead.
        with jax.default_device(jax.devices("cpu")[0]):
            cf = float(cf_call_price(
                bates_log_cf(args.s0, args.rate, v0=args.v0,
                             kappa=args.kappa, theta=args.theta,
                             xi=args.xi, rho=args.rho,
                             lam=args.jump_intensity,
                             jump_mean=args.jump_mean,
                             jump_std=args.jump_std, T=args.maturity),
                args.s0, args.strike, args.maturity, args.rate))
        if _math.isfinite(cf):
            out["cf_price"] = cf

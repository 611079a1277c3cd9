"""Path-simulation engine, payoffs, and MC estimators."""

from montecarlo.engine.simulate import path_ids_for, replay_paths, simulate  # noqa: F401
from montecarlo.engine.dispatch import terminal_prices  # noqa: F401
from montecarlo.engine.payoffs import (  # noqa: F401
    basket_call,
    black_scholes_call,
    black_scholes_put,
    black_scholes_quanto_call,
    discount_factor,
    european_call,
    european_put,
    max_call,
    quanto_drift,
)
from montecarlo.engine.pricing import (  # noqa: F401
    mc_estimate,
    price_to_tolerance,
    price_to_tolerance_rqmc,
    rqmc_estimate,
)
from montecarlo.engine.path_sketch import (  # noqa: F401
    path_histograms,
    percentiles_from_histograms,
    sharded_path_percentiles,
)
from montecarlo.engine.greeks import (  # noqa: F401
    black_scholes_delta,
    black_scholes_vega,
    lr_greeks_gbm,
    price_and_greeks,
    smoothed_digital,
)
from montecarlo.engine.functionals import (  # noqa: F401
    ARITH_MEAN,
    GEO_MEAN,
    RUNNING_MAX,
    RUNNING_MIN,
    PathFunctional,
    asian_call,
    down_and_out_call,
    lookback_call_floating,
    autocallable,
    worst_of_autocallable,
    barrier_survival_up,
    cliquet_sum,
    realized_variance,
    simulate_functionals,
    trapezoid_integral,
    up_and_out_call,
    variance_swap_strike_mc,
)
from montecarlo.engine.exposure import (  # noqa: F401
    exposure_profile,
    netting_set_profile_rqmc,
    swap_value_fn,
    xva_trade_allocations,
)
from montecarlo.engine.credit import (  # noqa: F401
    CopulaSobolSampler,
    cdo_tranche,
    credit_rqmc,
    kth_to_default_cds,
)
from montecarlo.engine.cf_pricing import (  # noqa: F401
    cf_call_price,
    kou_log_cf,
    merton_log_cf,
    nig_log_cf,
    vg_log_cf,
)
from montecarlo.engine.levy_calibration import (  # noqa: F401
    calibrate_levy_to_ivs,
)
from montecarlo.engine.bermudan import (  # noqa: F401
    bermudan_swaption_lsm,
    vasicek_swaption_jamshidian,
)
from montecarlo.engine.rates import (  # noqa: F401
    bond_option_mc,
    cir_zcb,
    vasicek_bond_option,
    vasicek_zcb,
    zcb_price_mc,
)
from montecarlo.engine.implied_vol import implied_vol_call  # noqa: F401
from montecarlo.engine.surface import (  # noqa: F401
    mc_implied_vol_surface,
    price_snapshot,
)
from montecarlo.engine.american import (  # noqa: F401
    american_price_and_greeks,
    andersen_broadie_bound_multi,
    andersen_broadie_bound_sv,
    binomial_american_put,
    lsm_exercise_policy,
    lsm_policy_multi,
    lsm_policy_sv,
    lsm_price,
    lsm_price_multi,
    lsm_price_path_dependent,
    lsm_price_sv,
)
from montecarlo.engine.control_variate import cv_estimate  # noqa: F401
from montecarlo.engine.heston_analytic import (  # noqa: F401
    HestonParams,
    calibrate_heston,
    calibrate_heston_to_ivs,
    heston_call_cf,
)
from montecarlo.engine.mlmc import (  # noqa: F401
    MLMCLevel,
    mlmc_estimate,
    mlmc_level_moments,
)
from montecarlo.engine.importance import (  # noqa: F401
    importance_sampled_estimate,
    shift_to_strike,
    stratified_terminal_estimate,
)

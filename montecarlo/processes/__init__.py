"""Stochastic processes: GBM, bootstrap-GARCH(1,1), multi-asset GBM, Heston."""

from montecarlo.processes.gbm import GBM, GBMState  # noqa: F401
from montecarlo.processes.garch import (  # noqa: F401
    DEFAULT_ALPHA,
    DEFAULT_BETA,
    DEFAULT_OMEGA,
    GARCHBootstrap,
    GARCHState,
    MIN_HISTORY,
)
from montecarlo.processes.multi_gbm import MultiGBM, MultiGBMState  # noqa: F401
from montecarlo.processes.heston import Heston, HestonState  # noqa: F401
from montecarlo.processes.heston_qe import HestonQE, HestonQEState  # noqa: F401
from montecarlo.processes.basket import BasketGBM  # noqa: F401
from montecarlo.processes.garch_fit import GARCHParams, fit_garch  # noqa: F401
from montecarlo.processes.bates import Bates, BatesState, bates_log_cf  # noqa: F401
from montecarlo.processes.bates_qe import BatesQE, BatesQEState  # noqa: F401
from montecarlo.processes.merton import Merton, MertonState, merton_call_series  # noqa: F401
from montecarlo.processes.ccc_garch import CCCGarch  # noqa: F401
from montecarlo.processes.dcc_garch import DCCGarch  # noqa: F401
from montecarlo.processes.local_vol import LocalVolGBM  # noqa: F401
from montecarlo.processes.slv import (  # noqa: F401
    SLV,
    SLVKnots,
    calibrate_slv,
    slv_to_kernel,
)
from montecarlo.processes.euler_gbm import EulerGBM, EulerGBMState  # noqa: F401
from montecarlo.processes.hybrid import (  # noqa: F401
    EquityVasicekHybrid,
    hybrid_call_closed_form,
    hybrid_price_mc,
)
from montecarlo.processes.heston_exposure import (  # noqa: F401
    HestonExposure,
    heston_forward_value_fn,
    heston_varswap_expected_total,
    heston_varswap_value_fn,
)
from montecarlo.processes.g2pp import (  # noqa: F401
    G2PP,
    g2pp_swap_value_fn,
    g2pp_swaption,
    g2pp_zcb,
)
from montecarlo.processes.lmm import (  # noqa: F401
    LMM,
    lmm_caplet_mc,
    lmm_par_strike,
    lmm_swap_value_fn,
    lmm_swaption_mc,
    lmm_swaption_rebonato,
)
from montecarlo.processes.shortrate import CIR, HullWhite, RateState, Vasicek  # noqa: F401
from montecarlo.processes.kou import Kou, KouState  # noqa: F401
from montecarlo.processes.nig import NIG, NIGState  # noqa: F401
from montecarlo.processes.vg import VarianceGamma, VGState  # noqa: F401
from montecarlo.processes.term_basket import TermBasketGBM  # noqa: F401
from montecarlo.processes.dupire import (  # noqa: F401
    dupire_local_vol_grid,
    local_vol_fn_from_ivs,
)
from montecarlo.processes.rough_bergomi import (  # noqa: F401
    RoughBergomi,
    rbergomi_simulate,
)
from montecarlo.processes.sabr import (  # noqa: F401
    SABR,
    SABRState,
    calibrate_sabr,
    sabr_hagan_iv,
)
from montecarlo.processes.term_gbm import TermStructureGBM  # noqa: F401

"""Mesh construction and sharded simulation."""

from montecarlo.parallel.mesh import (  # noqa: F401
    ASSETS_AXIS,
    PATHS_AXIS,
    SLICES_AXIS,
    make_mesh,
)
from montecarlo.parallel.sharded import (  # noqa: F401
    DEFAULT_BLOCK,
    block_moments,
    sharded_andersen_broadie_bound,
    sharded_basket_estimate,
    sharded_credit_legs,
    sharded_functional_estimate,
    sharded_lsm_price,
    sharded_mc_estimate,
    sharded_netting_profile,
    sharded_portfolio_xva,
    sharded_price_and_greeks,
    sharded_rbergomi_estimate,
    sharded_terminal,
    sharded_xva_greeks,
    sharded_terminal_sketch,
)

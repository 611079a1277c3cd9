"""Counter-based RNG: Threefry-2x32 core, normal/uniform transforms, Sobol QMC."""

from montecarlo.rng.threefry import (  # noqa: F401
    key_from_seed,
    random_bits,
    threefry2x32,
)
from montecarlo.rng.normal import (  # noqa: F401
    boxmuller_pair,
    categorical_draw,
    normal_draw,
    normal_matrix,
    normal_pair,
    uniform_draw,
    uniform_from_bits,
)
from montecarlo.rng.sobol import (  # noqa: F401
    SobolBridgeDeviceSampler,
    SobolDeviceSampler,
    brownian_bridge_matrix,
    direction_numbers,
    sobol_bits,
)

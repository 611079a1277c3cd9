"""Hand-written kernels: the generic fused path kernel (Pallas through
Triton), which the engine dispatch runs on the GPU."""

from montecarlo.ops.fused_engine import (  # noqa: F401
    fused_block_moments_pallas,
    fused_functionals_pallas,
    fused_terminal_pallas,
)

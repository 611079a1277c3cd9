"""Full-f32 contractions.

On the GPU an f32 matrix product may run in TF32, which keeps about three
decimal digits, unless the call asks for more.  Every contraction whose
result feeds a regression, a factorisation or a loss sum asks: LSM Gram
matrices and normal equations, continuation values, basket correlation,
credit loss sums.
"""

from functools import partial

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

#: ``jnp.matmul`` at full f32 precision.
mm = partial(jnp.matmul, precision=HIGHEST)

"""Control variates — the third variance-reduction technique.

For a payoff Y and a control X with known expectation E[X] (e.g. the
terminal price under the risk-neutral drift: E[S_T] = S0 e^{rT}), the
controlled estimator

    Y_cv = Y - beta (X - E[X]),   beta* = Cov(Y, X) / Var(X)

is unbiased with variance reduced by the squared correlation.  beta is
estimated from the same sample (the O(1/n) bias this introduces is
negligible at MC scale and vanishes if beta is estimated on a pilot).
"""

from __future__ import annotations

import jax.numpy as jnp

from montecarlo.stats.welford import moments_from_array, std_error


def cv_estimate(payoffs, control, control_mean, discount=1.0) -> dict:
    """Control-variate estimator with sample-optimal beta.

    Returns ``{"price", "std_err", "n_paths", "beta", "variance_ratio"}``
    where ``variance_ratio`` is Var(controlled)/Var(plain) — below 1 when
    the control helps.
    """
    y = jnp.asarray(payoffs)
    x = jnp.asarray(control, y.dtype)
    d = jnp.asarray(discount, y.dtype)
    mu = jnp.asarray(control_mean, y.dtype)

    x_c = x - jnp.mean(x)
    y_c = y - jnp.mean(y)
    var_x = jnp.mean(jnp.square(x_c))
    beta = jnp.sum(x_c * y_c) / jnp.maximum(var_x * x.shape[0], 1e-30)

    adjusted = y - beta * (x - mu)
    st = moments_from_array(adjusted, axis=0)
    plain = moments_from_array(y, axis=0)
    return {
        "price": d * st.mean,
        "std_err": d * std_error(st),
        "n_paths": st.count,
        "beta": beta,
        "variance_ratio": st.m2 / jnp.maximum(plain.m2, 1e-30),
    }

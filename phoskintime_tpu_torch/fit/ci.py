"""Wald confidence intervals for parameter estimates.

Counterpart of ``phoskintime_tpu/fit/ci.py`` (numpy and ``scipy.stats``,
copied).

Spec: reference ``paramest/identifiability/ci.py:10-81`` — linearized
(Wald) intervals from the LM covariance, MSE-rescaled unless the sigmas are
true measurement uncertainties, t-statistics, two-tailed p-values, lower CI
clipped at zero.

Two reference-faithful quirks, reproduced deliberately (flagged in
review; kept because the reference's statistical reporting is the spec):

* the residuals are divided by ``target.size`` BEFORE squaring, so the
  "MSE" carries an extra 1/n^2 factor and the rescaled SEs are ~n times
  narrower than the textbook Wald formula (reference ci.py:37-43);
* ``use_custom_weights`` gates the rescale exactly as the reference's
  global USE_CUSTOM_WEIGHTS does: True skips the MSE rescale (treats the
  fit sigmas as absolute), False applies it — regardless of whether the
  sigmas actually came from measured uncertainties.

Deviation from the reference: for the log-space-fitted random model the
caller transforms the covariance to physical space by the delta method
before calling here (see ``fit.normest``); the reference passes the
log-space covariance with exp() parameters, mixing spaces
(reference normest.py:478-484).
"""

from __future__ import annotations

import numpy as np
from scipy import stats


def confidence_intervals(popt: np.ndarray, pcov: np.ndarray | None,
                         target: np.ndarray, model: np.ndarray,
                         alpha_val: float = 0.05,
                         use_custom_weights: bool = False) -> dict | None:
    if pcov is None:
        return None
    beta_hat = np.asarray(popt, float)
    target = np.asarray(target, float)
    model = np.asarray(model, float)

    df_lin = max(target.size - beta_hat.size, 1)
    residuals = (target - model) / target.size
    rss = float(np.sum(residuals ** 2))
    mse = rss / df_lin

    if use_custom_weights:
        se_lin = np.sqrt(np.diag(pcov))
    else:
        se_lin = np.sqrt(np.diag(np.asarray(pcov) * mse))
    se_lin = np.where(se_lin > 0, se_lin, np.finfo(float).tiny)

    t_stat = beta_hat / se_lin
    pval = stats.t.sf(np.abs(t_stat), df_lin) * 2
    qt_lin = stats.t.ppf(1 - alpha_val / 2, df_lin)
    lwr_ci = np.maximum(beta_hat - qt_lin * se_lin, 0)
    upr_ci = beta_hat + qt_lin * se_lin

    return {
        "beta_hat": beta_hat,
        "se_lin": se_lin,
        "df_lin": df_lin,
        "t_stat": t_stat,
        "pval": pval,
        "qt_lin": qt_lin,
        "lwr_ci": lwr_ci,
        "upr_ci": upr_ci,
    }

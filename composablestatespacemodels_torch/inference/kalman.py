"""Exact Kalman filter for linear-Gaussian composed models: the oracle.

PyTorch port of ``composablestatespacemodels_tpu/inference/kalman.py``.
Every SDE family has an exact diagonal Gaussian transition and the
Gaussian family observes ``y = F(t) . x + eps``, so the linear and seasonal
models admit an exact filter; the particle filter's log-likelihood is
held against it.  Runs on the device of the data, in float32, with the
mask applied by ``torch.where`` (no host synchronisation per step).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.model import Model
from ..models.observation import Gaussian
from ..models.params import params_to
from ..models.tree import Tree
from ..utils.data import TimeSeries

_HALF_LOG_2PI = 0.9189385332046727


@dataclasses.dataclass(frozen=True)
class KalmanResult:
    ll: torch.Tensor            # scalar log marginal likelihood
    means: torch.Tensor         # [T, d] filtered means (post-update)
    covs: torch.Tensor          # [T, d, d] filtered covariances
    pred_obs: torch.Tensor      # [T] predictive observation means
    pred_obs_var: torch.Tensor  # [T] predictive observation variances


def kalman_filter(model: Model, params: Tree, data: TimeSeries,
                  t0=None) -> KalmanResult:
    """Exact filtering for a linear-Gaussian (linear/seasonal) model."""
    model.validate_params(params)
    if not isinstance(model.obs, Gaussian):
        raise TypeError(
            "Kalman filtering requires a Gaussian observation model "
            f"(got {type(model.obs).__name__})")
    device = data.ts.device
    params = params_to(params, device)
    sde = model.sde
    sp = model.sde_params(params)
    v = model.obs_scale(params)
    r = v * v

    m, c0 = sde.initial_moments(sp)
    P = torch.diag(c0)
    ts = data.ts.to(torch.float32)
    t_prev = ts[0] if t0 is None else torch.as_tensor(
        t0, dtype=torch.float32, device=device)
    dts = ts - torch.cat([t_prev.reshape(1), ts[:-1]])
    a_all, b_all, q_all = sde.transition_coeffs(sp, dts)        # [T, d]
    h_all = model.design_vector(ts)                              # [T, d]

    ll = torch.zeros((), dtype=torch.float32, device=device)
    means, covs, preds, pred_vars = [], [], [], []
    for i in range(ts.shape[0]):
        a, b, q, h = a_all[i], b_all[i], q_all[i], h_all[i]
        mask = data.mask[i]
        m_pred = a * m + b
        P_pred = a[:, None] * P * a[None, :] + torch.diag(q)

        y_hat = h @ m_pred
        ph = P_pred @ h
        s = h @ ph + r

        k = ph / s
        innov = data.ys[i] - y_hat
        m_upd = m_pred + k * innov
        P_upd = P_pred - torch.outer(k, ph)
        ll_inc = -_HALF_LOG_2PI - 0.5 * torch.log(s) - 0.5 * innov * innov / s

        m = torch.where(mask, m_upd, m_pred)
        P = torch.where(mask, P_upd, P_pred)
        ll = ll + torch.where(mask, ll_inc, 0.0)
        means.append(m)
        covs.append(P)
        preds.append(y_hat)
        pred_vars.append(s)
    return KalmanResult(ll, torch.stack(means), torch.stack(covs),
                        torch.stack(preds), torch.stack(pred_vars))

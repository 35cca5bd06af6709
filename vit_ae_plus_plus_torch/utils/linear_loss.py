"""The binary logistic loss of a linear model, as scikit-learn 1.9.0's
lbfgs and newton-cg solvers evaluate it.

`HalfBinomialLoss` is sklearn/_loss/loss.py's for one output: its
per-sample loss, gradient and Hessian are the closed forms of
sklearn/_loss/_loss.pyx.tp with libm's exp, log and log1p, computed in
the port's native library (native/sag/loss.h, built by utils/sag.py),
since numpy's own exp and log1p may differ from libm's in the last bit.
`LinearModelLoss` is sklearn/linear_model/_linear_loss.py's for that loss
and dense numpy input: the raw prediction X @ w + b in X's dtype, the sums,
the X.T @ g products and the l2 term as the same numpy calls in the same
order, so that a fit sees scikit-learn's numbers bit for bit.
"""

from __future__ import annotations

import numpy as np

from vit_ae_plus_plus_torch.utils import sag


def _ptr(a):
    return None if a is None else a.ctypes.data


def _checked(y_true, raw_prediction, sample_weight):
    """The native loops read raw pointers: one length, one dtype (float32 or
    float64), C order."""
    for a in (y_true, raw_prediction) if sample_weight is None else (y_true, raw_prediction, sample_weight):
        if a.dtype != raw_prediction.dtype or a.shape != (raw_prediction.shape[0],) or not a.flags.c_contiguous:
            raise ValueError(f"HalfBinomialLoss: expected C-ordered 1-d arrays of one length and dtype, got "
                             f"{a.dtype} {a.shape} against {raw_prediction.dtype} {raw_prediction.shape}")


class HalfBinomialLoss:
    """sklearn's `HalfBinomialLoss()`: y_true in {0, 1}, the logit link.
    y_true, raw_prediction and sample_weight share one dtype, float32 or
    float64; the outputs take raw_prediction's."""

    def loss(self, y_true, raw_prediction, sample_weight=None):
        _checked(y_true, raw_prediction, sample_weight)
        loss_out = np.empty_like(y_true)
        sag.native("vitae_half_binomial_loss", raw_prediction.dtype)(
            y_true.shape[0], _ptr(y_true), _ptr(raw_prediction), _ptr(sample_weight), _ptr(loss_out))
        return loss_out

    def loss_gradient(self, y_true, raw_prediction, sample_weight=None):
        _checked(y_true, raw_prediction, sample_weight)
        loss_out, gradient_out = np.empty_like(y_true), np.empty_like(raw_prediction)
        sag.native("vitae_half_binomial_loss_gradient", raw_prediction.dtype)(
            y_true.shape[0], _ptr(y_true), _ptr(raw_prediction), _ptr(sample_weight), _ptr(loss_out),
            _ptr(gradient_out))
        return loss_out, gradient_out

    def gradient(self, y_true, raw_prediction, sample_weight=None):
        _checked(y_true, raw_prediction, sample_weight)
        gradient_out = np.empty_like(raw_prediction)
        sag.native("vitae_half_binomial_gradient", raw_prediction.dtype)(
            y_true.shape[0], _ptr(y_true), _ptr(raw_prediction), _ptr(sample_weight), _ptr(gradient_out))
        return gradient_out

    def gradient_hessian(self, y_true, raw_prediction, sample_weight=None):
        _checked(y_true, raw_prediction, sample_weight)
        gradient_out, hessian_out = np.empty_like(raw_prediction), np.empty_like(raw_prediction)
        sag.native("vitae_half_binomial_gradient_hessian", raw_prediction.dtype)(
            y_true.shape[0], _ptr(y_true), _ptr(raw_prediction), _ptr(sample_weight), _ptr(gradient_out),
            _ptr(hessian_out))
        return gradient_out, hessian_out


class LinearModelLoss:
    """sklearn's `LinearModelLoss(HalfBinomialLoss(), fit_intercept=True)`
    for dense X and a coefficient vector w of n_features + 1 (the intercept
    last):

        loss = 1 / s_sum * sum_i s_i loss(y_i, X_i @ w + b) + 1/2 * l2 * ||w||^2

    with s_i the sample weights and s_sum their sum. The methods take
    (coef, X, y, sample_weight, l2_reg_strength), as scipy's optimisers and
    `_newton_cg` pass `args`."""

    def __init__(self):
        self.base_loss = HalfBinomialLoss()

    def weight_intercept(self, coef):
        return coef[:-1], coef[-1]

    def weight_intercept_raw(self, coef, X):
        weights, intercept = self.weight_intercept(coef)
        weights_x = np.asarray(weights, dtype=X.dtype)
        intercept_x = np.asarray(intercept, dtype=X.dtype)
        return weights, intercept, X @ weights_x + intercept_x

    def l2_penalty(self, weights, l2_reg_strength):
        norm2_w = weights @ weights
        return float(0.5 * l2_reg_strength * norm2_w)

    def loss(self, coef, X, y, sample_weight, l2_reg_strength=0.0):
        weights, intercept, raw_prediction = self.weight_intercept_raw(coef, X)
        loss = self.base_loss.loss(y, raw_prediction, sample_weight)
        sw_sum = np.sum(sample_weight)
        loss = float(np.sum(loss) / sw_sum)
        if l2_reg_strength > 0:
            loss += self.l2_penalty(weights, l2_reg_strength)
        return loss

    def loss_gradient(self, coef, X, y, sample_weight, l2_reg_strength=0.0):
        n_features = X.shape[1]
        weights, intercept, raw_prediction = self.weight_intercept_raw(coef, X)
        loss, grad_pointwise = self.base_loss.loss_gradient(y, raw_prediction, sample_weight)
        sw_sum = np.sum(sample_weight)
        loss = float(np.sum(loss) / sw_sum)
        loss += self.l2_penalty(weights, l2_reg_strength)
        grad_pointwise /= sw_sum
        grad = np.empty_like(coef, dtype=weights.dtype)
        X_grad = X.T @ grad_pointwise
        grad[:n_features] = X_grad + l2_reg_strength * weights
        grad[-1] = np.sum(grad_pointwise)
        return loss, grad

    def gradient(self, coef, X, y, sample_weight, l2_reg_strength=0.0):
        n_features = X.shape[1]
        weights, intercept, raw_prediction = self.weight_intercept_raw(coef, X)
        grad_pointwise = self.base_loss.gradient(y, raw_prediction, sample_weight)
        sw_sum = np.sum(sample_weight)
        grad_pointwise /= sw_sum
        grad = np.empty_like(coef, dtype=weights.dtype)
        grad[:n_features] = X.T @ grad_pointwise + l2_reg_strength * weights
        grad[-1] = grad_pointwise.sum()
        return grad

    def gradient_hessian_product(self, coef, X, y, sample_weight, l2_reg_strength=0.0):
        """-> (gradient, hessp), hessp(s) the Hessian's product with s."""
        n_features = X.shape[1]
        weights, intercept, raw_prediction = self.weight_intercept_raw(coef, X)
        sw_sum = np.sum(sample_weight)
        grad_pointwise, hess_pointwise = self.base_loss.gradient_hessian(y, raw_prediction, sample_weight)
        grad_pointwise /= sw_sum
        hess_pointwise /= sw_sum
        grad = np.empty_like(coef, dtype=weights.dtype)
        grad[:n_features] = X.T @ grad_pointwise + l2_reg_strength * weights
        grad[-1] = grad_pointwise.sum()
        hessian_sum = hess_pointwise.sum()
        hX = hess_pointwise[:, np.newaxis] * X
        hX_sum = np.squeeze(np.asarray(hX.sum(axis=0)))
        hX_sum = np.atleast_1d(hX_sum)

        def hessp(s):
            ret = np.empty_like(s)
            ret[:n_features] = np.linalg.multi_dot([X.T, hX, s[:n_features]])
            ret[:n_features] += l2_reg_strength * s[:n_features]
            ret[:n_features] += s[-1] * hX_sum
            ret[-1] = hX_sum @ s[:n_features] + hessian_sum * s[-1]
            return ret

        return grad, hessp

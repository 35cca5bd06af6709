/*
 * The half binomial loss of scikit-learn 1.9.0 (sklearn/_loss/_loss.pyx.tp):
 * the closed forms `log1pexp`, `closs_half_binomial`,
 * `cgradient_half_binomial`, `closs_grad_half_binomial` and
 * `cgrad_hess_half_binomial`, in double with libm's exp, log and log1p as
 * the Cython module computes them, and the per-sample loops of
 * `CyHalfBinomialLoss` (`loss`, `loss_gradient`, `gradient`,
 * `gradient_hessian`) for float and double arrays: each value is computed in
 * double, multiplied by the sample weight (promoted to double) when there is
 * one, and rounded once to the output's type.
 */

#ifndef VITAE_LOSS_H
#define VITAE_LOSS_H

#include <math.h>

namespace vitae_loss {

struct double_pair {
    double val1;
    double val2;
};

/* log(1 + exp(x)), stable for double (the cutoffs of _loss.pyx.tp) */
static inline double log1pexp(double x)
{
    if (x <= -37)
        return exp(x);
    else if (x <= -2)
        return log1p(exp(x));
    else if (x <= 18)
        return log(1. + exp(x));
    else if (x <= 33.3)
        return x + exp(-x);
    else
        return x;
}

static inline double closs_half_binomial(double y_true, double raw_prediction)
{
    return log1pexp(raw_prediction) - y_true * raw_prediction;
}

static inline double cgradient_half_binomial(double y_true, double raw_prediction)
{
    double exp_tmp;
    if (raw_prediction > -37) {
        exp_tmp = exp(-raw_prediction);
        return ((1 - y_true) - y_true * exp_tmp) / (1 + exp_tmp);
    } else {
        return exp(raw_prediction) - y_true;
    }
}

static inline double_pair closs_grad_half_binomial(double y_true, double raw_prediction)
{
    double_pair lg;
    if (raw_prediction <= -37) {
        lg.val2 = exp(raw_prediction);
        lg.val1 = lg.val2 - y_true * raw_prediction;
        lg.val2 -= y_true;
    } else if (raw_prediction <= -2) {
        lg.val2 = exp(raw_prediction);
        lg.val1 = log1p(lg.val2) - y_true * raw_prediction;
        lg.val2 = ((1 - y_true) * lg.val2 - y_true) / (1 + lg.val2);
    } else if (raw_prediction <= 18) {
        lg.val2 = exp(-raw_prediction);
        lg.val1 = log1p(lg.val2) + (1 - y_true) * raw_prediction;
        lg.val2 = ((1 - y_true) - y_true * lg.val2) / (1 + lg.val2);
    } else {
        lg.val2 = exp(-raw_prediction);
        lg.val1 = lg.val2 + (1 - y_true) * raw_prediction;
        lg.val2 = ((1 - y_true) - y_true * lg.val2) / (1 + lg.val2);
    }
    return lg;
}

static inline double_pair cgrad_hess_half_binomial(double y_true, double raw_prediction)
{
    double_pair gh;
    if (raw_prediction > -37) {
        gh.val2 = exp(-raw_prediction);
        gh.val1 = ((1 - y_true) - y_true * gh.val2) / (1 + gh.val2);
        gh.val2 = gh.val2 / pow(1 + gh.val2, 2.0);
    } else {
        gh.val2 = exp(raw_prediction);
        gh.val1 = gh.val2 - y_true;
    }
    return gh;
}

/* CyHalfBinomialLoss's loops; sample_weight may be NULL */
template <typename T>
static void loss(int n, const T *y_true, const T *raw_prediction, const T *sample_weight, T *loss_out)
{
    if (sample_weight == NULL)
        for (int i = 0; i < n; i++)
            loss_out[i] = closs_half_binomial(y_true[i], raw_prediction[i]);
    else
        for (int i = 0; i < n; i++)
            loss_out[i] = sample_weight[i] * closs_half_binomial(y_true[i], raw_prediction[i]);
}

template <typename T>
static void loss_gradient(int n, const T *y_true, const T *raw_prediction, const T *sample_weight,
                          T *loss_out, T *gradient_out)
{
    double_pair dbl2;
    for (int i = 0; i < n; i++) {
        dbl2 = closs_grad_half_binomial(y_true[i], raw_prediction[i]);
        if (sample_weight == NULL) {
            loss_out[i] = dbl2.val1;
            gradient_out[i] = dbl2.val2;
        } else {
            loss_out[i] = sample_weight[i] * dbl2.val1;
            gradient_out[i] = sample_weight[i] * dbl2.val2;
        }
    }
}

template <typename T>
static void gradient(int n, const T *y_true, const T *raw_prediction, const T *sample_weight, T *gradient_out)
{
    if (sample_weight == NULL)
        for (int i = 0; i < n; i++)
            gradient_out[i] = cgradient_half_binomial(y_true[i], raw_prediction[i]);
    else
        for (int i = 0; i < n; i++)
            gradient_out[i] = sample_weight[i] * cgradient_half_binomial(y_true[i], raw_prediction[i]);
}

template <typename T>
static void gradient_hessian(int n, const T *y_true, const T *raw_prediction, const T *sample_weight,
                             T *gradient_out, T *hessian_out)
{
    double_pair dbl2;
    for (int i = 0; i < n; i++) {
        dbl2 = cgrad_hess_half_binomial(y_true[i], raw_prediction[i]);
        if (sample_weight == NULL) {
            gradient_out[i] = dbl2.val1;
            hessian_out[i] = dbl2.val2;
        } else {
            gradient_out[i] = sample_weight[i] * dbl2.val1;
            hessian_out[i] = sample_weight[i] * dbl2.val2;
        }
    }
}

}  // namespace vitae_loss

#endif

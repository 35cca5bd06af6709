/*
 * scikit-learn 1.9.0's SAG solver for the binary logistic loss, for float
 * and double data, behind a plain C interface for ctypes (utils/sag.py),
 * with the half binomial loss's per-sample loops (loss.h) that
 * utils/linear_loss.py calls.
 *
 * - `our_rand_r` and `ArrayDataset` (sklearn/utils/_random.pxd,
 *   sklearn/utils/_seq_dataset.pyx.tp): the 32-bit xorshift generator and
 *   the dense dataset's `random` draw (with replacement) of a row, its label
 *   and its sample weight;
 * - `sag` (sklearn/linear_model/_sag_fast.pyx.tp `sag32` / `sag64`) with
 *   loss "log", one class, saga off and no L1 term: the just-in-time
 *   updates (`lagged_update`), the weight scale and its reset
 *   (`scale_weights`), `predict_sample`, the intercept's update with decay,
 *   and the stopping test max|change| / max|weight| <= tol after each epoch.
 *
 * Every expression keeps the types of the Cython source: the per-sample
 * arithmetic in the data's type, the step and the loss's gradient in
 * double, rounded where the Cython code stores into the data's type.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include "loss.h"

namespace {

const uint32_t DEFAULT_SEED = 1;
const uint32_t RAND_R_MAX = 2147483647;

inline uint32_t our_rand_r(uint32_t *seed)
{
    if (seed[0] == 0)
        seed[0] = DEFAULT_SEED;
    seed[0] ^= (uint32_t) (seed[0] << 13);
    seed[0] ^= (uint32_t) (seed[0] >> 17);
    seed[0] ^= (uint32_t) (seed[0] << 5);
    return seed[0] % (RAND_R_MAX + (uint32_t) 1);
}

template <typename T>
struct ArrayDataset {
    const T *X_data_ptr;
    const T *Y_data_ptr;
    const T *sample_weight_data;
    int n_samples;
    int n_features;
    long long X_stride;
    int *feature_indices_ptr;
    int *index_data_ptr;
    int current_index;
    uint32_t seed;

    int random(const T **x_data_ptr, int **x_ind_ptr, int *nnz, T *y, T *sample_weight)
    {
        int current_index = (int) (our_rand_r(&seed) % (uint32_t) n_samples);
        this->current_index = current_index;
        long long sample_idx = index_data_ptr[current_index];
        long long offset = sample_idx * X_stride;
        y[0] = Y_data_ptr[sample_idx];
        x_data_ptr[0] = X_data_ptr + offset;
        x_ind_ptr[0] = feature_indices_ptr;
        nnz[0] = n_features;
        sample_weight[0] = sample_weight_data[sample_idx];
        return current_index;
    }
};

template <typename T>
inline T fmax_t(T x, T y)
{
    if (x > y)
        return x;
    return y;
}

/* the just-in-time update of the features of the current sample (or of
 * every feature, with reset, which also applies wscale) */
template <typename T>
int lagged_update(T *weights, T wscale, int xnnz, int n_samples, int sample_itr, T *cumulative_sums,
                  int *feature_hist, T *sum_gradient, const int *x_ind_ptr, bool reset)
{
    int feature_ind, idx;
    T cum_sum;
    for (int j = 0; j < xnnz; j++) {
        feature_ind = reset ? j : x_ind_ptr[j];
        cum_sum = cumulative_sums[sample_itr - 1];
        if (feature_hist[feature_ind] != 0)
            cum_sum -= cumulative_sums[feature_hist[feature_ind] - 1];
        idx = feature_ind;
        weights[idx] -= cum_sum * sum_gradient[idx];
        if (reset) {
            weights[idx] *= wscale;
            if (!isfinite(weights[idx]))
                return -1;
        }
        if (reset)
            feature_hist[feature_ind] = sample_itr % n_samples;
        else
            feature_hist[feature_ind] = sample_itr;
    }
    if (reset)
        cumulative_sums[sample_itr - 1] = 0.0;
    return 0;
}

template <typename T>
int scale_weights(T *weights, T *wscale, int n_features, int n_samples, int sample_itr, T *cumulative_sums,
                  int *feature_hist, T *sum_gradient)
{
    int status = lagged_update<T>(weights, wscale[0], n_features, n_samples, sample_itr + 1, cumulative_sums,
                                  feature_hist, sum_gradient, NULL, true);
    if (status == 0)
        wscale[0] = 1.0;
    return status;
}

template <typename T>
void predict_sample(const T *x_data_ptr, const int *x_ind_ptr, int xnnz, const T *w_data_ptr, T wscale,
                    const T *intercept, T *prediction)
{
    T innerprod = 0.0;
    for (int j = 0; j < xnnz; j++)
        innerprod += w_data_ptr[x_ind_ptr[j]] * x_data_ptr[j];
    prediction[0] = wscale * innerprod + intercept[0];
}

/* -> 0, or -1 after a floating-point under- or overflow; *n_iter_out is the
 * epoch count as `sag{32,64}` returns it */
template <typename T>
int sag(ArrayDataset<T> *dataset, T *weights, T *intercept_array, int n_samples, int n_features, double tol,
        int max_iter, double step_size, double alpha, T *sum_gradient, T *gradient_memory, int *seen_init,
        int *num_seen_io, int fit_intercept, T *intercept_sum_gradient, double intercept_decay,
        int *n_iter_out)
{
    const T *x_data_ptr = NULL;
    int *x_ind_ptr = NULL;
    int xnnz = -1;
    T y, sample_weight;
    int s_idx, feature_ind;
    int n_iter = 0;
    int sample_itr, sample_ind;
    T max_change, max_weight;
    T wscale_update = 1.0 - step_size * alpha;
    T *cumulative_sums = (T *) malloc(sizeof(T) * (size_t) n_samples);
    int *feature_hist = (int *) calloc((size_t) n_features, sizeof(int));
    T *previous_weights = (T *) calloc((size_t) n_features, sizeof(T));
    T prediction[1] = {0};
    T gradient[1] = {0};
    T val, gradient_correction;
    T wscale = 1.0;
    int status = 0;
    int num_seen = *num_seen_io;
    bool broke = false;

    if (cumulative_sums == NULL || feature_hist == NULL || previous_weights == NULL) {
        free(cumulative_sums);
        free(feature_hist);
        free(previous_weights);
        return -2;
    }
    cumulative_sums[0] = 0.0;

    for (n_iter = 0; n_iter < max_iter; n_iter++) {
        for (sample_itr = 0; sample_itr < n_samples; sample_itr++) {
            sample_ind = dataset->random(&x_data_ptr, &x_ind_ptr, &xnnz, &y, &sample_weight);
            s_idx = sample_ind;
            if (seen_init[sample_ind] == 0) {
                num_seen += 1;
                seen_init[sample_ind] = 1;
            }
            if (sample_itr > 0) {
                status = lagged_update<T>(weights, wscale, xnnz, n_samples, sample_itr, cumulative_sums,
                                          feature_hist, sum_gradient, x_ind_ptr, false);
                if (status == -1)
                    break;
            }
            predict_sample<T>(x_data_ptr, x_ind_ptr, xnnz, weights, wscale, intercept_array, prediction);
            gradient[0] = vitae_loss::cgradient_half_binomial(y, prediction[0]) * sample_weight;
            wscale *= wscale_update;
            for (int j = 0; j < xnnz; j++) {
                feature_ind = x_ind_ptr[j];
                val = x_data_ptr[j];
                gradient_correction = val * (gradient[0] - gradient_memory[s_idx]);
                sum_gradient[feature_ind] += gradient_correction;
            }
            if (fit_intercept) {
                gradient_correction = gradient[0] - gradient_memory[s_idx];
                intercept_sum_gradient[0] += gradient_correction;
                gradient_correction *= step_size * (1. - 1. / num_seen);
                intercept_array[0] -= step_size * intercept_sum_gradient[0] / num_seen * intercept_decay;
                if (!isfinite(intercept_array[0])) {
                    status = -1;
                    break;
                }
            }
            gradient_memory[s_idx] = gradient[0];
            if (sample_itr == 0)
                cumulative_sums[0] = step_size / (wscale * num_seen);
            else
                cumulative_sums[sample_itr] = cumulative_sums[sample_itr - 1] + step_size / (wscale * num_seen);
            if (wscale < 1e-9) {
                status = scale_weights<T>(weights, &wscale, n_features, n_samples, sample_itr, cumulative_sums,
                                          feature_hist, sum_gradient);
                if (status == -1)
                    break;
            }
        }
        if (status == -1) {
            broke = true;
            break;
        }
        status = scale_weights<T>(weights, &wscale, n_features, n_samples, n_samples - 1, cumulative_sums,
                                  feature_hist, sum_gradient);
        if (status == -1) {
            broke = true;
            break;
        }
        max_change = 0.0;
        max_weight = 0.0;
        for (int idx = 0; idx < n_features; idx++) {
            max_weight = fmax_t<T>(max_weight, fabs(weights[idx]));
            max_change = fmax_t<T>(max_change, fabs(weights[idx] - previous_weights[idx]));
            previous_weights[idx] = weights[idx];
        }
        if ((max_weight != 0 && max_change / max_weight <= tol) || (max_weight == 0 && max_change == 0)) {
            broke = true;
            break;
        }
    }
    /* Cython leaves a `for ... in range(max_iter)` variable at its last
     * value, max_iter - 1, when the loop runs out */
    if (!broke && max_iter > 0)
        n_iter = max_iter - 1;
    n_iter += 1;
    free(cumulative_sums);
    free(feature_hist);
    free(previous_weights);
    *num_seen_io = num_seen;
    *n_iter_out = n_iter;
    return status == -1 ? -1 : 0;
}

template <typename T>
int sag_dense(const T *X, const T *Y, const T *sample_weights, int n_samples, int n_features, uint32_t seed,
              T *weights, T *intercept, double tol, int max_iter, double step_size, double alpha,
              T *sum_gradient, T *gradient_memory, int *seen, int *num_seen, int fit_intercept,
              T *intercept_sum_gradient, double intercept_decay, int *n_iter)
{
    ArrayDataset<T> dataset;
    int *feature_indices = (int *) malloc(sizeof(int) * (size_t) n_features);
    int *index = (int *) malloc(sizeof(int) * (size_t) n_samples);
    if (feature_indices == NULL || index == NULL) {
        free(feature_indices);
        free(index);
        return -2;
    }
    for (int j = 0; j < n_features; j++)
        feature_indices[j] = j;
    for (int i = 0; i < n_samples; i++)
        index[i] = i;
    dataset.X_data_ptr = X;
    dataset.Y_data_ptr = Y;
    dataset.sample_weight_data = sample_weights;
    dataset.n_samples = n_samples;
    dataset.n_features = n_features;
    dataset.X_stride = n_features;
    dataset.feature_indices_ptr = feature_indices;
    dataset.index_data_ptr = index;
    dataset.current_index = -1;
    dataset.seed = seed > 1 ? seed : 1;
    int status = sag<T>(&dataset, weights, intercept, n_samples, n_features, tol, max_iter, step_size, alpha,
                        sum_gradient, gradient_memory, seen, num_seen, fit_intercept, intercept_sum_gradient,
                        intercept_decay, n_iter);
    free(feature_indices);
    free(index);
    return status;
}

}  // namespace

extern "C" {

/* sag{32,64} on an ArrayDataset{32,64}(X, Y, sample_weights, seed) of
 * C-ordered dense rows: -> 0, -1 after a floating-point under- or
 * overflow, -2 when out of memory */
#define VITAE_SAG(suffix, T)                                                                                     \
    int vitae_sag##suffix(const T *X, const T *Y, const T *sample_weights, int n_samples, int n_features,       \
                          uint32_t seed, T *weights, T *intercept, double tol, int max_iter, double step_size,  \
                          double alpha, T *sum_gradient, T *gradient_memory, int *seen, int *num_seen,          \
                          int fit_intercept, T *intercept_sum_gradient, double intercept_decay, int *n_iter)    \
    {                                                                                                            \
        return sag_dense<T>(X, Y, sample_weights, n_samples, n_features, seed, weights, intercept, tol,          \
                            max_iter, step_size, alpha, sum_gradient, gradient_memory, seen, num_seen,           \
                            fit_intercept, intercept_sum_gradient, intercept_decay, n_iter);                     \
    }
VITAE_SAG(32, float)
VITAE_SAG(64, double)

/* CyHalfBinomialLoss's loops (sample_weight may be NULL) */
#define VITAE_LOSS(suffix, T)                                                                                    \
    void vitae_half_binomial_loss##suffix(int n, const T *y, const T *raw, const T *sw, T *loss_out)            \
    {                                                                                                            \
        vitae_loss::loss<T>(n, y, raw, sw, loss_out);                                                            \
    }                                                                                                            \
    void vitae_half_binomial_loss_gradient##suffix(int n, const T *y, const T *raw, const T *sw, T *loss_out,   \
                                                   T *gradient_out)                                              \
    {                                                                                                            \
        vitae_loss::loss_gradient<T>(n, y, raw, sw, loss_out, gradient_out);                                     \
    }                                                                                                            \
    void vitae_half_binomial_gradient##suffix(int n, const T *y, const T *raw, const T *sw, T *gradient_out)    \
    {                                                                                                            \
        vitae_loss::gradient<T>(n, y, raw, sw, gradient_out);                                                    \
    }                                                                                                            \
    void vitae_half_binomial_gradient_hessian##suffix(int n, const T *y, const T *raw, const T *sw,             \
                                                      T *gradient_out, T *hessian_out)                           \
    {                                                                                                            \
        vitae_loss::gradient_hessian<T>(n, y, raw, sw, gradient_out, hessian_out);                               \
    }
VITAE_LOSS(32, float)
VITAE_LOSS(64, double)
}

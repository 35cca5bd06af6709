/*
 * One translation unit holding scikit-learn's modified libsvm (its dense
 * representation only, as sklearn/svm/src/libsvm/libsvm_template.cpp builds
 * it with _DENSE_REP) and the helper functions of libsvm_helper.c, behind a
 * plain C interface for ctypes (utils/libsvm.py).
 *
 * The two entry points below do what sklearn/svm/_libsvm.pyx does around
 * the helpers: `vitae_svm_fit` is its `fit` up to `svm_train`, and
 * `vitae_svm_predict` its `predict`, `predict_proba` and
 * `decision_function` (set_predict_params, set_model, copy_predict*,
 * free_model). The kernel's dot product is the BLAS `ddot` whose address
 * `vitae_set_ddot` is given, called as sklearn's `_dot` calls scipy's
 * (sklearn/utils/_cython_blas.pyx): by reference, in Fortran's convention.
 */

#define _DENSE_REP
#include "svm.cpp"

extern "C" {
#include "libsvm_helper.c"

typedef double (*fortran_ddot)(int *, double *, int *, double *, int *);
static fortran_ddot blas_ddot = NULL;

static double ddot_by_value(int n, const double *x, int incx, const double *y, int incy)
{
    return blas_ddot(&n, (double *) x, &incx, (double *) y, &incy);
}

static void print_null(const char *s) {}

void vitae_set_ddot(void *fn)
{
    blas_ddot = (fortran_ddot) fn;
}

/* svm_train on dense float64 rows X (dims = {n_samples, n_features});
 * NULL with *error_msg set when libsvm refuses the parameters. The model's
 * support vectors point into X, which must outlive the copies made from
 * the model. */
struct svm_model *vitae_svm_fit(
    double *X, double *Y, double *sample_weight, Py_ssize_t *dims,
    int svm_type, int kernel_index, int degree, double gamma, double coef0,
    double nu, double cache_size, double C, double tol, double epsilon,
    int shrinking, int probability, int nr_weight, int *weight_label,
    double *weight, int max_iter, int random_seed,
    int *fit_status, const char **error_msg)
{
    struct svm_problem problem;
    struct svm_parameter param;
    struct svm_model *model;
    BlasFunctions blas_functions;

    *error_msg = NULL;
    set_problem(&problem, (char *) X, (char *) Y, (char *) sample_weight, dims, kernel_index);
    if (problem.x == NULL) {
        *error_msg = "out of memory";
        return NULL;
    }
    set_parameter(&param, svm_type, kernel_index, degree, gamma, coef0, nu, cache_size, C,
                  tol, epsilon, shrinking, probability, nr_weight, (char *) weight_label,
                  (char *) weight, max_iter, random_seed);
    *error_msg = svm_check_parameter(&problem, &param);
    if (*error_msg) {
        free(problem.x);
        return NULL;
    }
    svm_set_print_string_function(&print_null);  /* sklearn with verbose=False */
    blas_functions.dot = ddot_by_value;
    model = svm_train(&problem, &param, fit_status, &blas_functions);
    free(problem.x);
    return model;
}

/* what: 0 predict (dec_values n), 1 predict_proba (n x nr_class),
 * 2 decision_function (n x nr_class*(nr_class-1)/2). -1 when out of
 * memory. */
int vitae_svm_predict(
    int what, double *X, Py_ssize_t *X_dims, int nr_class,
    double *SV, Py_ssize_t *SV_dims, int *support, Py_ssize_t *support_dims,
    Py_ssize_t *sv_coef_strides, double *sv_coef, double *intercept, int *nSV,
    double *probA, double *probB, int svm_type, int kernel_index, int degree,
    double gamma, double coef0, double cache_size, double *out)
{
    struct svm_parameter param;
    struct svm_model *model;
    BlasFunctions blas_functions;
    int rv, n_dec;

    /* sklearn/svm/_libsvm.pyx set_predict_params: the training-only
     * parameters at fixed values, no class weights */
    set_parameter(&param, svm_type, kernel_index, degree, gamma, coef0, 0.5, cache_size, 0.0,
                  0.1, 0.1, 0, what == 1, 0, NULL, NULL, 0, -1);
    model = set_model(&param, nr_class, (char *) SV, SV_dims, (char *) support, support_dims,
                      sv_coef_strides, (char *) sv_coef, (char *) intercept, (char *) nSV,
                      (char *) probA, (char *) probB);
    if (model == NULL)
        return -1;
    blas_functions.dot = ddot_by_value;
    if (what == 0) {
        rv = copy_predict((char *) X, model, X_dims, (char *) out, &blas_functions);
    } else if (what == 1) {
        rv = copy_predict_proba((char *) X, model, X_dims, (char *) out, &blas_functions);
    } else {
        n_dec = svm_type > 1 ? 1 : nr_class * (nr_class - 1) / 2;
        rv = copy_predict_values((char *) X, model, X_dims, (char *) out, n_dec, &blas_functions);
    }
    free_model(model);
    return rv;
}
}

/*
 * The helper functions of liblinear_helper.c behind a plain C interface for
 * ctypes (utils/liblinear.py), built together with linear.cpp and tron.cpp
 * (three translation units, as scikit-learn builds them).
 *
 * `vitae_liblinear_train` does what sklearn/svm/_liblinear.pyx `train_wrap`
 * does for dense input around the helpers: set_problem, set_parameter
 * (which seeds liblinear's mt19937 through set_seed), check_parameter,
 * train with the BLAS functions, free_problem and free_parameter. The model
 * it returns is read with get_nr_class, get_nr_feature, get_n_iter and
 * copy_w, and freed with free_and_destroy_model. The BLAS functions are the
 * Fortran `ddot`, `daxpy`, `dscal` and `dnrm2` whose addresses
 * `vitae_liblinear_set_blas` is given, called as sklearn's `_dot`, `_axpy`,
 * `_scal` and `_nrm2` call scipy's (sklearn/utils/_cython_blas.pyx): by
 * reference.
 */

#include "linear.h"

extern "C" {
#include "liblinear_helper.c"

typedef double (*fortran_ddot)(int *, double *, int *, double *, int *);
typedef void (*fortran_daxpy)(int *, double *, double *, int *, double *, int *);
typedef void (*fortran_dscal)(int *, double *, double *, int *);
typedef double (*fortran_dnrm2)(int *, double *, int *);

static fortran_ddot blas_ddot = NULL;
static fortran_daxpy blas_daxpy = NULL;
static fortran_dscal blas_dscal = NULL;
static fortran_dnrm2 blas_dnrm2 = NULL;

static double dot_by_value(int n, const double *x, int incx, const double *y, int incy)
{
    return blas_ddot(&n, (double *) x, &incx, (double *) y, &incy);
}

static void axpy_by_value(int n, double alpha, const double *x, int incx, double *y, int incy)
{
    blas_daxpy(&n, &alpha, (double *) x, &incx, y, &incy);
}

static void scal_by_value(int n, double alpha, const double *x, int incx)
{
    blas_dscal(&n, &alpha, (double *) x, &incx);
}

static double nrm2_by_value(int n, const double *x, int incx)
{
    return blas_dnrm2(&n, (double *) x, &incx);
}

void vitae_liblinear_set_blas(void *ddot, void *daxpy, void *dscal, void *dnrm2)
{
    blas_ddot = (fortran_ddot) ddot;
    blas_daxpy = (fortran_daxpy) daxpy;
    blas_dscal = (fortran_dscal) dscal;
    blas_dnrm2 = (fortran_dnrm2) dnrm2;
}

/* train on dense rows X (float64 when double_precision_X, else float32;
 * n_samples x n_features, C order) with float64 labels Y and sample weights;
 * NULL with *error_msg set when liblinear refuses the parameters or memory
 * runs out. Silent, as scikit-learn with verbose=0. */
struct model *vitae_liblinear_train(
    char *X, int double_precision_X, int n_samples, int n_features, int n_nonzero,
    double bias, char *sample_weight, char *Y, int solver_type, double eps, double C,
    int nr_weight, char *weight_label, char *weight, int max_iter, unsigned random_seed,
    double epsilon, const char **error_msg)
{
    struct problem *problem;
    struct parameter *param;
    struct model *model;
    BlasFunctions blas_functions;

    *error_msg = NULL;
    problem = set_problem(X, double_precision_X, n_samples, n_features, n_nonzero, bias,
                          sample_weight, Y);
    if (problem == NULL) {
        *error_msg = "out of memory";
        return NULL;
    }
    param = set_parameter(solver_type, eps, C, nr_weight, nr_weight > 0 ? weight_label : NULL,
                          nr_weight > 0 ? weight : NULL, max_iter, random_seed, epsilon);
    if (param == NULL) {
        free_problem(problem);
        *error_msg = "out of memory";
        return NULL;
    }
    *error_msg = check_parameter(problem, param);
    if (*error_msg) {
        free_problem(problem);
        free_parameter(param);
        return NULL;
    }
    set_verbosity(0);
    blas_functions.dot = dot_by_value;
    blas_functions.axpy = axpy_by_value;
    blas_functions.scal = scal_by_value;
    blas_functions.nrm2 = nrm2_by_value;
    model = train(problem, param, &blas_functions);
    free_problem(problem);
    free_parameter(param);
    return model;
}
}

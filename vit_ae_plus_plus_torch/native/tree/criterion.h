/*
 * scikit-learn 1.9.0's classification criteria (sklearn/tree/_criterion.pyx
 * `ClassificationCriterion`, `Gini`, `Entropy`) for one output: the
 * weighted class counts of a node and of its two children, moved from the
 * nearer end as the split position advances (`update`), the impurities,
 * the proxy the splitter maximises and the improvement it records, and the
 * node value (weighted class fractions).
 *
 * Entropy's logarithm is libm's `log(x) / log(2.0)` (sklearn/tree/_utils.pyx
 * `log`), as the Cython code calls it.
 */

#pragma once

#include <math.h>
#include <string.h>
#include <vector>

#include "utils.h"

namespace vitae_tree {

enum CriterionKind { GINI = 0, ENTROPY = 1 };

inline double log2_libm(double x)
{
    return log(x) / log(2.0);
}

struct ClassificationCriterion {
    static const intp_t n_outputs = 1;
    CriterionKind kind;
    intp_t n_classes;

    const double *y;              /* encoded class of each row */
    const double *sample_weight;  /* NULL: every row weighs 1 */
    const intp_t *sample_indices;
    intp_t start, pos, end;
    intp_t n_node_samples;
    double weighted_n_samples;
    double weighted_n_node_samples;
    double weighted_n_left;
    double weighted_n_right;

    std::vector<double> sum_total, sum_left, sum_right;

    ClassificationCriterion(CriterionKind kind_, intp_t n_classes_)
        : kind(kind_), n_classes(n_classes_), y(nullptr), sample_weight(nullptr), sample_indices(nullptr),
          start(0), pos(0), end(0), n_node_samples(0), weighted_n_samples(0.0), weighted_n_node_samples(0.0),
          weighted_n_left(0.0), weighted_n_right(0.0), sum_total(n_classes_, 0.0), sum_left(n_classes_, 0.0),
          sum_right(n_classes_, 0.0)
    {
    }

    void init(const double *y_, const double *sample_weight_, double weighted_n_samples_,
              const intp_t *sample_indices_, intp_t start_, intp_t end_)
    {
        y = y_;
        sample_weight = sample_weight_;
        sample_indices = sample_indices_;
        start = start_;
        end = end_;
        n_node_samples = end_ - start_;
        weighted_n_samples = weighted_n_samples_;
        weighted_n_node_samples = 0.0;
        double w = 1.0;
        memset(sum_total.data(), 0, n_classes * sizeof(double));
        for (intp_t p = start; p < end; p++) {
            intp_t i = sample_indices[p];
            if (sample_weight != nullptr)
                w = sample_weight[i];
            intp_t c = (intp_t) y[i];
            sum_total[c] += w;
            weighted_n_node_samples += w;
        }
        reset();
    }

    /* _move_sums_classification: sum_1 = 0, sum_2 = sum_total */
    void move_sums(std::vector<double> &sum_1, std::vector<double> &sum_2, double *weighted_n_1,
                   double *weighted_n_2)
    {
        memset(sum_1.data(), 0, n_classes * sizeof(double));
        memcpy(sum_2.data(), sum_total.data(), n_classes * sizeof(double));
        weighted_n_1[0] = 0.0;
        weighted_n_2[0] = weighted_n_node_samples;
    }

    void reset()
    {
        pos = start;
        move_sums(sum_left, sum_right, &weighted_n_left, &weighted_n_right);
    }

    void reverse_reset()
    {
        pos = end;
        move_sums(sum_right, sum_left, &weighted_n_right, &weighted_n_left);
    }

    void update(intp_t new_pos)
    {
        double w = 1.0;
        if ((new_pos - pos) <= (end - new_pos)) {
            for (intp_t p = pos; p < new_pos; p++) {
                intp_t i = sample_indices[p];
                if (sample_weight != nullptr)
                    w = sample_weight[i];
                sum_left[(intp_t) y[i]] += w;
                weighted_n_left += w;
            }
        } else {
            reverse_reset();
            for (intp_t p = end - 1; p > new_pos - 1; p--) {
                intp_t i = sample_indices[p];
                if (sample_weight != nullptr)
                    w = sample_weight[i];
                sum_left[(intp_t) y[i]] -= w;
                weighted_n_left -= w;
            }
        }
        weighted_n_right = weighted_n_node_samples - weighted_n_left;
        for (intp_t c = 0; c < n_classes; c++)
            sum_right[c] = sum_total[c] - sum_left[c];
        pos = new_pos;
    }

    double node_impurity() const
    {
        if (kind == GINI) {
            double gini = 0.0;
            double sq_count = 0.0;
            for (intp_t c = 0; c < n_classes; c++) {
                double count_k = sum_total[c];
                sq_count += count_k * count_k;
            }
            gini += 1.0 - sq_count / (weighted_n_node_samples * weighted_n_node_samples);
            return gini / n_outputs;
        }
        double entropy = 0.0;
        for (intp_t c = 0; c < n_classes; c++) {
            double count_k = sum_total[c];
            if (count_k > 0.0) {
                count_k /= weighted_n_node_samples;
                entropy -= count_k * log2_libm(count_k);
            }
        }
        return entropy / n_outputs;
    }

    void children_impurity(double *impurity_left, double *impurity_right) const
    {
        if (kind == GINI) {
            double gini_left = 0.0, gini_right = 0.0;
            double sq_count_left = 0.0, sq_count_right = 0.0;
            for (intp_t c = 0; c < n_classes; c++) {
                double count_k = sum_left[c];
                sq_count_left += count_k * count_k;
                count_k = sum_right[c];
                sq_count_right += count_k * count_k;
            }
            gini_left += 1.0 - sq_count_left / (weighted_n_left * weighted_n_left);
            gini_right += 1.0 - sq_count_right / (weighted_n_right * weighted_n_right);
            impurity_left[0] = gini_left / n_outputs;
            impurity_right[0] = gini_right / n_outputs;
            return;
        }
        double entropy_left = 0.0, entropy_right = 0.0;
        for (intp_t c = 0; c < n_classes; c++) {
            double count_k = sum_left[c];
            if (count_k > 0.0) {
                count_k /= weighted_n_left;
                entropy_left -= count_k * log2_libm(count_k);
            }
            count_k = sum_right[c];
            if (count_k > 0.0) {
                count_k /= weighted_n_right;
                entropy_right -= count_k * log2_libm(count_k);
            }
        }
        impurity_left[0] = entropy_left / n_outputs;
        impurity_right[0] = entropy_right / n_outputs;
    }

    void node_value(double *dest) const
    {
        for (intp_t c = 0; c < n_classes; c++)
            dest[c] = sum_total[c] / weighted_n_node_samples;
    }

    double proxy_impurity_improvement() const
    {
        double impurity_left, impurity_right;
        children_impurity(&impurity_left, &impurity_right);
        return (-weighted_n_right * impurity_right - weighted_n_left * impurity_left);
    }

    double impurity_improvement(double impurity_parent, double impurity_left, double impurity_right) const
    {
        return ((weighted_n_node_samples / weighted_n_samples) *
                (impurity_parent - (weighted_n_right / weighted_n_node_samples * impurity_right) -
                 (weighted_n_left / weighted_n_node_samples * impurity_left)));
    }
};

}  // namespace vitae_tree

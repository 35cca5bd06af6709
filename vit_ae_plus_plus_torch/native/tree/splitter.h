/*
 * scikit-learn 1.9.0's best splitter on dense float32 rows, without
 * missing values or monotonic constraints:
 *
 * - `DensePartitioner` (sklearn/tree/_partitioner.pyx): a feature's
 *   values copied out for the node's rows and sorted with them
 *   (`sort_samples_and_feature_values`, the 3-way introsort), the next
 *   candidate position past ties up to FEATURE_THRESHOLD (`next_p`), and
 *   the node's rows partitioned on the chosen threshold
 *   (`partition_samples_final`);
 * - `Splitter.init` and `node_split_best` (sklearn/tree/_splitter.pyx):
 *   the rows of weight 0 left out, the features drawn Fisher-Yates style
 *   through a permutation that persists from node to node, constant
 *   features remembered for the node's descendants (and the draw going on
 *   past max_features while every feature drawn so far was constant), the
 *   threshold at the midpoint a / 2.0 + b / 2.0 in double, and the
 *   children's impurities and the improvement of the split chosen.
 *
 * Each comparison keeps the Cython types: feature values in float (the
 * tie test adds a float FEATURE_THRESHOLD in float), thresholds in double.
 */

#pragma once

#include <math.h>
#include <string.h>
#include <vector>

#include "criterion.h"
#include "utils.h"

namespace vitae_tree {

const float FEATURE_THRESHOLD = 1e-7;

struct SplitRecord {
    intp_t feature;
    intp_t pos;
    double threshold;
    double improvement;
    double impurity_left;
    double impurity_right;
    uint8_t missing_go_to_left;
};

struct ParentInfo {
    double impurity;
    intp_t n_constant_features;
};

inline void init_split(SplitRecord *self, intp_t start_pos)
{
    self->impurity_left = INFINITY;
    self->impurity_right = INFINITY;
    self->pos = start_pos;
    self->feature = 0;
    self->threshold = 0.;
    self->improvement = -INFINITY;
    self->missing_go_to_left = 0;
}

struct DensePartitioner {
    const float *X;
    intp_t n_features;  /* X's row stride */
    intp_t *samples;
    float *feature_values;
    intp_t start, end;

    void init_node_split(intp_t start_, intp_t end_)
    {
        start = start_;
        end = end_;
    }

    void sort_samples_and_feature_values(intp_t current_feature)
    {
        for (intp_t i = start; i < end; i++)
            feature_values[i] = X[samples[i] * n_features + current_feature];
        simultaneous_sort(&feature_values[start], &samples[start], end - start, true);
    }

    /* no missing values: p runs over [start, end] */
    void next_p(intp_t *p_prev, intp_t *p)
    {
        intp_t end_non_missing = end;
        if (p[0] == end_non_missing) {
            p[0] = end;
            p_prev[0] = end;
        } else {
            p[0] += 1;
            while (p[0] < end_non_missing && feature_values[p[0]] <= feature_values[p[0] - 1] + FEATURE_THRESHOLD)
                p[0] += 1;
            p_prev[0] = p[0] - 1;
        }
    }

    void partition_samples_final(const SplitRecord *best_split)
    {
        intp_t partition_start = start, partition_end = end;
        double best_threshold = best_split->threshold;
        intp_t best_feature = best_split->feature;
        while (partition_start < partition_end) {
            float current_value = X[samples[partition_start] * n_features + best_feature];
            bool go_to_left = current_value <= best_threshold;
            if (go_to_left) {
                partition_start += 1;
            } else {
                partition_end -= 1;
                intp_t s = samples[partition_start];
                samples[partition_start] = samples[partition_end];
                samples[partition_end] = s;
            }
        }
    }
};

struct BestSplitter {
    ClassificationCriterion criterion;
    intp_t max_features;
    intp_t min_samples_leaf;
    double min_weight_leaf;
    uint32_t rand_r_state;

    std::vector<intp_t> samples;
    intp_t n_samples;
    double weighted_n_samples;
    std::vector<intp_t> features;
    std::vector<intp_t> constant_features;
    intp_t n_features;
    std::vector<float> feature_values;
    intp_t start, end;
    const double *y;
    const double *sample_weight;
    DensePartitioner partitioner;

    BestSplitter(CriterionKind kind, intp_t n_classes, intp_t max_features_, intp_t min_samples_leaf_,
                 double min_weight_leaf_, uint32_t rand_r_state_)
        : criterion(kind, n_classes), max_features(max_features_), min_samples_leaf(min_samples_leaf_),
          min_weight_leaf(min_weight_leaf_), rand_r_state(rand_r_state_), n_samples(0), weighted_n_samples(0.0),
          n_features(0), start(0), end(0), y(nullptr), sample_weight(nullptr)
    {
    }

    /* Splitter.init, after the caller drew rand_r_state */
    void init(const float *X, intp_t n_rows, intp_t n_cols, const double *y_, const double *sample_weight_)
    {
        samples.assign(n_rows, 0);
        intp_t j = 0;
        double weighted = 0.0;
        for (intp_t i = 0; i < n_rows; i++) {
            if (sample_weight_ == nullptr || sample_weight_[i] != 0.0) {
                samples[j] = i;
                j += 1;
            }
            if (sample_weight_ != nullptr)
                weighted += sample_weight_[i];
            else
                weighted += 1.0;
        }
        n_samples = j;
        weighted_n_samples = weighted;
        n_features = n_cols;
        features.resize(n_cols);
        for (intp_t f = 0; f < n_cols; f++)
            features[f] = f;
        feature_values.assign(n_rows, 0.0f);
        constant_features.assign(n_cols, 0);
        y = y_;
        sample_weight = sample_weight_;
        partitioner = DensePartitioner{X, n_cols, samples.data(), feature_values.data(), 0, 0};
    }

    void node_reset(intp_t start_, intp_t end_, double *weighted_n_node_samples)
    {
        start = start_;
        end = end_;
        criterion.init(y, sample_weight, weighted_n_samples, samples.data(), start_, end_);
        weighted_n_node_samples[0] = criterion.weighted_n_node_samples;
    }

    double node_impurity() const { return criterion.node_impurity(); }

    void node_value(double *dest) const { criterion.node_value(dest); }

    /* node_split_best with DensePartitioner, no missing values and no
     * monotonic constraints */
    void node_split(ParentInfo *parent_record, SplitRecord *split)
    {
        intp_t *feats = features.data();
        intp_t *constants = constant_features.data();
        float *fv = feature_values.data();
        uint32_t *random_state = &rand_r_state;

        SplitRecord best_split, current_split;
        memset(&current_split, 0, sizeof(current_split));
        double current_proxy_improvement = -INFINITY;
        double best_proxy_improvement = -INFINITY;
        double impurity = parent_record->impurity;

        intp_t f_i = n_features;
        intp_t f_j;
        intp_t p, p_prev;
        intp_t n_visited_features = 0;
        intp_t n_found_constants = 0;
        intp_t n_drawn_constants = 0;
        intp_t n_known_constants = parent_record->n_constant_features;
        intp_t n_total_constants = n_known_constants;

        init_split(&best_split, end);
        partitioner.init_node_split(start, end);

        while (f_i > n_total_constants &&
               (n_visited_features < max_features || n_visited_features <= n_found_constants + n_drawn_constants)) {
            n_visited_features += 1;
            f_j = rand_int(n_drawn_constants, f_i - n_found_constants, random_state);
            if (f_j < n_known_constants) {
                intp_t t = feats[n_drawn_constants];
                feats[n_drawn_constants] = feats[f_j];
                feats[f_j] = t;
                n_drawn_constants += 1;
                continue;
            }
            f_j += n_found_constants;
            current_split.feature = feats[f_j];
            partitioner.sort_samples_and_feature_values(current_split.feature);
            intp_t end_non_missing = end;
            if (end_non_missing == start || fv[end_non_missing - 1] <= fv[start] + FEATURE_THRESHOLD) {
                intp_t t = feats[f_j];
                feats[f_j] = feats[n_total_constants];
                feats[n_total_constants] = t;
                n_found_constants += 1;
                n_total_constants += 1;
                continue;
            }
            f_i -= 1;
            {
                intp_t t = feats[f_i];
                feats[f_i] = feats[f_j];
                feats[f_j] = t;
            }

            criterion.reset();
            p = start;
            while (p < end) {
                partitioner.next_p(&p_prev, &p);
                if (p == end)
                    continue;
                intp_t n_left = p - start;
                intp_t n_right = end - p;
                if (n_left < min_samples_leaf || n_right < min_samples_leaf)
                    continue;
                current_split.pos = p;
                criterion.update(current_split.pos);
                if (criterion.weighted_n_left < min_weight_leaf || criterion.weighted_n_right < min_weight_leaf)
                    continue;
                current_proxy_improvement = criterion.proxy_impurity_improvement();
                if (current_proxy_improvement > best_proxy_improvement) {
                    best_proxy_improvement = current_proxy_improvement;
                    current_split.threshold = fv[p_prev] / 2.0 + fv[p] / 2.0;
                    current_split.missing_go_to_left = n_left > n_right;
                    best_split = current_split;
                }
            }
        }

        if (best_split.pos < end) {
            partitioner.partition_samples_final(&best_split);
            criterion.reset();
            criterion.update(best_split.pos);
            criterion.children_impurity(&best_split.impurity_left, &best_split.impurity_right);
            best_split.improvement =
                criterion.impurity_improvement(impurity, best_split.impurity_left, best_split.impurity_right);
        }

        memcpy(&feats[0], &constants[0], sizeof(intp_t) * n_known_constants);
        memcpy(&constants[n_known_constants], &feats[n_known_constants], sizeof(intp_t) * n_found_constants);

        parent_record->n_constant_features = n_total_constants;
        split[0] = best_split;
    }
};

}  // namespace vitae_tree

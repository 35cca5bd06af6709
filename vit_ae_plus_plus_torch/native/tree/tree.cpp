/*
 * scikit-learn 1.9.0's decision tree for classification, behind a plain C
 * interface for ctypes (utils/tree.py):
 *
 * - `Tree` (sklearn/tree/_tree.pyx): the node arrays (children, feature,
 *   threshold, impurity, row count and weight, the side missing values
 *   take) and the weighted class fractions of every node; `_add_node`;
 * - `DepthFirstTreeBuilder.build`: the stack of nodes (the right child
 *   pushed first, so the left one is grown first), the leaf tests
 *   (depth, min_samples_split, min_samples_leaf, min_weight_leaf, the
 *   impurity within EPSILON of 0, no split found, an improvement below
 *   min_impurity_decrease) and the root's impurity;
 * - `apply` on dense float32 rows, which compares a float feature with the
 *   double threshold.
 *
 * One output, dense rows without missing values, no monotonic
 * constraints: what a random forest of the classical evaluation grows.
 */

#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <memory>
#include <new>
#include <vector>

#include "criterion.h"
#include "splitter.h"
#include "utils.h"

namespace vitae_tree {

const intp_t TREE_LEAF = -1;
const intp_t TREE_UNDEFINED = -2;
const double EPSILON = DBL_EPSILON;

struct Node {
    intp_t left_child;
    intp_t right_child;
    intp_t feature;
    double threshold;
    double impurity;
    intp_t n_node_samples;
    double weighted_n_node_samples;
    uint8_t missing_go_to_left;
};

struct Tree {
    intp_t n_classes;
    intp_t max_depth;
    std::vector<Node> nodes;
    std::vector<double> value;

    intp_t add_node(intp_t parent, bool is_left, bool is_leaf, intp_t feature, double threshold, double impurity,
                    intp_t n_node_samples, double weighted_n_node_samples, uint8_t missing_go_to_left)
    {
        intp_t node_id = (intp_t) nodes.size();
        Node node;
        memset(&node, 0, sizeof(node));
        node.impurity = impurity;
        node.n_node_samples = n_node_samples;
        node.weighted_n_node_samples = weighted_n_node_samples;
        if (is_leaf) {
            node.left_child = TREE_LEAF;
            node.right_child = TREE_LEAF;
            node.feature = TREE_UNDEFINED;
            node.threshold = TREE_UNDEFINED;
        } else {
            node.feature = feature;
            node.threshold = threshold;
            node.missing_go_to_left = missing_go_to_left;
        }
        nodes.push_back(node);
        value.resize(value.size() + n_classes, 0.0);
        if (parent != TREE_UNDEFINED) {
            if (is_left)
                nodes[parent].left_child = node_id;
            else
                nodes[parent].right_child = node_id;
        }
        return node_id;
    }
};

struct StackRecord {
    intp_t start;
    intp_t end;
    intp_t depth;
    intp_t parent;
    bool is_left;
    double impurity;
    intp_t n_constant_features;
};

void build(Tree &tree, BestSplitter &splitter, const float *X, intp_t n_rows, intp_t n_cols, const double *y,
           const double *sample_weight, intp_t min_samples_split, intp_t min_samples_leaf, double min_weight_leaf,
           intp_t max_depth, double min_impurity_decrease)
{
    splitter.init(X, n_rows, n_cols, y, sample_weight);

    intp_t n_node_samples = splitter.n_samples;
    double weighted_n_node_samples;
    SplitRecord split;
    memset(&split, 0, sizeof(split));
    bool first = true;
    intp_t max_depth_seen = -1;

    std::vector<StackRecord> builder_stack;
    ParentInfo parent_record = {INFINITY, 0};
    builder_stack.push_back({0, n_node_samples, 0, TREE_UNDEFINED, false, INFINITY, 0});

    while (!builder_stack.empty()) {
        StackRecord stack_record = builder_stack.back();
        builder_stack.pop_back();

        intp_t start = stack_record.start;
        intp_t end = stack_record.end;
        intp_t depth = stack_record.depth;
        intp_t parent = stack_record.parent;
        bool is_left = stack_record.is_left;
        parent_record.impurity = stack_record.impurity;
        parent_record.n_constant_features = stack_record.n_constant_features;

        n_node_samples = end - start;
        splitter.node_reset(start, end, &weighted_n_node_samples);

        bool is_leaf = (depth >= max_depth || n_node_samples < min_samples_split ||
                        n_node_samples < 2 * min_samples_leaf || weighted_n_node_samples < 2 * min_weight_leaf);

        if (first) {
            parent_record.impurity = splitter.node_impurity();
            first = false;
        }

        is_leaf = is_leaf || parent_record.impurity <= EPSILON;

        if (!is_leaf) {
            splitter.node_split(&parent_record, &split);
            is_leaf = (is_leaf || split.pos >= end || (split.improvement + EPSILON < min_impurity_decrease));
        }

        intp_t node_id = tree.add_node(parent, is_left, is_leaf, split.feature, split.threshold,
                                       parent_record.impurity, n_node_samples, weighted_n_node_samples,
                                       split.missing_go_to_left);
        splitter.node_value(&tree.value[node_id * tree.n_classes]);

        if (!is_leaf) {
            builder_stack.push_back({split.pos, end, depth + 1, node_id, false, split.impurity_right,
                                     parent_record.n_constant_features});
            builder_stack.push_back({start, split.pos, depth + 1, node_id, true, split.impurity_left,
                                     parent_record.n_constant_features});
        }
        if (depth > max_depth_seen)
            max_depth_seen = depth;
    }
    tree.max_depth = max_depth_seen;
}

}  // namespace vitae_tree

using namespace vitae_tree;

extern "C" {

/* Grow one tree on C-ordered float32 rows X (n_rows x n_cols), the
 * encoded classes y (0 .. n_classes - 1, as doubles) and the row weights
 * (NULL: all 1); criterion 0 is gini, 1 entropy; rand_r_state is the
 * splitter's seed. -> the tree, to read with vitae_tree_copy and free with
 * vitae_tree_free, or NULL when out of memory. */
void *vitae_tree_build(const float *X, intp_t n_rows, intp_t n_cols, const double *y, const double *sample_weight,
                       intp_t n_classes, int criterion, intp_t max_features, intp_t max_depth,
                       intp_t min_samples_split, intp_t min_samples_leaf, double min_weight_leaf,
                       double min_impurity_decrease, uint32_t rand_r_state, intp_t *node_count,
                       intp_t *max_depth_seen)
{
    try {
        std::unique_ptr<Tree> tree(new Tree());
        tree->n_classes = n_classes;
        tree->max_depth = 0;
        tree->nodes.reserve(2047);
        tree->value.reserve(2047 * n_classes);
        BestSplitter splitter(criterion == 1 ? ENTROPY : GINI, n_classes, max_features, min_samples_leaf,
                              min_weight_leaf, rand_r_state);
        build(*tree, splitter, X, n_rows, n_cols, y, sample_weight, min_samples_split, min_samples_leaf,
              min_weight_leaf, max_depth, min_impurity_decrease);
        *node_count = (intp_t) tree->nodes.size();
        *max_depth_seen = tree->max_depth;
        return tree.release();
    } catch (const std::bad_alloc &) {
        return nullptr;
    }
}

/* Copy the tree's node arrays (node_count entries each) and its values
 * (node_count x n_classes) out. */
void vitae_tree_copy(const void *handle, intp_t *children_left, intp_t *children_right, intp_t *feature,
                     double *threshold, double *impurity, intp_t *n_node_samples, double *weighted_n_node_samples,
                     uint8_t *missing_go_to_left, double *value)
{
    const Tree *tree = (const Tree *) handle;
    size_t n = tree->nodes.size();
    for (size_t i = 0; i < n; i++) {
        const Node &node = tree->nodes[i];
        children_left[i] = node.left_child;
        children_right[i] = node.right_child;
        feature[i] = node.feature;
        threshold[i] = node.threshold;
        impurity[i] = node.impurity;
        n_node_samples[i] = node.n_node_samples;
        weighted_n_node_samples[i] = node.weighted_n_node_samples;
        missing_go_to_left[i] = node.missing_go_to_left;
    }
    memcpy(value, tree->value.data(), n * tree->n_classes * sizeof(double));
}

void vitae_tree_free(void *handle)
{
    delete (Tree *) handle;
}

/* Tree._apply_dense: the leaf each C-ordered float32 row of X reaches */
void vitae_tree_apply(const intp_t *children_left, const intp_t *children_right, const intp_t *feature,
                      const double *threshold, const uint8_t *missing_go_to_left, const float *X, intp_t n_rows,
                      intp_t n_cols, intp_t *out)
{
    for (intp_t i = 0; i < n_rows; i++) {
        intp_t node = 0;
        while (children_left[node] != TREE_LEAF) {
            float x = X[i * n_cols + feature[node]];
            if (isnan(x))
                node = missing_go_to_left[node] ? children_left[node] : children_right[node];
            else if (x <= threshold[node])
                node = children_left[node];
            else
                node = children_right[node];
        }
        out[i] = node;
    }
}

/* simultaneous_sort of float32 values and their indices, for the tests */
void vitae_simultaneous_sort_f32(float *values, intp_t *indices, intp_t n, int use_three_way_partition)
{
    simultaneous_sort(values, indices, n, use_three_way_partition != 0);
}
}

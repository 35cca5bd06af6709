/*
 * The random numbers and the sort of scikit-learn 1.9.0's tree builder:
 *
 * - `our_rand_r` (sklearn/utils/_random.pxd): the 32-bit xorshift
 *   generator, and `rand_int` (sklearn/tree/_utils.pyx), an integer in
 *   [low, high);
 * - `simultaneous_sort` (sklearn/utils/_sorting.pyx): introsort of values
 *   and indices together, with the 3-way partition the dense partitioner
 *   asks for, the 2-way one, insertion sort below 16 elements and the
 *   heapsort fallback past depth 2 * floor(log2(n)).
 *
 * The sort is not stable, and which of two equal values comes first
 * decides the order in which the criterion adds up weights: it is copied
 * step for step, not replaced by std::sort.
 */

#pragma once

#include <math.h>
#include <stdint.h>

namespace vitae_tree {

typedef int64_t intp_t;

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

inline intp_t rand_int(intp_t low, intp_t high, uint32_t *random_state)
{
    return low + our_rand_r(random_state) % (high - low);
}

template <typename T>
inline void swap(T *values, intp_t *indices, intp_t i, intp_t j)
{
    T v = values[i];
    values[i] = values[j];
    values[j] = v;
    intp_t k = indices[i];
    indices[i] = indices[j];
    indices[j] = k;
}

template <typename T>
inline void insertion_sort(T *values, intp_t *indices, intp_t n)
{
    for (intp_t i = 1; i < n; i++) {
        T temp_val = values[i];
        intp_t temp_idx = indices[i];
        intp_t j = i;
        while (j > 0 && values[j - 1] > temp_val) {
            values[j] = values[j - 1];
            indices[j] = indices[j - 1];
            j -= 1;
        }
        values[j] = temp_val;
        indices[j] = temp_idx;
    }
}

template <typename T>
inline void sift_down(T *values, intp_t *samples, intp_t start, intp_t end)
{
    intp_t root = start;
    while (true) {
        intp_t child = root * 2 + 1;
        intp_t maxind = root;
        if (child < end && values[maxind] < values[child])
            maxind = child;
        if (child + 1 < end && values[maxind] < values[child + 1])
            maxind = child + 1;
        if (maxind == root)
            break;
        swap(values, samples, root, maxind);
        root = maxind;
    }
}

template <typename T>
void heapsort(T *values, intp_t *samples, intp_t n)
{
    intp_t start = (n - 2) / 2;
    intp_t end = n;
    while (true) {
        sift_down(values, samples, start, end);
        if (start == 0)
            break;
        start -= 1;
    }
    end = n - 1;
    while (end > 0) {
        swap(values, samples, 0, end);
        sift_down(values, samples, 0, end);
        end = end - 1;
    }
}

/* median of three, moved in place: the smallest to the front, the median
 * (the pivot) to the back, the largest to n / 2 */
template <typename T>
inline T inplace_median3(T *values, intp_t *indices, intp_t n)
{
    intp_t pivot_idx = n / 2;
    if (values[0] > values[n - 1])
        swap(values, indices, 0, n - 1);
    if (values[n - 1] > values[pivot_idx]) {
        swap(values, indices, n - 1, pivot_idx);
        if (values[0] > values[n - 1])
            swap(values, indices, 0, n - 1);
    }
    return values[n - 1];
}

/* median of three after Bentley and McIlroy, nothing moved */
template <typename T>
inline T median3(const T *values, intp_t n)
{
    T a = values[0], b = values[n / 2], c = values[n - 1];
    if (a < b) {
        if (b < c)
            return b;
        else if (a < c)
            return c;
        else
            return a;
    } else if (b < c) {
        if (a < c)
            return a;
        else
            return c;
    } else {
        return b;
    }
}

template <typename T>
void introsort_2way(T *values, intp_t *indices, intp_t n, intp_t maxd)
{
    while (n > 15) {
        if (maxd <= 0) {
            heapsort(values, indices, n);
            return;
        }
        maxd -= 1;
        T pivot = inplace_median3(values, indices, n);
        intp_t i = 1, j = n - 2;
        while (true) {
            while (i <= j && values[i] < pivot)
                i += 1;
            while (i <= j && values[j] > pivot)
                j -= 1;
            if (i >= j)
                break;
            swap(values, indices, i, j);
            i += 1;
            j -= 1;
        }
        intp_t pivot_idx = i;
        swap(values, indices, pivot_idx, n - 1);
        introsort_2way(values, indices, pivot_idx, maxd);
        values += pivot_idx + 1;
        indices += pivot_idx + 1;
        n -= pivot_idx + 1;
    }
    insertion_sort(values, indices, n);
}

template <typename T>
void introsort_3way(T *values, intp_t *indices, intp_t n, intp_t maxd)
{
    while (n > 15) {
        if (maxd <= 0) {
            heapsort(values, indices, n);
            return;
        }
        maxd -= 1;
        T pivot = median3(values, n);
        intp_t i = 0, l = 0, r = n;
        while (i < r) {
            if (values[i] < pivot) {
                swap(values, indices, i, l);
                i += 1;
                l += 1;
            } else if (values[i] > pivot) {
                r -= 1;
                swap(values, indices, i, r);
            } else {
                i += 1;
            }
        }
        /* [0, l) < pivot, [l, r) == pivot, [r, n) > pivot */
        introsort_3way(values, indices, l, maxd);
        values += r;
        indices += r;
        n -= r;
    }
    insertion_sort(values, indices, n);
}

template <typename T>
void simultaneous_sort(T *values, intp_t *indices, intp_t n, bool use_three_way_partition)
{
    if (n == 0)
        return;
    intp_t maxd = 2 * (intp_t) log2((double) n);
    if (use_three_way_partition)
        introsort_3way(values, indices, n, maxd);
    else
        introsort_2way(values, indices, n, maxd);
}

}  // namespace vitae_tree

/* Inline vector math on cwipc_vector.
 *
 * Parity with the reference's vector header (reference:
 * include/cwipc_util/vectors.h:5-61), INCLUDING its documented quirk:
 * cwipc_len_vector returns the SQUARED length and cwipc_norm_vector
 * divides by that squared length (vectors.h:25-27, 39-47).  Correct
 * Euclidean helpers are provided under unambiguous names.
 */

#ifndef CWIPC_UTIL_JAX_VECTORS_H
#define CWIPC_UTIL_JAX_VECTORS_H

#include <math.h>
#include "cwipc_capi.h"

#ifdef __cplusplus
extern "C" {
#endif

static inline struct cwipc_vector cwipc_add_vectors(struct cwipc_vector a,
                                                    struct cwipc_vector b) {
    struct cwipc_vector r = {a.x + b.x, a.y + b.y, a.z + b.z};
    return r;
}

static inline struct cwipc_vector cwipc_diff_vectors(struct cwipc_vector a,
                                                     struct cwipc_vector b) {
    struct cwipc_vector r = {a.x - b.x, a.y - b.y, a.z - b.z};
    return r;
}

static inline struct cwipc_vector cwipc_mult_vector(double f,
                                                    struct cwipc_vector a) {
    struct cwipc_vector r = {f * a.x, f * a.y, f * a.z};
    return r;
}

/* QUIRK (reference parity): returns the SQUARED length. */
static inline double cwipc_len_vector(struct cwipc_vector a) {
    return a.x * a.x + a.y * a.y + a.z * a.z;
}

/* QUIRK (reference parity): divides by the squared length. */
static inline struct cwipc_vector cwipc_norm_vector(struct cwipc_vector a) {
    double l = cwipc_len_vector(a);
    if (l == 0) return a;
    return cwipc_mult_vector(1.0 / l, a);
}

static inline double cwipc_dot_vectors(struct cwipc_vector a,
                                       struct cwipc_vector b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

static inline struct cwipc_vector cwipc_cross_vectors(struct cwipc_vector a,
                                                      struct cwipc_vector b) {
    struct cwipc_vector r = {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                             a.x * b.y - a.y * b.x};
    return r;
}

/* unambiguous Euclidean versions */
static inline double cwipc_euclidean_length(struct cwipc_vector a) {
    return sqrt(cwipc_len_vector(a));
}

static inline struct cwipc_vector cwipc_unit_vector(struct cwipc_vector a) {
    double l = cwipc_euclidean_length(a);
    if (l == 0) return a;
    return cwipc_mult_vector(1.0 / l, a);
}

#ifdef __cplusplus
}
#endif

#endif /* CWIPC_UTIL_JAX_VECTORS_H */

/* Fused assignment kernel for the degraded-mode CPU bin-pack.
 *
 * reference: none (the reference stubs the whole producer,
 * pkg/metrics/producers/pendingcapacity/producer.go:29-31). This is the
 * native half of ops/numpy_binpack.py: feasibility + first-feasible (or
 * preference-argmax) assignment + dominant-share bucketing + all
 * post-assignment aggregates, in ONE row-major pass with per-pod early
 * exit. The dense formulations (XLA for the MXU, numpy BLAS for the CPU
 * fallback) always touch every (pod, group) pair; a scalar scan stops at
 * the first feasible group when no preference scores steer, which is the
 * common case and makes the pass nearly O(P) on realistic inputs.
 *
 * Semantics contract (pinned by tests/test_numpy_binpack.py):
 *  - feasibility: resource fit (req <= alloc, all R), group has any
 *    allocatable, no intolerated taint (packed uint64 words), no missing
 *    required label, not forbidden, pod valid — identical boolean
 *    outcome to ops/binpack._feasibility;
 *  - choice: first feasible group, or among feasible the highest score
 *    with lowest-index tie-break (argmax semantics);
 *  - share/bucket: float32 arithmetic in the same operation order as
 *    _dominant_share, bucket = clamp(ceilf(share * B), 1, B);
 *  - demand: float64 accumulation in pod order (bitwise-identical to the
 *    numpy np.add.at path).
 *
 * The per-pod CHOICE exists exactly once (karpenter_choose_pod): the
 * fused single pass and the threaded variant both call it, so the four
 * scan shapes (fast/generic x fused/threaded) can never drift apart.
 *
 * Plain C + ctypes (no CPython API): the loader compiles it on demand
 * and callers fall back to the numpy path when no toolchain exists.
 */

#include <math.h>
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

/* Shelf best-fit-decreasing over bucket histograms: the exact semantics
 * of ops/binpack._shelf_bfd / oracle_shelf_bfd (repeated passes of
 * "every open bin with sufficient remaining capacity takes one item,
 * smallest remaining first"; leftovers open fresh bins). The data is
 * tiny ([T, B+1] state) — this exists because the vectorized numpy form
 * costs ~1000 array-op dispatches of pure interpreter overhead per
 * solve, which dominates the degraded tick once assignment is native. */
void karpenter_shelf_bfd(
    long long n_groups,
    long long buckets,
    const long long *histogram, /* [T, B] */
    long long *total            /* out [T], zeroed by caller */
) {
    for (long long t = 0; t < n_groups; t++) {
        long long bins[buckets + 1]; /* count by remaining capacity */
        for (long long i = 0; i <= buckets; i++) {
            bins[i] = 0;
        }
        for (long long k = buckets; k >= 1; k--) {
            long long c = histogram[t * buckets + (k - 1)];
            while (c > 0) {
                int placed = 0;
                for (long long rem = k; rem <= buckets && c > 0; rem++) {
                    long long m = bins[rem] < c ? bins[rem] : c;
                    if (m > 0) {
                        bins[rem] -= m;
                        bins[rem - k] += m;
                        c -= m;
                        placed = 1;
                    }
                }
                if (!placed) {
                    break;
                }
            }
            if (c > 0) {
                long long per_bin = buckets / k;
                long long full = c / per_bin;
                long long leftover = c - full * per_bin;
                total[t] += full + (leftover > 0 ? 1 : 0);
                bins[buckets - per_bin * k] += full;
                if (leftover > 0) {
                    bins[buckets - leftover * k] += 1;
                }
            }
        }
    }
}

/* ---------------------------------------------------------------------
 * Per-pod choice — the ONE implementation of feasibility + selection.
 * ------------------------------------------------------------------ */

/* read-only operands of one solve, shared by every scan shape */
typedef struct {
    long long n_groups, n_resources, taint_words, label_words, buckets;
    const float *requests;          /* [P, R] */
    const unsigned char *valid;     /* [P] */
    const uint64_t *intolerant;     /* [P, KW] */
    const uint64_t *required;       /* [P, LW] */
    const float *alloc;             /* [T, R] */
    const uint64_t *taints;         /* [T, KW] */
    const uint64_t *missing;        /* [T, LW] (~labels, packed) */
    const unsigned char *forbidden; /* [P, T] or NULL */
    const float *score;             /* [P, T] or NULL */
    const unsigned char *usable;    /* [T] or NULL: fast shape applies */
} karpenter_scan;

/* Fast shape (usable != NULL): no steering scores, no forbidden mask,
 * both bitsets within one 64-bit word (any fleet with <= 64 distinct
 * hard taints and <= 64 label items — the bench shape and most
 * production fleets). The pod's two words load once, the per-group
 * checks collapse to one OR of two ANDs, and the resource fit runs
 * branch-free (R is small; `&=` lets the compiler unroll instead of
 * predicting a break). Choice semantics are IDENTICAL to the generic
 * scan: first feasible group wins. */
static inline long long karpenter_choose_pod_fast(
    const karpenter_scan *S, long long p
) {
    const float *req = S->requests + p * S->n_resources;
    const uint64_t iw = S->intolerant[p];
    const uint64_t nw = S->required[p];
    for (long long t = 0; t < S->n_groups; t++) {
        if (!S->usable[t]) {
            continue;
        }
        const float *a = S->alloc + t * S->n_resources;
        int fit = 1;
        for (long long r = 0; r < S->n_resources; r++) {
            fit &= (req[r] <= a[r]);
        }
        if (!fit || ((iw & S->taints[t]) | (nw & S->missing[t]))) {
            continue;
        }
        return t;
    }
    return -1;
}

/* Generic shape: multi-word bitsets, optional forbidden mask, optional
 * score argmax (which disables the first-feasible early exit — the
 * dense case, where the per-pod `a[r] > 0` probes measurably beat a
 * hoisted usability mask's extra load+branch per (pod, group) pair). */
static inline long long karpenter_choose_pod_generic(
    const karpenter_scan *S, long long p
) {
    const float *req = S->requests + p * S->n_resources;
    const uint64_t *intol = S->intolerant + p * S->taint_words;
    const uint64_t *need = S->required + p * S->label_words;
    long long best = -1;
    float best_score = 0.0f;
    for (long long t = 0; t < S->n_groups; t++) {
        if (S->forbidden && S->forbidden[p * S->n_groups + t]) {
            continue;
        }
        const float *a = S->alloc + t * S->n_resources;
        int ok = 0;
        for (long long r = 0; r < S->n_resources; r++) {
            if (req[r] > a[r]) {
                ok = -1;
                break;
            }
            if (a[r] > 0.0f) {
                ok = 1; /* group has SOME allocatable */
            }
        }
        if (ok != 1) {
            continue;
        }
        const uint64_t *tw = S->taints + t * S->taint_words;
        int violated = 0;
        for (long long w = 0; w < S->taint_words; w++) {
            if (intol[w] & tw[w]) {
                violated = 1;
                break;
            }
        }
        if (violated) {
            continue;
        }
        const uint64_t *mw = S->missing + t * S->label_words;
        for (long long w = 0; w < S->label_words; w++) {
            if (need[w] & mw[w]) {
                violated = 1;
                break;
            }
        }
        if (violated) {
            continue;
        }
        if (S->score == NULL) {
            return t; /* first feasible wins */
        }
        float s = S->score[p * S->n_groups + t];
        if (best < 0 || s > best_score) {
            best = t;
            best_score = s;
        }
    }
    return best;
}

static inline long long karpenter_choose_pod(
    const karpenter_scan *S, long long p
) {
    return S->usable ? karpenter_choose_pod_fast(S, p)
                     : karpenter_choose_pod_generic(S, p);
}

/* Group usability (any allocatable > 0), precomputed once for the FAST
 * shape only: its first-feasible scan gains from skipping dead groups
 * before the fit check; the generic dense scan keeps its per-pod probes
 * and never pays for the precompute. NULL = fast shape not applicable
 * (or allocation pressure: the generic scan is always correct). */
static unsigned char *karpenter_usable_mask(
    long long n_groups, long long n_resources, long long taint_words,
    long long label_words, const float *alloc,
    const unsigned char *forbidden, const float *score
) {
    if (score != NULL || forbidden != NULL || taint_words != 1
        || label_words != 1) {
        return NULL;
    }
    unsigned char *usable = (unsigned char *)malloc((size_t)n_groups);
    if (usable == NULL) {
        return NULL;
    }
    for (long long t = 0; t < n_groups; t++) {
        unsigned char any = 0;
        const float *a = alloc + t * n_resources;
        for (long long r = 0; r < n_resources; r++) {
            any |= (a[r] > 0.0f);
        }
        usable[t] = any;
    }
    return usable;
}

/* Dominant-share bucket of one assigned pod: same f32 formula/order as
 * _dominant_share; feasibility guarantees req <= alloc, so share stays
 * in [0, 1]. ONE implementation — the fused record and the threaded
 * choice phase both call it, so buckets are identical by
 * construction. */
static inline long long karpenter_pod_bucket(
    const float *req, const float *a, long long n_resources,
    long long buckets
) {
    float share = 0.0f;
    for (long long r = 0; r < n_resources; r++) {
        float s;
        if (a[r] > 0.0f) {
            float denom = a[r] > 1e-30f ? a[r] : 1e-30f;
            s = req[r] / denom;
        } else {
            s = (req[r] <= 0.0f) ? 0.0f : INFINITY;
        }
        if (s > share) {
            share = s;
        }
    }
    long long bucket = (long long)ceilf(share * (float)buckets);
    if (bucket < 1) {
        bucket = 1;
    }
    if (bucket > buckets) {
        bucket = buckets;
    }
    return bucket;
}

/* Post-choice accounting for one assigned pod: count, dominant-share
 * bucket, histogram, f64 demand. */
static inline void karpenter_assign_record(
    long long p, long long best, long long n_resources, long long buckets,
    const float *req, const float *a, const long long *weight,
    const unsigned char *exclusive, int32_t *assigned,
    long long *assigned_count, long long *histogram, double *demand
) {
    assigned[p] = (int32_t)best;
    long long w_of = weight ? weight[p] : 1;
    assigned_count[best] += w_of;
    long long bucket = karpenter_pod_bucket(req, a, n_resources, buckets);
    for (long long r = 0; r < n_resources; r++) {
        demand[best * n_resources + r] += (double)req[r] * (double)w_of;
    }
    if (exclusive && exclusive[p]) {
        /* hostname self-anti-affinity: the pod takes a whole node */
        bucket = buckets;
    }
    histogram[best * buckets + (bucket - 1)] += w_of;
}

void karpenter_assign(
    long long n_pods,
    long long n_groups,
    long long n_resources,
    long long taint_words,
    long long label_words,
    long long buckets,
    const float *requests,          /* [P, R] */
    const unsigned char *valid,     /* [P] */
    const uint64_t *intolerant,     /* [P, KW] */
    const uint64_t *required,       /* [P, LW] */
    const float *alloc,             /* [T, R] */
    const uint64_t *taints,         /* [T, KW] */
    const uint64_t *missing,        /* [T, LW] (~labels, packed) */
    const unsigned char *forbidden, /* [P, T] or NULL */
    const float *score,             /* [P, T] or NULL */
    const long long *weight,        /* [P] or NULL */
    const unsigned char *exclusive, /* [P] or NULL: bucket forced to B */
    int32_t *assigned,              /* out [P] */
    long long *assigned_count,      /* out [T], zeroed by caller */
    long long *histogram,           /* out [T, B], zeroed by caller */
    double *demand,                 /* out [T, R], zeroed by caller */
    long long *unschedulable        /* out [1], zeroed by caller */
) {
    karpenter_scan S = {
        .n_groups = n_groups, .n_resources = n_resources,
        .taint_words = taint_words, .label_words = label_words,
        .buckets = buckets,
        .requests = requests, .valid = valid,
        .intolerant = intolerant, .required = required,
        .alloc = alloc, .taints = taints, .missing = missing,
        .forbidden = forbidden, .score = score,
        .usable = karpenter_usable_mask(
            n_groups, n_resources, taint_words, label_words, alloc,
            forbidden, score),
    };
    for (long long p = 0; p < n_pods; p++) {
        assigned[p] = -1;
        if (!valid[p]) {
            continue;
        }
        long long best = karpenter_choose_pod(&S, p);
        if (best < 0) {
            *unschedulable += (weight ? weight[p] : 1);
            continue;
        }
        karpenter_assign_record(
            p, best, n_resources, buckets, requests + p * n_resources,
            alloc + best * n_resources, weight, exclusive, assigned,
            assigned_count, histogram, demand);
    }
    free((void *)S.usable);
}

/* ---------------------------------------------------------------------
 * Multithreaded assignment: the CHOICE phase (per-pod, pure — no shared
 * writes except each pod's own assigned/bucket slot) fans out across
 * threads; every aggregate (count, histogram, f64 demand, unschedulable)
 * is then accumulated in ONE sequential pod-order pass, so outputs are
 * bitwise identical to karpenter_assign and to the numpy oracle —
 * float addition order never depends on the thread count. The speedup
 * is deliberately UNCLAIMED; the identity is what the tests pin.
 * ------------------------------------------------------------------ */

typedef struct {
    const karpenter_scan *scan;
    long long lo, hi;
    int32_t *assigned;
    int32_t *bucket;
} karpenter_choose_task;

static void *karpenter_choose_thread(void *arg) {
    const karpenter_choose_task *T = (const karpenter_choose_task *)arg;
    const karpenter_scan *S = T->scan;
    for (long long p = T->lo; p < T->hi; p++) {
        T->assigned[p] = -1;
        T->bucket[p] = 0;
        if (!S->valid[p]) {
            continue;
        }
        long long best = karpenter_choose_pod(S, p);
        if (best >= 0) {
            T->assigned[p] = (int32_t)best;
            T->bucket[p] = (int32_t)karpenter_pod_bucket(
                S->requests + p * S->n_resources,
                S->alloc + best * S->n_resources, S->n_resources,
                S->buckets);
        }
    }
    return NULL;
}

#define KARPENTER_MAX_THREADS 64

void karpenter_assign_mt(
    long long n_pods,
    long long n_groups,
    long long n_resources,
    long long taint_words,
    long long label_words,
    long long buckets,
    const float *requests,
    const unsigned char *valid,
    const uint64_t *intolerant,
    const uint64_t *required,
    const float *alloc,
    const uint64_t *taints,
    const uint64_t *missing,
    const unsigned char *forbidden,
    const float *score,
    const long long *weight,
    const unsigned char *exclusive,
    int32_t *assigned,
    long long *assigned_count,
    long long *histogram,
    double *demand,
    long long *unschedulable,
    long long n_threads
) {
    int32_t *bucket = (int32_t *)malloc((size_t)(n_pods ? n_pods : 1)
                                        * sizeof(int32_t));
    if (bucket == NULL) {
        /* allocation pressure: fall back to the fused single pass */
        karpenter_assign(
            n_pods, n_groups, n_resources, taint_words, label_words,
            buckets, requests, valid, intolerant, required, alloc, taints,
            missing, forbidden, score, weight, exclusive, assigned,
            assigned_count, histogram, demand, unschedulable);
        return;
    }
    karpenter_scan S = {
        .n_groups = n_groups, .n_resources = n_resources,
        .taint_words = taint_words, .label_words = label_words,
        .buckets = buckets,
        .requests = requests, .valid = valid,
        .intolerant = intolerant, .required = required,
        .alloc = alloc, .taints = taints, .missing = missing,
        .forbidden = forbidden, .score = score,
        .usable = karpenter_usable_mask(
            n_groups, n_resources, taint_words, label_words, alloc,
            forbidden, score),
    };

    if (n_threads < 1) {
        n_threads = 1;
    }
    if (n_threads > KARPENTER_MAX_THREADS) {
        n_threads = KARPENTER_MAX_THREADS;
    }
    if (n_threads > n_pods) {
        n_threads = n_pods ? n_pods : 1;
    }
    karpenter_choose_task tasks[KARPENTER_MAX_THREADS];
    pthread_t tids[KARPENTER_MAX_THREADS];
    long long chunk = (n_pods + n_threads - 1) / n_threads;
    long long spawned = 0;
    for (long long i = 0; i < n_threads; i++) {
        long long lo = i * chunk;
        long long hi = lo + chunk < n_pods ? lo + chunk : n_pods;
        if (lo >= hi) {
            break;
        }
        tasks[i] = (karpenter_choose_task){
            .scan = &S, .lo = lo, .hi = hi,
            .assigned = assigned, .bucket = bucket,
        };
        if (i == n_threads - 1
            || pthread_create(&tids[spawned], NULL,
                              karpenter_choose_thread, &tasks[i]) != 0) {
            /* last chunk (and any failed spawn) runs inline */
            karpenter_choose_thread(&tasks[i]);
        } else {
            spawned++;
        }
    }
    for (long long i = 0; i < spawned; i++) {
        pthread_join(tids[i], NULL);
    }

    /* sequential pod-order accumulation: identical addition order to the
     * fused pass and the numpy oracle, whatever n_threads was */
    for (long long p = 0; p < n_pods; p++) {
        long long best = assigned[p];
        if (best < 0) {
            if (valid[p]) {
                *unschedulable += (weight ? weight[p] : 1);
            }
            continue;
        }
        long long w_of = weight ? weight[p] : 1;
        assigned_count[best] += w_of;
        const float *req = requests + p * n_resources;
        for (long long r = 0; r < n_resources; r++) {
            demand[best * n_resources + r] += (double)req[r] * (double)w_of;
        }
        long long b = bucket[p];
        if (exclusive && exclusive[p]) {
            b = buckets;
        }
        histogram[best * buckets + (b - 1)] += w_of;
    }
    free(bucket);
    free((void *)S.usable);
}

/* bool[N, K] row-major (as uint8) -> uint64[N, W] little-endian bit
 * words — the taint/label operand packer. numpy's packbits pays
 * per-row overhead on narrow matrices and a full 64-column bool pad on
 * wide ones (the pack was most of the degraded-mode solve); one
 * scalar pass is memory-bound and shape-indifferent. */
void karpenter_pack_bits(
    long long n, long long k, long long words,
    const unsigned char *matrix, unsigned long long *out
) {
    /* 8 bools at a time: bytes are 0/1 (the caller feeds numpy bool
     * storage), and for a uint64 of 0/1 bytes the multiply by
     * 0x0102040810204080 gathers byte i into bit 56+i (all cross terms
     * land outside bits 56..63 or overflow away) — one load + multiply
     * + shift packs a byte octet. Each output word accumulates in a
     * register across its 8 octets before one store. */
    const unsigned long long GATHER = 0x0102040810204080ull;
    for (long long i = 0; i < n; i++) {
        const unsigned char *row = matrix + i * k;
        unsigned long long *orow = out + i * words;
        long long j = 0;
        for (long long w = 0; w < words; w++) {
            unsigned long long word = 0ull;
            long long hi = (w + 1) * 64 < k ? (w + 1) * 64 : k;
            for (; j + 8 <= hi; j += 8) {
                unsigned long long chunk;
                __builtin_memcpy(&chunk, row + j, 8);
                word |= ((chunk * GATHER) >> 56) << (unsigned)(j & 63);
            }
            for (; j < hi; j++) {
                if (row[j]) {
                    word |= 1ull << (unsigned)(j & 63);
                }
            }
            orow[w] = word;
        }
    }
}

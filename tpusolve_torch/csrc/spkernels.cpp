// spkernels — native sparse setup kernels for the AMG/ILU setup phase.
//
// The reference delegates its AMG setup (strength -> coarsen -> interp ->
// Galerkin RAP) to HYPRE's native C implementation inside
// HYPRE_BoomerAMGSetup (driven at src/HypreSystem.cpp:692); the TPU rebuild
// keeps setup on the host (cycling runs on device) and uses these kernels
// for the two operations that dominate it:
//
//  * masked A.B^T products (SDDMM): interpolation weights need
//    d_ik = sum_m A[i,m] B[k,m] only at a fixed sparse pattern — computing
//    the full distance-2 product and then restricting it (the scipy
//    formulation) materializes ~nnz * row_width intermediate entries and
//    dominated setup profiles.
//  * CSR SpGEMM (Gustavson, two-pass): A@P and P^T@(AP) for the Galerkin
//    triple product.
//
// All row-loop kernels are THREAD-PARALLEL: rows are handed out in dynamic
// chunks (atomic cursor), each worker owns its stamped-accumulator scratch.
// Thread count: TPUSOLVE_NATIVE_THREADS env (default: hardware
// concurrency), clamped so per-thread scratch stays bounded.  The
// single-core build VM runs nt=1 and takes the exact serial path; real
// multi-core hosts parallelize the setup the way HYPRE's OpenMP build does
// (the reference's host hypre builds enable OpenMP for the same loops,
// etc/summitdev/build-omp.sh:13).
//
// Pure C++17, no dependencies; int32 indices/indptr (nnz < 2^31 — matches
// scipy's automatic index width below that bound), float64 values.
// Compiled on demand by tpusolve/native/build.py; NumPy/scipy fallbacks
// remain in the callers.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using i32 = int32_t;
using i64 = int64_t;

namespace {

int env_threads(bool* explicit_set = nullptr) {
    const char* e = std::getenv("TPUSOLVE_NATIVE_THREADS");
    if (e && *e) {
        const int v = std::atoi(e);
        if (v >= 1) {
            if (explicit_set) *explicit_set = true;
            return v;
        }
    }
    if (explicit_set) *explicit_set = false;
    const unsigned hc = std::thread::hardware_concurrency();
    return hc ? static_cast<int>(hc) : 1;
}

// Run body(lo, hi) over [0, n) in dynamic chunks across threads.  Each
// worker thread calls ``make_ctx()`` once to build its private scratch and
// passes it to body(ctx, lo, hi).  ``scratch_bytes`` is the per-thread
// scratch estimate: the thread count is clamped so the total stays under
// ~4 GB (protects hosts running near the memory ceiling on 100M-row
// setups).
template <typename MakeCtx, typename Body>
void parallel_rows(i64 n, i64 scratch_bytes, MakeCtx make_ctx, Body body) {
    bool forced = false;
    int nt = env_threads(&forced);
    if (scratch_bytes > 0) {
        const i64 cap = std::max<i64>(1, (i64)4e9 / scratch_bytes);
        nt = static_cast<int>(std::min<i64>(nt, cap));
    }
    // tiny inputs: thread-spawn overhead dominates — stay serial unless the
    // caller explicitly forced a thread count (tests exercise this)
    if (nt <= 1 || (n < 4096 && !forced)) {
        auto ctx = make_ctx();
        body(ctx, (i64)0, n);
        return;
    }
    const i64 grain = std::max<i64>(256, n / ((i64)nt * 16));
    std::atomic<i64> cursor(0);
    auto work = [&]() {
        auto ctx = make_ctx();
        for (;;) {
            const i64 lo = cursor.fetch_add(grain);
            if (lo >= n) break;
            body(ctx, lo, std::min(lo + grain, n));
        }
    };
    std::vector<std::thread> ts;
    ts.reserve(nt - 1);
    for (int t = 1; t < nt; ++t) ts.emplace_back(work);
    work();
    for (auto& th : ts) th.join();
}

struct NoCtx {};
inline NoCtx no_ctx() { return NoCtx{}; }

}  // namespace

extern "C" {

// Exposed for tests/diagnostics: the effective thread count.
i32 sk_nthreads() { return env_threads(); }

// out[e] = sum_m A[i,m] * B[k,m]  for each pattern entry e: row i, col k of
// (Pp, Pj).  A is (n x m), B is (nk x m) — rows of A dotted with rows of B.
// Dense stamped accumulator over A's row, then one pass over each B row.
// out entries for row i live at Pp[i]..Pp[i+1] (row-parallel).
void sk_masked_abt(i32 n, i32 m,
                   const i32* Ap, const i32* Aj, const double* Ax,
                   const i32* Bp, const i32* Bj, const double* Bx,
                   const i32* Pp, const i32* Pj, double* out) {
    struct Ctx {
        std::vector<double> acc;
        std::vector<i32> stamp;
    };
    parallel_rows(
        (i64)n, (i64)m * 12,
        [&]() {
            return Ctx{std::vector<double>((size_t)m, 0.0),
                       std::vector<i32>((size_t)m, -1)};
        },
        [&](Ctx& c, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                if (Pp[i] == Pp[i + 1]) continue;
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    c.acc[Aj[t]] = Ax[t];
                    c.stamp[Aj[t]] = (i32)i;
                }
                for (i32 p = Pp[i]; p < Pp[i + 1]; ++p) {
                    const i32 k = Pj[p];
                    double s = 0.0;
                    for (i32 t = Bp[k]; t < Bp[k + 1]; ++t) {
                        const i32 col = Bj[t];
                        if (c.stamp[col] == (i32)i) s += c.acc[col] * Bx[t];
                    }
                    out[p] = s;
                }
            }
        });
}

// Symbolic SpGEMM: fills Cp (size n+1) with the row pointer of C = A@B.
// Returns nnz(C).  A: (n x k), B: (k x m).  Parallel per-row counts into
// Cp[i+1], then a serial prefix sum.
i64 sk_spgemm_count(i32 n, i32 m,
                    const i32* Ap, const i32* Aj,
                    const i32* Bp, const i32* Bj,
                    i32* Cp) {
    parallel_rows(
        (i64)n, (i64)m * 4,
        [&]() { return std::vector<i32>((size_t)m, -1); },
        [&](std::vector<i32>& stamp, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                i32 row = 0;
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    const i32 j = Aj[t];
                    for (i32 u = Bp[j]; u < Bp[j + 1]; ++u) {
                        const i32 col = Bj[u];
                        if (stamp[col] != (i32)i) {
                            stamp[col] = (i32)i;
                            ++row;
                        }
                    }
                }
                Cp[i + 1] = row;
            }
        });
    i64 nnz = 0;
    Cp[0] = 0;
    for (i32 i = 0; i < n; ++i) {
        nnz += Cp[i + 1];
        Cp[i + 1] = static_cast<i32>(nnz);
    }
    return nnz;
}

// Numeric SpGEMM with precomputed Cp: fills Cj/Cx; each row's columns are
// emitted sorted ascending (downstream code key-sorts rows).
void sk_spgemm(i32 n, i32 m,
               const i32* Ap, const i32* Aj, const double* Ax,
               const i32* Bp, const i32* Bj, const double* Bx,
               const i32* Cp, i32* Cj, double* Cx) {
    struct Ctx {
        std::vector<double> acc;
        std::vector<i32> stamp;
        std::vector<i32> cols;
    };
    parallel_rows(
        (i64)n, (i64)m * 12,
        [&]() {
            Ctx c{std::vector<double>((size_t)m, 0.0),
                  std::vector<i32>((size_t)m, -1), {}};
            c.cols.reserve(256);
            return c;
        },
        [&](Ctx& c, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                c.cols.clear();
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    const i32 j = Aj[t];
                    const double a = Ax[t];
                    for (i32 u = Bp[j]; u < Bp[j + 1]; ++u) {
                        const i32 col = Bj[u];
                        if (c.stamp[col] != (i32)i) {
                            c.stamp[col] = (i32)i;
                            c.acc[col] = a * Bx[u];
                            c.cols.push_back(col);
                        } else {
                            c.acc[col] += a * Bx[u];
                        }
                    }
                }
                std::sort(c.cols.begin(), c.cols.end());
                i32 w = Cp[i];
                for (const i32 col : c.cols) {
                    Cj[w] = col;
                    Cx[w] = c.acc[col];
                    ++w;
                }
            }
        });
}

// out[e] = sum_k X[i,k] * B[k,j]  for each pattern entry e: row i, col j of
// (Pp, Pj) — the A@B form of the sampled product (no transpose needed).
// Per row: stamp the pattern columns with their output slots, then stream
// X's row and each touched B row once.
void sk_masked_ab(i32 n, i32 m,
                  const i32* Xp, const i32* Xj, const double* Xx,
                  const i32* Bp, const i32* Bj, const double* Bx,
                  const i32* Pp, const i32* Pj, double* out) {
    struct Ctx {
        std::vector<i32> slot;
        std::vector<i32> stamp;
    };
    parallel_rows(
        (i64)n, (i64)m * 8,
        [&]() {
            return Ctx{std::vector<i32>((size_t)m, 0),
                       std::vector<i32>((size_t)m, -1)};
        },
        [&](Ctx& c, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                if (Pp[i] == Pp[i + 1]) continue;
                for (i32 e = Pp[i]; e < Pp[i + 1]; ++e) {
                    c.slot[Pj[e]] = e;
                    c.stamp[Pj[e]] = (i32)i;
                    out[e] = 0.0;
                }
                for (i32 t = Xp[i]; t < Xp[i + 1]; ++t) {
                    const i32 k = Xj[t];
                    const double xv = Xx[t];
                    for (i32 u = Bp[k]; u < Bp[k + 1]; ++u) {
                        const i32 col = Bj[u];
                        if (c.stamp[col] == (i32)i)
                            out[c.slot[col]] += xv * Bx[u];
                    }
                }
            }
        });
}

// out[e] = B[j, i] for each pattern entry e: row i, col j of (Pp, Pj) —
// a sampled transpose (B's rows are sorted: binary search).
void sk_sampled_at(i32 n,
                   const i32* Bp, const i32* Bj, const double* Bx,
                   const i32* Pp, const i32* Pj, double* out) {
    parallel_rows(
        (i64)n, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                for (i32 e = Pp[i]; e < Pp[i + 1]; ++e) {
                    const i32 j = Pj[e];
                    const i32* lob = Bj + Bp[j];
                    const i32* hib = Bj + Bp[j + 1];
                    const i32* it = std::lower_bound(lob, hib, (i32)i);
                    out[e] = (it != hib && *it == (i32)i)
                                 ? Bx[Bp[j] + (it - lob)]
                                 : 0.0;
                }
            }
        });
}

// Classical Ruge-Stueben C/F splitting (first + second pass) — the serial
// algorithm behind the reference's default coarsen_type 6 (Falgout = RS in
// the interior; single-process runs are pure RS).  S is the strength CSR
// (S[i,j] = 1 iff j strongly influences i), St its transpose (St[i,j] = 1
// iff i strongly influences j).  state out: 1 = C, 0 = F.
// Bucket priority queue over lambda = |St_i| with increment on F-neighbor
// creation (textbook RS); second pass enforces the F-F common-C condition.
// Inherently sequential (the priority queue IS the algorithm) — runs
// serial by design; PMIS (sk_pmis) is the parallel-coarsening analog.
void sk_rs_coarsen(i32 n,
                   const i32* Sp, const i32* Sj,
                   const i32* Stp, const i32* Stj,
                   i32* state) {
    const i32 UNDECIDED = -1, F = 0, C = 1;
    std::vector<i32> lambda(n);
    i32 lmax = 0;
    for (i32 i = 0; i < n; ++i) {
        lambda[i] = Stp[i + 1] - Stp[i];
        if (lambda[i] > lmax) lmax = lambda[i];
        state[i] = UNDECIDED;
    }
    // bucket queue: head[l] -> doubly-linked list of nodes with lambda l
    const i32 NIL = -1;
    std::vector<i32> head(static_cast<size_t>(lmax) + n + 2, NIL);
    std::vector<i32> nxt(n, NIL), prv(n, NIL);
    auto bucket_remove = [&](i32 i) {
        if (prv[i] != NIL) nxt[prv[i]] = nxt[i];
        else head[lambda[i]] = nxt[i];
        if (nxt[i] != NIL) prv[nxt[i]] = prv[i];
        nxt[i] = prv[i] = NIL;
    };
    auto bucket_push = [&](i32 i) {
        i32 l = lambda[i];
        prv[i] = NIL;
        nxt[i] = head[l];
        if (head[l] != NIL) prv[head[l]] = i;
        head[l] = i;
    };
    for (i32 i = 0; i < n; ++i) {
        if (lambda[i] == 0) state[i] = F;  // influences nothing
        else bucket_push(i);
    }
    i32 top = lmax;
    i64 remaining = 0;
    for (i32 i = 0; i < n; ++i) if (state[i] == UNDECIDED) ++remaining;
    while (remaining > 0) {
        while (top > 0 && head[top] == NIL) --top;
        if (top <= 0) break;
        const i32 i = head[top];
        bucket_remove(i);
        state[i] = C;
        --remaining;
        // undecided points that i strongly influences become F; their
        // other strong influencers gain priority
        for (i32 t = Stp[i]; t < Stp[i + 1]; ++t) {
            const i32 j = Stj[t];
            if (state[j] != UNDECIDED) continue;
            bucket_remove(j);
            state[j] = F;
            --remaining;
            for (i32 u = Sp[j]; u < Sp[j + 1]; ++u) {
                const i32 k = Sj[u];
                if (state[k] != UNDECIDED) continue;
                bucket_remove(k);
                ++lambda[k];
                if (lambda[k] >= static_cast<i32>(head.size()))
                    head.resize(lambda[k] + 16, NIL);
                bucket_push(k);
                if (lambda[k] > top) top = lambda[k];
            }
        }
    }
    for (i32 i = 0; i < n; ++i)
        if (state[i] == UNDECIDED) state[i] = F;

    // second pass: every strong F-F pair must share a common strong C
    std::vector<i32> mark(n, -1);
    for (i32 i = 0; i < n; ++i) {
        if (state[i] != F) continue;
        for (i32 t = Sp[i]; t < Sp[i + 1]; ++t)   // mark C_i
            if (state[Sj[t]] == C) mark[Sj[t]] = i;
        i32 tentative = -1;
        for (i32 t = Sp[i]; t < Sp[i + 1]; ++t) {
            const i32 j = Sj[t];
            if (state[j] != F || j == i) continue;
            bool common = false;
            for (i32 u = Sp[j]; u < Sp[j + 1]; ++u) {
                const i32 k = Sj[u];
                if (state[k] == C && mark[k] == i) { common = true; break; }
            }
            if (!common) {
                if (tentative >= 0) {
                    // second violation: make i itself C instead
                    state[tentative] = F;
                    state[i] = C;
                    tentative = -1;
                    break;
                }
                tentative = j;
                state[j] = C;
                mark[j] = i;   // j now serves as a common C for i
            }
        }
    }
}

// Classical strength-of-connection pattern:
//   S[i,j] = 1  iff  j != i and -a_ij*sign_i >= theta * max_k(-a_ik*sign_i)
// (sign_i flips for negative diagonals).  Two passes (parallel row counts
// + serial prefix + parallel fill); Sj is written sorted (A's column
// order).  Returns nnz(S).
i64 sk_strength(i64 n, const i32* Ap, const i32* Aj, const double* Ax,
                double theta, i32* Sp, i32* Sj) {
    parallel_rows(
        n, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                double diag = 0.0;
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t)
                    if (Aj[t] == i) { diag = Ax[t]; break; }
                const double sign = (diag < 0.0) ? -1.0 : 1.0;
                double row_max = 0.0;
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    if (Aj[t] == i) continue;
                    const double v = -Ax[t] * sign;
                    if (v > row_max) row_max = v;
                }
                i32 cnt = 0;
                if (row_max > 0.0) {
                    const double thresh = theta * row_max;
                    for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                        if (Aj[t] == i) continue;
                        const double v = -Ax[t] * sign;
                        if (v >= thresh && v > 0.0) ++cnt;
                    }
                }
                Sp[i + 1] = cnt;
            }
        });
    i64 nnz = 0;
    Sp[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        nnz += Sp[i + 1];
        Sp[i + 1] = static_cast<i32>(nnz);
    }
    parallel_rows(
        n, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                if (Sp[i] == Sp[i + 1]) continue;
                double diag = 0.0;
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t)
                    if (Aj[t] == i) { diag = Ax[t]; break; }
                const double sign = (diag < 0.0) ? -1.0 : 1.0;
                double row_max = 0.0;
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    if (Aj[t] == i) continue;
                    const double v = -Ax[t] * sign;
                    if (v > row_max) row_max = v;
                }
                const double thresh = theta * row_max;
                i32 w = Sp[i];
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    if (Aj[t] == i) continue;
                    const double v = -Ax[t] * sign;
                    if (v >= thresh && v > 0.0) Sj[w++] = Aj[t];
                }
            }
        });
    return nnz;
}

// mask[e] = 1 iff A's entry e's (row, col) is present in S's pattern
// (both CSRs row-sorted with sorted columns; two-pointer row merge).
void sk_pattern_mask(i64 n, const i32* Ap, const i32* Aj,
                     const i32* Sp, const i32* Sj, uint8_t* mask) {
    parallel_rows(
        n, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                i32 u = Sp[i];
                const i32 uend = Sp[i + 1];
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    const i32 c = Aj[t];
                    while (u < uend && Sj[u] < c) ++u;
                    mask[t] = (u < uend && Sj[u] == c) ? 1 : 0;
                }
            }
        });
}

// Classical modified interpolation (interp_type 0), whole pass in one
// kernel.  The vectorized-numpy formulation (amg/interp.py) streams ~15
// nnz-sized temporaries through a 1-core host (65 s at 56M nnz); this
// computes P row-by-row with stamped accumulators and no temporaries.
//
//   P_ij = -( a_ij + sum_{k in F_i} a_ik * hat_a_kj / d_ik ) / tilde_a_ii
//   d_ik = sum_{m in C_i} hat_a_km        (hat: sign opposite to a_kk)
//   tilde_a_ii = a_ii + sum_weak + sum_{k in F_i, d_ik = 0} a_ik
//
// A and S must have sorted column indices; S excludes the diagonal.
// P's pattern: F-row i -> its strong-C columns (cmap'd); C-row i -> cmap[i].
// Count pass (fills Pp, returns nnz) — parallel counts + serial prefix:
i64 sk_classical_interp_count(i64 n, const i32* Sp, const i32* Sj,
                              const uint8_t* is_C, i32* Pp) {
    parallel_rows(
        n, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                i32 cnt = 0;
                if (is_C[i]) {
                    cnt = 1;
                } else {
                    for (i32 t = Sp[i]; t < Sp[i + 1]; ++t)
                        if (is_C[Sj[t]]) ++cnt;
                }
                Pp[i + 1] = cnt;
            }
        });
    i64 w = 0;
    Pp[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        w += Pp[i + 1];
        Pp[i + 1] = static_cast<i32>(w);
    }
    return w;
}

namespace {
// shared diag precompute for the interpolation fill passes
std::vector<double> extract_diag(i64 n, const i32* Ap, const i32* Aj,
                                 const double* Ax) {
    std::vector<double> diag((size_t)n, 0.0);
    parallel_rows(
        n, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i)
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t)
                    if (Aj[t] == static_cast<i32>(i)) {
                        diag[i] = Ax[t];
                        break;
                    }
        });
    return diag;
}
}  // namespace

// Fill pass (Pp from the count pass; Pj/Px of size nnz):
void sk_classical_interp_fill(i64 n,
                              const i32* Ap, const i32* Aj, const double* Ax,
                              const i32* Sp, const i32* Sj,
                              const uint8_t* is_C, const i32* cmap,
                              const i32* Pp, i32* Pj, double* Px) {
    const std::vector<double> diag = extract_diag(n, Ap, Aj, Ax);

    struct Ctx {
        std::vector<i64> stamp;
        std::vector<i32> slot;
        std::vector<double> acc;
    };
    parallel_rows(
        n, (i64)n * 20,
        [&]() {
            return Ctx{std::vector<i64>((size_t)n, -1),
                       std::vector<i32>((size_t)n, 0),
                       std::vector<double>((size_t)n, 0.0)};
        },
        [&](Ctx& c, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                i32 w = Pp[i];
                if (is_C[i]) {
                    Pj[w] = cmap[i];
                    Px[w] = 1.0;
                    continue;
                }
                // stamp the strong-C columns -> P slots
                for (i32 t = Sp[i]; t < Sp[i + 1]; ++t) {
                    const i32 j = Sj[t];
                    if (!is_C[j]) continue;
                    c.stamp[j] = i;
                    c.slot[j] = w;
                    c.acc[j] = 0.0;
                    Pj[w++] = cmap[j];
                }
                double dii = diag[i];
                // merge A row with S row (both sorted) to classify entries
                i32 u = Sp[i];
                const i32 uend = Sp[i + 1];
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    const i32 j = Aj[t];
                    if (j == static_cast<i32>(i)) continue;
                    while (u < uend && Sj[u] < j) ++u;
                    const bool strong = (u < uend && Sj[u] == j);
                    const double a = Ax[t];
                    if (!strong) {                  // weak: lump into diag
                        dii += a;
                    } else if (c.stamp[j] == i) {   // strong C: direct term
                        c.acc[j] += a;
                    } else {                        // strong F: dist-2 terms
                        const i32 k = j;
                        const double dk = diag[k];
                        double d_ik = 0.0;
                        for (i32 v = Ap[k]; v < Ap[k + 1]; ++v) {
                            if (c.stamp[Aj[v]] == i && Ax[v] * dk < 0.0)
                                d_ik += Ax[v];
                        }
                        if (d_ik == 0.0) {
                            dii += a;               // dead connection: lump
                        } else {
                            const double s = a / d_ik;
                            for (i32 v = Ap[k]; v < Ap[k + 1]; ++v) {
                                const i32 mcol = Aj[v];
                                if (c.stamp[mcol] == i && Ax[v] * dk < 0.0)
                                    c.acc[mcol] += s * Ax[v];
                            }
                        }
                    }
                }
                if (dii == 0.0) dii = 1.0;
                for (i32 e = Pp[i]; e < w; ++e) Px[e] = 0.0;
                for (i32 t = Sp[i]; t < Sp[i + 1]; ++t) {
                    const i32 j = Sj[t];
                    if (c.stamp[j] == i) Px[c.slot[j]] = -c.acc[j] / dii;
                }
            }
        });
}

// PMIS C/F splitting with caller-supplied tie-break measures w (influence
// count + seeded uniform — the caller keeps RNG compatibility with the
// numpy and device paths).  Exact synchronous-round semantics of
// coarsen.pmis: per round, an active point whose w exceeds every active
// (S U S^T)-neighbor's becomes C; active points strongly influenced by a
// NEW C become F.  Skips decided rows, so round work shrinks with the
// active set (the numpy formulation rescans the full graph every round).
// state out: 1 = C, 0 = F.  Rounds run serially (the round barrier is the
// algorithm's semantics); the transpose build is the only heavy setup.
void sk_pmis(i64 n, const i32* Sp, const i32* Sj, const double* w,
             i32* state) {
    const i32 UNDECIDED = -1, F = 0, C = 1;
    // transpose pattern (counting sort)
    std::vector<i32> Stp(static_cast<size_t>(n) + 1, 0);
    const i64 nnz = Sp[n];
    for (i64 t = 0; t < nnz; ++t) ++Stp[Sj[t] + 1];
    for (i64 i = 0; i < n; ++i) Stp[i + 1] += Stp[i];
    std::vector<i32> Stj(static_cast<size_t>(nnz));
    {
        std::vector<i32> cur(Stp.begin(), Stp.end() - 1);
        for (i64 i = 0; i < n; ++i)
            for (i32 t = Sp[i]; t < Sp[i + 1]; ++t)
                Stj[cur[Sj[t]]++] = static_cast<i32>(i);
    }
    std::vector<i32> active;
    active.reserve(n);
    for (i64 i = 0; i < n; ++i) {
        const bool isolated = (Stp[i + 1] == Stp[i]);
        state[i] = isolated ? F : UNDECIDED;
        if (!isolated) active.push_back(static_cast<i32>(i));
    }
    std::vector<i32> newC;
    std::vector<i32> next;
    while (!active.empty()) {
        newC.clear();
        for (const i32 i : active) {
            const double wi = w[i];
            bool ismax = true;
            for (i32 t = Sp[i]; t < Sp[i + 1] && ismax; ++t) {
                const i32 j = Sj[t];
                if (state[j] == UNDECIDED && w[j] >= wi) ismax = false;
            }
            for (i32 t = Stp[i]; t < Stp[i + 1] && ismax; ++t) {
                const i32 j = Stj[t];
                if (state[j] == UNDECIDED && w[j] >= wi) ismax = false;
            }
            if (ismax) newC.push_back(i);
        }
        if (newC.empty()) break;   // exhausted ties: leftovers -> C below
        for (const i32 i : newC) state[i] = C;
        // active points strongly influenced by a new C become F: walk the
        // new C-points' influence lists (S^T rows) instead of re-scanning
        // every active row
        for (const i32 j : newC)
            for (i32 t = Stp[j]; t < Stp[j + 1]; ++t) {
                const i32 i = Stj[t];
                if (state[i] == UNDECIDED) state[i] = F;
            }
        next.clear();
        for (const i32 i : active)
            if (state[i] == UNDECIDED) next.push_back(i);
        active.swap(next);
    }
    for (i64 i = 0; i < n; ++i)
        if (state[i] == UNDECIDED) state[i] = C;
}

// Extended+i interpolation (interp_type 6/7; De Sterck, Falgout, Nolting,
// Yang 2008) — the distance-2 repair for PMIS coarsenings, one native
// pass (same stamped-accumulator idea as sk_classical_interp_*).
//
//   pattern: Ce_i = strongC(i) U strongC(k) for k in strongF(i)
//   w_ij = -( a_ij|Ce + sum_{k in F_i^s} a_ik hat_a_kj / d_ik ) / tilde_a_ii
//   d_ik = sum_{m in Ce_i} hat_a_km + hat_a_ki              ("+i" term)
//   tilde_a_ii = a_ii + sum_weak + sum_k a_ik hat_a_ki / d_ik (backflow)
//                (+ a_ik where d_ik = 0)
//
// A and S sorted columns, S diagonal-free.  Count pass fills Pp and
// returns nnz — parallel counts (per-thread stamp) + serial prefix:
i64 sk_exti_interp_count(i64 n, const i32* Ap, const i32* Aj,
                         const i32* Sp, const i32* Sj,
                         const uint8_t* is_C, i32* Pp) {
    parallel_rows(
        n, (i64)n * 8,
        [&]() { return std::vector<i64>((size_t)n, -1); },
        [&](std::vector<i64>& stamp, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                i32 cnt = 0;
                if (is_C[i]) {
                    cnt = 1;
                } else {
                    for (i32 t = Sp[i]; t < Sp[i + 1]; ++t) {
                        const i32 j = Sj[t];
                        if (is_C[j]) {
                            if (stamp[j] != i) { stamp[j] = i; ++cnt; }
                        } else {
                            for (i32 u = Sp[j]; u < Sp[j + 1]; ++u) {
                                const i32 m = Sj[u];
                                if (is_C[m] && stamp[m] != i) {
                                    stamp[m] = i;
                                    ++cnt;
                                }
                            }
                        }
                    }
                }
                Pp[i + 1] = cnt;
            }
        });
    i64 w = 0;
    Pp[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        w += Pp[i + 1];
        Pp[i + 1] = static_cast<i32>(w);
    }
    return w;
}

void sk_exti_interp_fill(i64 n,
                         const i32* Ap, const i32* Aj, const double* Ax,
                         const i32* Sp, const i32* Sj,
                         const uint8_t* is_C, const i32* cmap,
                         const i32* Pp, i32* Pj, double* Px) {
    const std::vector<double> diag = extract_diag(n, Ap, Aj, Ax);

    struct Ctx {
        std::vector<i64> stamp;
        std::vector<i32> slot;
        std::vector<double> acc;
        std::vector<i32> ce;
    };

    // hat_a_ki via binary search in row k (sorted columns)
    auto hat_at = [&](i32 k, i32 colq) -> double {
        const i32* lo = Aj + Ap[k];
        const i32* hi = Aj + Ap[k + 1];
        const i32* it = std::lower_bound(lo, hi, colq);
        if (it == hi || *it != colq) return 0.0;
        const double v = Ax[Ap[k] + (it - lo)];
        return (v * diag[k] < 0.0) ? v : 0.0;
    };

    parallel_rows(
        n, (i64)n * 20,
        [&]() {
            Ctx c{std::vector<i64>((size_t)n, -1),
                  std::vector<i32>((size_t)n, 0),
                  std::vector<double>((size_t)n, 0.0), {}};
            c.ce.reserve(256);
            return c;
        },
        [&](Ctx& c, i64 lo, i64 hi) {
            for (i64 i = lo; i < hi; ++i) {
                i32 w = Pp[i];
                if (is_C[i]) {
                    Pj[w] = cmap[i];
                    Px[w] = 1.0;
                    continue;
                }
                // build Ce_i (sorted for a sorted-column P row)
                c.ce.clear();
                for (i32 t = Sp[i]; t < Sp[i + 1]; ++t) {
                    const i32 j = Sj[t];
                    if (is_C[j]) {
                        if (c.stamp[j] != i) {
                            c.stamp[j] = i;
                            c.ce.push_back(j);
                        }
                    } else {
                        for (i32 u = Sp[j]; u < Sp[j + 1]; ++u) {
                            const i32 m = Sj[u];
                            if (is_C[m] && c.stamp[m] != i) {
                                c.stamp[m] = i;
                                c.ce.push_back(m);
                            }
                        }
                    }
                }
                std::sort(c.ce.begin(), c.ce.end());
                for (const i32 m : c.ce) {
                    c.slot[m] = w;
                    c.acc[m] = 0.0;
                    Pj[w++] = cmap[m];
                }
                double dii = diag[i];
                // classify row i's entries: weak -> dii; Ce -> direct term;
                // strong F -> distance-2 terms
                i32 u = Sp[i];
                const i32 uend = Sp[i + 1];
                for (i32 t = Ap[i]; t < Ap[i + 1]; ++t) {
                    const i32 j = Aj[t];
                    if (j == static_cast<i32>(i)) continue;
                    while (u < uend && Sj[u] < j) ++u;
                    const bool strong = (u < uend && Sj[u] == j);
                    const double a = Ax[t];
                    if (!strong) dii += a;          // weak: lump into diag
                    if (c.stamp[j] == i) c.acc[j] += a;  // A restricted: Ce
                    if (strong && !is_C[j]) {       // strong F: distribute
                        const i32 k = j;
                        const double dk = diag[k];
                        const double hki = hat_at(k, static_cast<i32>(i));
                        double d_ik = hki;
                        for (i32 v = Ap[k]; v < Ap[k + 1]; ++v)
                            if (c.stamp[Aj[v]] == i && Ax[v] * dk < 0.0)
                                d_ik += Ax[v];
                        if (d_ik == 0.0) {
                            dii += a;
                        } else {
                            const double s = a / d_ik;
                            for (i32 v = Ap[k]; v < Ap[k + 1]; ++v) {
                                const i32 m = Aj[v];
                                if (c.stamp[m] == i && Ax[v] * dk < 0.0)
                                    c.acc[m] += s * Ax[v];
                            }
                            dii += s * hki;         // k -> i backflow
                        }
                    }
                }
                if (dii == 0.0) dii = 1.0;
                for (const i32 m : c.ce) Px[c.slot[m]] = -c.acc[m] / dii;
            }
        });
}

// Row-major CSR extraction from a dense (rows x ndiag) float32 DIA-value
// table (column j holds diagonal offs[j]) — the stencil generator's
// with_host path.  Two passes (parallel counts + serial prefix + parallel
// fill): at 450M nnz the numpy nonzero detour allocates ~7 GB of int64
// scratch, which is minutes of first-touch page faults on paravirtual
// hosts.
// Returns nnz; fills indptr (rows+1, int64), cols (int64), vals (f64).
i64 sk_dia_to_csr(i64 rows, i32 ndiag,
                  const float* dia_t, const i64* offs,
                  i64* indptr, i64* cols, double* vals) {
    parallel_rows(
        rows, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 r = lo; r < hi; ++r) {
                const float* row = dia_t + r * ndiag;
                i64 cnt = 0;
                for (i32 k = 0; k < ndiag; ++k)
                    if (row[k] != 0.0f) ++cnt;
                indptr[r + 1] = cnt;
            }
        });
    i64 w = 0;
    indptr[0] = 0;
    for (i64 r = 0; r < rows; ++r) {
        w += indptr[r + 1];
        indptr[r + 1] = w;
    }
    parallel_rows(
        rows, 0, no_ctx,
        [&](NoCtx&, i64 lo, i64 hi) {
            for (i64 r = lo; r < hi; ++r) {
                const float* row = dia_t + r * ndiag;
                i64 e = indptr[r];
                for (i32 k = 0; k < ndiag; ++k) {
                    if (row[k] != 0.0f) {
                        cols[e] = r + offs[k];
                        vals[e] = static_cast<double>(row[k]);
                        ++e;
                    }
                }
            }
        });
    return w;
}

}  // extern "C"

// Native host-side point-cloud ops for the bufferx_tpu_torch input pipeline.
//
// The port's own copy of native/bufferx_native.cpp (the JAX package's host
// library), built by bufferx_tpu_torch/native.py into bufferx_tpu_torch/_build/.
// Host counterpart of the reference's cpp_wrappers: voxel-grid barycenter
// subsampling (cpp_subsampling/grid_subsampling.cpp:4-107), batched radius
// neighbors with fixed capacity (cpp_neighbors/neighbors.cpp:4-107), k-NN,
// and FPS. The device path runs these as CUDA kernels and torch operations;
// these C++ versions serve the host input pipeline (ragged clouds,
// file-adjacent preprocessing) where the reference used TBB-parallel C++.
// Parallelism here is plain std::thread chunking; spatial acceleration is a
// flat voxel hash grid instead of a kd-tree (uniform-radius queries only,
// cache-friendly).
//
// C ABI, consumed via ctypes (no pybind11 in the build image).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
    int32_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct CellHash {
    size_t operator()(const CellKey& k) const {
        // 3D spatial hash (large primes; same family the reference's
        // grid_subsampling uses for its index hash)
        return static_cast<size_t>(k.x) * 73856093u ^
               static_cast<size_t>(k.y) * 19349669u ^
               static_cast<size_t>(k.z) * 83492791u;
    }
};

inline int32_t cell_of(float v, float origin, float inv_voxel) {
    return static_cast<int32_t>(std::floor((v - origin) * inv_voxel));
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = std::min<int64_t>(hw ? hw : 4, std::max<int64_t>(n / 1024, 1));
    if (nthreads <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(lo + chunk, n);
        if (lo >= hi) break;
        threads.emplace_back(fn, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// shared voxel hash grid for radius / knn queries
struct HashGrid {
    std::unordered_map<CellKey, std::vector<int32_t>, CellHash> cells;
    float origin[3];
    float inv_voxel;
    float voxel;

    void build(const float* pts, int64_t n, float cell_size) {
        voxel = cell_size;
        inv_voxel = 1.0f / cell_size;
        origin[0] = origin[1] = origin[2] = std::numeric_limits<float>::max();
        for (int64_t i = 0; i < n; ++i)
            for (int d = 0; d < 3; ++d)
                origin[d] = std::min(origin[d], pts[i * 3 + d]);
        cells.reserve(static_cast<size_t>(n / 4 + 1));
        for (int64_t i = 0; i < n; ++i) {
            CellKey k{cell_of(pts[i * 3 + 0], origin[0], inv_voxel),
                      cell_of(pts[i * 3 + 1], origin[1], inv_voxel),
                      cell_of(pts[i * 3 + 2], origin[2], inv_voxel)};
            cells[k].push_back(static_cast<int32_t>(i));
        }
    }
};

}  // namespace

extern "C" {

// Barycenter voxel downsample. Returns number of occupied voxels written
// (at most out_capacity; surplus voxels dropped deterministically by
// first-seen order).
int64_t bx_voxel_downsample(const float* pts, int64_t n, float voxel,
                            float* out, int64_t out_capacity) {
    std::unordered_map<CellKey, int64_t, CellHash> slot;
    std::vector<double> sums;
    std::vector<int64_t> counts;
    float origin[3] = {std::numeric_limits<float>::max(),
                       std::numeric_limits<float>::max(),
                       std::numeric_limits<float>::max()};
    for (int64_t i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d)
            origin[d] = std::min(origin[d], pts[i * 3 + d]);
    float inv = 1.0f / voxel;
    slot.reserve(static_cast<size_t>(n / 4 + 1));
    for (int64_t i = 0; i < n; ++i) {
        CellKey k{cell_of(pts[i * 3 + 0], origin[0], inv),
                  cell_of(pts[i * 3 + 1], origin[1], inv),
                  cell_of(pts[i * 3 + 2], origin[2], inv)};
        auto it = slot.find(k);
        int64_t s;
        if (it == slot.end()) {
            s = static_cast<int64_t>(slot.size());
            if (s >= out_capacity) continue;  // capacity reached: drop
            slot.emplace(k, s);
            sums.resize((s + 1) * 3, 0.0);
            counts.resize(s + 1, 0);
        } else {
            s = it->second;
        }
        for (int d = 0; d < 3; ++d) sums[s * 3 + d] += pts[i * 3 + d];
        counts[s] += 1;
    }
    int64_t m = static_cast<int64_t>(counts.size());
    for (int64_t s = 0; s < m; ++s)
        for (int d = 0; d < 3; ++d)
            out[s * 3 + d] = static_cast<float>(sums[s * 3 + d] / counts[s]);
    return m;
}

// Fixed-capacity radius neighbors: for each query, up to max_count indices
// of points within radius (first-found order), padded with -1.
// Returns 0 on success.
int32_t bx_radius_neighbors(const float* queries, int64_t nq,
                            const float* pts, int64_t n, float radius,
                            int32_t max_count, int32_t* out_idx) {
    HashGrid grid;
    grid.build(pts, n, radius);
    float r2 = radius * radius;

    parallel_for(nq, [&](int64_t lo, int64_t hi) {
        for (int64_t q = lo; q < hi; ++q) {
            const float* qp = &queries[q * 3];
            int32_t* row = &out_idx[static_cast<int64_t>(q) * max_count];
            int32_t found = 0;
            int32_t cx = cell_of(qp[0], grid.origin[0], grid.inv_voxel);
            int32_t cy = cell_of(qp[1], grid.origin[1], grid.inv_voxel);
            int32_t cz = cell_of(qp[2], grid.origin[2], grid.inv_voxel);
            for (int32_t dx = -1; dx <= 1 && found < max_count; ++dx)
                for (int32_t dy = -1; dy <= 1 && found < max_count; ++dy)
                    for (int32_t dz = -1; dz <= 1 && found < max_count; ++dz) {
                        auto it = grid.cells.find(
                            CellKey{cx + dx, cy + dy, cz + dz});
                        if (it == grid.cells.end()) continue;
                        for (int32_t idx : it->second) {
                            const float* p = &pts[idx * 3];
                            float d2 = 0;
                            for (int d = 0; d < 3; ++d) {
                                float diff = p[d] - qp[d];
                                d2 += diff * diff;
                            }
                            if (d2 <= r2) {
                                row[found++] = idx;
                                if (found >= max_count) break;
                            }
                        }
                    }
            for (int32_t t = found; t < max_count; ++t) row[t] = -1;
        }
    });
    return 0;
}

// Brute-force-over-grid k nearest neighbors (expanding ring search).
int32_t bx_knn(const float* queries, int64_t nq, const float* pts, int64_t n,
               int32_t k, float cell_size, int32_t* out_idx, float* out_d2) {
    HashGrid grid;
    grid.build(pts, n, cell_size);

    parallel_for(nq, [&](int64_t lo, int64_t hi) {
        std::vector<std::pair<float, int32_t>> best;
        for (int64_t q = lo; q < hi; ++q) {
            const float* qp = &queries[q * 3];
            best.clear();
            int32_t cx = cell_of(qp[0], grid.origin[0], grid.inv_voxel);
            int32_t cy = cell_of(qp[1], grid.origin[1], grid.inv_voxel);
            int32_t cz = cell_of(qp[2], grid.origin[2], grid.inv_voxel);
            for (int32_t ring = 0; ring < 64; ++ring) {
                size_t before = best.size();
                for (int32_t dx = -ring; dx <= ring; ++dx)
                    for (int32_t dy = -ring; dy <= ring; ++dy)
                        for (int32_t dz = -ring; dz <= ring; ++dz) {
                            if (std::max({std::abs(dx), std::abs(dy),
                                          std::abs(dz)}) != ring)
                                continue;  // shell only
                            auto it = grid.cells.find(
                                CellKey{cx + dx, cy + dy, cz + dz});
                            if (it == grid.cells.end()) continue;
                            for (int32_t idx : it->second) {
                                const float* p = &pts[idx * 3];
                                float d2 = 0;
                                for (int d = 0; d < 3; ++d) {
                                    float diff = p[d] - qp[d];
                                    d2 += diff * diff;
                                }
                                best.emplace_back(d2, idx);
                            }
                        }
                (void)before;
                if (static_cast<int32_t>(best.size()) >= k) {
                    // candidates within `ring` shells guarantee correctness
                    // once the k-th best distance fits inside the ring
                    std::partial_sort(
                        best.begin(),
                        best.begin() + std::min<size_t>(best.size(), k),
                        best.end());
                    float ring_reach = ring * grid.voxel;
                    if (best[k - 1].first <= ring_reach * ring_reach ||
                        ring >= 2)  // pragmatic cap: 2 extra shells
                        break;
                }
            }
            std::partial_sort(best.begin(),
                              best.begin() + std::min<size_t>(best.size(), k),
                              best.end());
            for (int32_t t = 0; t < k; ++t) {
                if (t < static_cast<int32_t>(best.size())) {
                    out_idx[q * k + t] = best[t].second;
                    out_d2[q * k + t] = best[t].first;
                } else {
                    out_idx[q * k + t] = -1;
                    out_d2[q * k + t] = std::numeric_limits<float>::infinity();
                }
            }
        }
    });
    return 0;
}

// Farthest point sampling (host-side).
int32_t bx_fps(const float* pts, int64_t n, int32_t k, int32_t* out_idx) {
    if (n <= 0 || k <= 0) return -1;
    std::vector<float> mind(n, std::numeric_limits<float>::max());
    int32_t cur = 0;
    for (int32_t s = 0; s < k; ++s) {
        out_idx[s] = cur;
        const float* cp = &pts[static_cast<int64_t>(cur) * 3];
        float best = -1.0f;
        int32_t next = 0;
        for (int64_t i = 0; i < n; ++i) {
            float d2 = 0;
            for (int d = 0; d < 3; ++d) {
                float diff = pts[i * 3 + d] - cp[d];
                d2 += diff * diff;
            }
            if (d2 < mind[i]) mind[i] = d2;
            if (mind[i] > best) {
                best = mind[i];
                next = static_cast<int32_t>(i);
            }
        }
        cur = next;
    }
    return 0;
}

}  // extern "C"

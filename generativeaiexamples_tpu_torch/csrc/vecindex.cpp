// Native ANN vector index for the PyTorch port: flat exact search and
// IVF-flat with a k-means coarse quantizer, on the host CPU.
//
// The port's own copy of the JAX package's native/vecindex.cpp, with the
// same C ABI, numerics and `.vecidx` file format, so that an index either
// package saved loads in the other. It stands in for the external FAISS
// and Milvus IVF_FLAT engines of the vector-store names faiss, native and
// ivf; the in-process store on the card (retrieval/torch_store.py) is the
// accelerator path, this is the host path. It is loaded through ctypes
// (retrieval/native_index.py), which builds it with the host g++ at first
// use.
//
// Metrics: 0 = inner product (cosine when inputs are normalized),
//          1 = squared L2 (returned negated so "higher is better" holds
//              for both metrics).
//
// Build: g++ -O3 -march=native -ffast-math -fPIC -shared -std=c++17

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <utility>
#include <vector>

namespace {

struct Index {
    int dim = 0;
    int metric = 0;     // 0 = IP, 1 = L2
    int nlist = 0;      // 0 = flat
    bool trained = false;
    std::vector<float> centroids;            // [nlist, dim]
    std::vector<std::vector<float>> lists;   // per-list vectors, row-major
    std::vector<std::vector<int64_t>> ids;   // per-list external ids
    int64_t next_id = 0;
    int64_t count = 0;

    int effective_nlist() const { return nlist > 0 ? nlist : 1; }
};

inline float dot(const float* a, const float* b, int d) {
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    int i = 0;
    for (; i + 4 <= d; i += 4) {
        acc0 += a[i] * b[i];
        acc1 += a[i + 1] * b[i + 1];
        acc2 += a[i + 2] * b[i + 2];
        acc3 += a[i + 3] * b[i + 3];
    }
    for (; i < d; ++i) acc0 += a[i] * b[i];
    return acc0 + acc1 + acc2 + acc3;
}

inline float l2sq(const float* a, const float* b, int d) {
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    int i = 0;
    for (; i + 4 <= d; i += 4) {
        float d0 = a[i] - b[i], d1 = a[i + 1] - b[i + 1];
        float d2 = a[i + 2] - b[i + 2], d3 = a[i + 3] - b[i + 3];
        acc0 += d0 * d0;
        acc1 += d1 * d1;
        acc2 += d2 * d2;
        acc3 += d3 * d3;
    }
    for (; i < d; ++i) {
        float dd = a[i] - b[i];
        acc0 += dd * dd;
    }
    return acc0 + acc1 + acc2 + acc3;
}

inline float score_of(const Index& ix, const float* q, const float* v) {
    // negated L2 so both metrics sort descending
    return ix.metric == 0 ? dot(q, v, ix.dim) : -l2sq(q, v, ix.dim);
}

int nearest_centroid(const Index& ix, const float* v) {
    int best = 0;
    float best_d = l2sq(v, ix.centroids.data(), ix.dim);
    for (int c = 1; c < ix.nlist; ++c) {
        float d = l2sq(v, ix.centroids.data() + (size_t)c * ix.dim, ix.dim);
        if (d < best_d) {
            best_d = d;
            best = c;
        }
    }
    return best;
}

using ScoredId = std::pair<float, int64_t>;

void scan_list(const Index& ix, int list_no, const float* q, int k,
               std::priority_queue<ScoredId, std::vector<ScoredId>,
                                   std::greater<ScoredId>>& heap) {
    const auto& vecs = ix.lists[list_no];
    const auto& lid = ix.ids[list_no];
    const size_t n = lid.size();
    for (size_t i = 0; i < n; ++i) {
        float s = score_of(ix, q, vecs.data() + i * ix.dim);
        if ((int)heap.size() < k) {
            heap.emplace(s, lid[i]);
        } else if (s > heap.top().first) {
            heap.pop();
            heap.emplace(s, lid[i]);
        }
    }
}

}  // namespace

extern "C" {

void* vi_create(int dim, int metric, int nlist) {
    auto* ix = new Index();
    ix->dim = dim;
    ix->metric = metric;
    ix->nlist = nlist;
    int n = ix->effective_nlist();
    ix->lists.resize(n);
    ix->ids.resize(n);
    if (nlist <= 0) ix->trained = true;  // flat needs no training
    return ix;
}

void vi_free(void* h) { delete static_cast<Index*>(h); }

int vi_is_trained(void* h) { return static_cast<Index*>(h)->trained ? 1 : 0; }

int64_t vi_count(void* h) { return static_cast<Index*>(h)->count; }

int vi_dim(void* h) { return static_cast<Index*>(h)->dim; }

// k-means (Lloyd) over a training sample; seeded, deterministic.
void vi_train(void* h, const float* vecs, int64_t n, int iters, uint64_t seed) {
    auto& ix = *static_cast<Index*>(h);
    if (ix.nlist <= 0 || n <= 0) return;
    const int d = ix.dim, K = ix.nlist;
    ix.centroids.assign((size_t)K * d, 0.f);
    std::mt19937_64 rng(seed);
    // init: distinct random rows (or wraparound when n < K)
    std::vector<int64_t> perm(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    std::shuffle(perm.begin(), perm.end(), rng);
    for (int c = 0; c < K; ++c) {
        const float* src = vecs + (size_t)(perm[c % n]) * d;
        std::memcpy(ix.centroids.data() + (size_t)c * d, src, d * sizeof(float));
    }
    std::vector<int> assign(n);
    std::vector<int64_t> sizes(K);
    std::vector<double> sums((size_t)K * d);
    for (int it = 0; it < iters; ++it) {
        for (int64_t i = 0; i < n; ++i)
            assign[i] = nearest_centroid(ix, vecs + (size_t)i * d);
        std::fill(sizes.begin(), sizes.end(), 0);
        std::fill(sums.begin(), sums.end(), 0.0);
        for (int64_t i = 0; i < n; ++i) {
            int c = assign[i];
            ++sizes[c];
            const float* v = vecs + (size_t)i * d;
            double* s = sums.data() + (size_t)c * d;
            for (int j = 0; j < d; ++j) s[j] += v[j];
        }
        for (int c = 0; c < K; ++c) {
            float* ctr = ix.centroids.data() + (size_t)c * d;
            if (sizes[c] == 0) {  // reseed empty cluster from a random row
                const float* src = vecs + (size_t)(rng() % n) * d;
                std::memcpy(ctr, src, d * sizeof(float));
                continue;
            }
            const double* s = sums.data() + (size_t)c * d;
            for (int j = 0; j < d; ++j) ctr[j] = (float)(s[j] / sizes[c]);
        }
    }
    ix.trained = true;
}

// Append n vectors; returns the first assigned id (ids are sequential).
int64_t vi_add(void* h, const float* vecs, int64_t n) {
    auto& ix = *static_cast<Index*>(h);
    if (!ix.trained) return -1;
    int64_t first = ix.next_id;
    for (int64_t i = 0; i < n; ++i) {
        const float* v = vecs + (size_t)i * ix.dim;
        int list_no = ix.nlist > 0 ? nearest_centroid(ix, v) : 0;
        auto& lv = ix.lists[list_no];
        lv.insert(lv.end(), v, v + ix.dim);
        ix.ids[list_no].push_back(ix.next_id++);
    }
    ix.count += n;
    return first;
}

// Top-k per query. out_scores/out_ids are [nq, k]; unfilled slots get
// id -1 / score -inf.
void vi_search(void* h, const float* queries, int64_t nq, int k, int nprobe,
               float* out_scores, int64_t* out_ids) {
    auto& ix = *static_cast<Index*>(h);
    const int d = ix.dim;
    const int L = ix.effective_nlist();
    if (nprobe <= 0) nprobe = 1;
    if (nprobe > L) nprobe = L;

    std::vector<std::pair<float, int>> cdist(ix.nlist > 0 ? ix.nlist : 0);
    for (int64_t qi = 0; qi < nq; ++qi) {
        const float* q = queries + (size_t)qi * d;
        std::priority_queue<ScoredId, std::vector<ScoredId>, std::greater<ScoredId>>
            heap;
        if (ix.nlist > 0) {
            for (int c = 0; c < ix.nlist; ++c)
                cdist[c] = {l2sq(q, ix.centroids.data() + (size_t)c * d, d), c};
            int probes = std::min(nprobe, ix.nlist);
            std::partial_sort(cdist.begin(), cdist.begin() + probes, cdist.end());
            for (int p = 0; p < probes; ++p) scan_list(ix, cdist[p].second, q, k, heap);
        } else {
            scan_list(ix, 0, q, k, heap);
        }
        // drain ascending → fill back-to-front for descending output
        int got = (int)heap.size();
        for (int slot = k - 1; slot >= 0; --slot) {
            if (slot >= got) {
                out_scores[qi * k + slot] = -INFINITY;
                out_ids[qi * k + slot] = -1;
                continue;
            }
            out_scores[qi * k + slot] = heap.top().first;
            out_ids[qi * k + slot] = heap.top().second;
            heap.pop();
        }
    }
}

// Remove by external ids (sorted or not); compacts lists in place.
int64_t vi_remove(void* h, const int64_t* remove_ids, int64_t n) {
    auto& ix = *static_cast<Index*>(h);
    std::vector<int64_t> sorted(remove_ids, remove_ids + n);
    std::sort(sorted.begin(), sorted.end());
    int64_t removed = 0;
    const int d = ix.dim;
    for (size_t l = 0; l < ix.lists.size(); ++l) {
        auto& lv = ix.lists[l];
        auto& lid = ix.ids[l];
        size_t w = 0;
        for (size_t r = 0; r < lid.size(); ++r) {
            bool drop = std::binary_search(sorted.begin(), sorted.end(), lid[r]);
            if (drop) {
                ++removed;
                continue;
            }
            if (w != r) {
                std::memmove(lv.data() + w * d, lv.data() + r * d, d * sizeof(float));
                lid[w] = lid[r];
            }
            ++w;
        }
        lv.resize(w * d);
        lid.resize(w);
    }
    ix.count -= removed;
    return removed;
}

// ---- persistence ---------------------------------------------------------
// layout: magic, dim, metric, nlist, trained, next_id, count,
//         centroids, per-list (len, ids, vecs)

static const uint64_t kMagic = 0x7470755F76656331ULL;  // "tpu_vec1"

int vi_save(void* h, const char* path) {
    auto& ix = *static_cast<Index*>(h);
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    auto w64 = [&](uint64_t v) { std::fwrite(&v, sizeof(v), 1, f); };
    w64(kMagic);
    w64((uint64_t)ix.dim);
    w64((uint64_t)ix.metric);
    w64((uint64_t)ix.nlist);
    w64((uint64_t)(ix.trained ? 1 : 0));
    w64((uint64_t)ix.next_id);
    w64((uint64_t)ix.count);
    if (ix.nlist > 0)
        std::fwrite(ix.centroids.data(), sizeof(float), ix.centroids.size(), f);
    for (size_t l = 0; l < ix.lists.size(); ++l) {
        w64((uint64_t)ix.ids[l].size());
        std::fwrite(ix.ids[l].data(), sizeof(int64_t), ix.ids[l].size(), f);
        std::fwrite(ix.lists[l].data(), sizeof(float), ix.lists[l].size(), f);
    }
    std::fclose(f);
    return 0;
}

void* vi_load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    auto r64 = [&](uint64_t& v) { return std::fread(&v, sizeof(v), 1, f) == 1; };
    uint64_t magic = 0, dim, metric, nlist, trained, next_id, count;
    if (!r64(magic) || magic != kMagic || !r64(dim) || !r64(metric) ||
        !r64(nlist) || !r64(trained) || !r64(next_id) || !r64(count)) {
        std::fclose(f);
        return nullptr;
    }
    auto* ix = static_cast<Index*>(vi_create((int)dim, (int)metric, (int)nlist));
    ix->trained = trained != 0;
    ix->next_id = (int64_t)next_id;
    ix->count = (int64_t)count;
    bool ok = true;
    if (ix->nlist > 0) {
        ix->centroids.resize((size_t)nlist * dim);
        ok = std::fread(ix->centroids.data(), sizeof(float), ix->centroids.size(), f) ==
             ix->centroids.size();
    }
    for (size_t l = 0; ok && l < ix->lists.size(); ++l) {
        uint64_t len = 0;
        ok = r64(len);
        if (!ok) break;
        ix->ids[l].resize(len);
        ix->lists[l].resize((size_t)len * dim);
        ok = std::fread(ix->ids[l].data(), sizeof(int64_t), len, f) == len &&
             std::fread(ix->lists[l].data(), sizeof(float), ix->lists[l].size(), f) ==
                 ix->lists[l].size();
    }
    std::fclose(f);
    if (!ok) {
        vi_free(ix);
        return nullptr;
    }
    return ix;
}

}  // extern "C"

// Host-side native kernels of the port: the port's own copy of the parts
// of the JAX package's host library that the port calls (splitmix64
// hashing, the blocked bloom filter, sorted-set membership, the roaring
// bitmap and the HNSW graph), behind the same minimal C ABI over dense
// arrays, called from Python via ctypes
// (matrixone_tpu_torch/native/__init__.py).  No device ever sees this
// code: it serves the host side of the storage engine (the primary-key
// bloom filter, the scan's tombstone filter) and the HNSW index's walk.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 mo_native.cpp -o libmo_native.so

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// ----------------------------------------------------------------- hashing
// splitmix64 finalizer (public domain; same mixer as the device-side
// ops/hash.py so host and device agree on hash values).
static inline uint64_t mix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

void mo_hash64_i64(const int64_t* in, size_t n, uint64_t* out) {
    for (size_t i = 0; i < n; i++) out[i] = mix64((uint64_t)in[i]);
}

// ------------------------------------------------------------ bloom filter
// Blocked bloom: k derived probes from one 64-bit hash (double hashing),
// reference: cgo/bloom.c + common/bloomfilter.
void mo_bloom_add(const uint64_t* hashes, size_t n, uint8_t* bits,
                  uint64_t nbits, int k) {
    for (size_t i = 0; i < n; i++) {
        uint64_t h1 = hashes[i];
        uint64_t h2 = mix64(h1);
        for (int j = 0; j < k; j++) {
            uint64_t bit = (h1 + (uint64_t)j * h2) % nbits;
            bits[bit >> 3] |= (uint8_t)(1u << (bit & 7));
        }
    }
}

void mo_bloom_probe(const uint64_t* hashes, size_t n, const uint8_t* bits,
                    uint64_t nbits, int k, uint8_t* out) {
    for (size_t i = 0; i < n; i++) {
        uint64_t h1 = hashes[i];
        uint64_t h2 = mix64(h1);
        uint8_t hit = 1;
        for (int j = 0; j < k && hit; j++) {
            uint64_t bit = (h1 + (uint64_t)j * h2) % nbits;
            hit = (bits[bit >> 3] >> (bit & 7)) & 1;
        }
        out[i] = hit;
    }
}


// ----------------------------------------------------- sorted-set helpers
// membership of ids in a SORTED haystack (tombstone filtering hot path —
// the C version of np.isin for the scan loop).
void mo_sorted_contains(const int64_t* haystack, size_t hn,
                        const int64_t* ids, size_t n, uint8_t* out) {
    for (size_t i = 0; i < n; i++) {
        int64_t x = ids[i];
        size_t lo = 0, hi = hn;
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (haystack[mid] < x) lo = mid + 1; else hi = mid;
        }
        out[i] = (lo < hn && haystack[lo] == x);
    }
}

}  // extern "C"

// ------------------------------------------------------ roaring bitmap
// Compressed 64-bit id set (reference analogue: cgo/croaring.c +
// thirdparties/CRoaring — redesigned, not ported): ids are bucketed by
// their high bits (id >> 16); each bucket holds the low 16 bits either
// as a sorted uint16 array (sparse: <= 4096 entries, 2 B/id) or a
// 64-Kbit bitmap (dense: fixed 8 KiB). Containers convert in both
// directions as set operations change their cardinality — the classic
// roaring design, which is what makes 0.1%-density tombstone filters
// ~50x smaller than a dense bitset over the same row domain.

#include <map>
#include <vector>
#include <algorithm>

namespace {

constexpr int kArrMax = 4096;        // array->bitmap threshold

struct RContainer {
    bool is_bitmap = false;
    std::vector<uint16_t> arr;       // sorted, unique
    std::vector<uint64_t> bits;      // 1024 words when bitmap
    int32_t count = 0;

    void to_bitmap() {
        if (is_bitmap) return;
        bits.assign(1024, 0);
        for (uint16_t v : arr) bits[v >> 6] |= 1ULL << (v & 63);
        arr.clear();
        arr.shrink_to_fit();
        is_bitmap = true;
    }

    void to_array() {
        if (!is_bitmap) return;
        arr.clear();
        arr.reserve(count);
        for (int w = 0; w < 1024; w++) {
            uint64_t word = bits[w];
            while (word) {
                int b = __builtin_ctzll(word);
                arr.push_back((uint16_t)((w << 6) | b));
                word &= word - 1;
            }
        }
        bits.clear();
        bits.shrink_to_fit();
        is_bitmap = false;
    }

    bool test(uint16_t v) const {
        if (is_bitmap) return (bits[v >> 6] >> (v & 63)) & 1;
        return std::binary_search(arr.begin(), arr.end(), v);
    }

    void add(uint16_t v) {
        if (is_bitmap) {
            uint64_t& w = bits[v >> 6];
            uint64_t m = 1ULL << (v & 63);
            if (!(w & m)) { w |= m; count++; }
            return;
        }
        auto it = std::lower_bound(arr.begin(), arr.end(), v);
        if (it != arr.end() && *it == v) return;
        arr.insert(it, v);
        count++;
        if (count > kArrMax) to_bitmap();
    }

    size_t bytes() const {
        return sizeof(*this) + (is_bitmap ? bits.size() * 8
                                          : arr.capacity() * 2);
    }
};

struct MoRoaring {
    std::map<uint64_t, RContainer> cs;   // high bits -> container
    int64_t total = 0;
};

}  // namespace

extern "C" {

void* mo_rbm_create() { return new MoRoaring(); }
void mo_rbm_free(void* h) { delete (MoRoaring*)h; }

void mo_rbm_add(void* h, const int64_t* ids, size_t n) {
    auto* r = (MoRoaring*)h;
    for (size_t i = 0; i < n; i++) {
        int64_t id = ids[i];
        if (id < 0) continue;
        RContainer& c = r->cs[(uint64_t)id >> 16];
        int before = c.count;
        c.add((uint16_t)(id & 0xFFFF));
        r->total += c.count - before;
    }
}

void mo_rbm_test(void* h, const int64_t* ids, size_t n, uint8_t* out) {
    auto* r = (MoRoaring*)h;
    const RContainer* last = nullptr;
    uint64_t last_hi = ~0ULL;
    for (size_t i = 0; i < n; i++) {
        int64_t id = ids[i];
        if (id < 0) { out[i] = 0; continue; }
        uint64_t hi = (uint64_t)id >> 16;
        if (hi != last_hi) {            // scans probe in gid order: cache
            auto it = r->cs.find(hi);
            last = it == r->cs.end() ? nullptr : &it->second;
            last_hi = hi;
        }
        out[i] = last && last->test((uint16_t)(id & 0xFFFF));
    }
}

// membership of the CONTIGUOUS id range [lo, hi) — the tombstone-filter
// hot path: a scan chunk's gids are a range, so the per-chunk np.isin
// becomes one container walk
void mo_rbm_test_range(void* h, int64_t lo, int64_t hi, uint8_t* out) {
    auto* r = (MoRoaring*)h;
    if (hi <= lo) return;          // before the memset: hi<lo would wrap
    memset(out, 0, (size_t)(hi - lo));
    if (r->total == 0) return;
    uint64_t kb = (uint64_t)(lo < 0 ? 0 : lo) >> 16;
    for (auto it = r->cs.lower_bound(kb); it != r->cs.end(); ++it) {
        int64_t base = (int64_t)(it->first << 16);
        if (base >= hi) break;
        const RContainer& c = it->second;
        if (c.is_bitmap) {
            int64_t s = std::max(lo, base), e = std::min(hi, base + 65536);
            for (int64_t id = s; id < e; id++) {
                uint16_t v = (uint16_t)(id & 0xFFFF);
                out[id - lo] = (c.bits[v >> 6] >> (v & 63)) & 1;
            }
        } else {
            for (uint16_t v : c.arr) {
                int64_t id = base + v;
                if (id >= lo && id < hi) out[id - lo] = 1;
            }
        }
    }
}

int64_t mo_rbm_count(void* h) { return ((MoRoaring*)h)->total; }

int64_t mo_rbm_bytes(void* h) {
    auto* r = (MoRoaring*)h;
    size_t total = sizeof(*r);
    for (auto& [k, c] : r->cs) total += sizeof(k) + c.bytes();
    return (int64_t)total;
}

void mo_rbm_or(void* ha, void* hb) {     // a |= b
    auto* a = (MoRoaring*)ha;
    auto* b = (MoRoaring*)hb;
    for (auto& [k, cb] : b->cs) {
        RContainer& ca = a->cs[k];
        if (!ca.is_bitmap && !cb.is_bitmap
                && ca.count + cb.count <= kArrMax) {
            std::vector<uint16_t> merged;
            merged.reserve(ca.count + cb.count);
            std::set_union(ca.arr.begin(), ca.arr.end(),
                           cb.arr.begin(), cb.arr.end(),
                           std::back_inserter(merged));
            a->total += (int64_t)merged.size() - ca.count;
            ca.arr = std::move(merged);
            ca.count = (int32_t)ca.arr.size();
            continue;
        }
        ca.to_bitmap();
        int before = ca.count;
        if (cb.is_bitmap) {
            int cnt = 0;
            for (int w = 0; w < 1024; w++) {
                ca.bits[w] |= cb.bits[w];
                cnt += __builtin_popcountll(ca.bits[w]);
            }
            ca.count = cnt;
        } else {
            for (uint16_t v : cb.arr) {
                uint64_t& w = ca.bits[v >> 6];
                uint64_t m = 1ULL << (v & 63);
                if (!(w & m)) { w |= m; ca.count++; }
            }
        }
        a->total += ca.count - before;
    }
}

void mo_rbm_and(void* ha, void* hb) {    // a &= b
    auto* a = (MoRoaring*)ha;
    auto* b = (MoRoaring*)hb;
    for (auto it = a->cs.begin(); it != a->cs.end();) {
        auto bit = b->cs.find(it->first);
        if (bit == b->cs.end()) {
            a->total -= it->second.count;
            it = a->cs.erase(it);
            continue;
        }
        RContainer& ca = it->second;
        const RContainer& cb = bit->second;
        int before = ca.count;
        if (ca.is_bitmap && cb.is_bitmap) {
            int cnt = 0;
            for (int w = 0; w < 1024; w++) {
                ca.bits[w] &= cb.bits[w];
                cnt += __builtin_popcountll(ca.bits[w]);
            }
            ca.count = cnt;
            if (ca.count <= kArrMax) ca.to_array();
        } else if (!ca.is_bitmap) {
            std::vector<uint16_t> kept;
            kept.reserve(ca.arr.size());
            for (uint16_t v : ca.arr)
                if (cb.test(v)) kept.push_back(v);
            ca.arr = std::move(kept);
            ca.count = (int32_t)ca.arr.size();
        } else {                    // ca bitmap, cb array
            std::vector<uint16_t> kept;
            for (uint16_t v : cb.arr)
                if (ca.test(v)) kept.push_back(v);
            ca.is_bitmap = false;
            ca.bits.clear();
            ca.bits.shrink_to_fit();
            ca.arr = std::move(kept);
            ca.count = (int32_t)ca.arr.size();
        }
        a->total += ca.count - before;
        if (ca.count == 0) it = a->cs.erase(it);
        else ++it;
    }
}

int64_t mo_rbm_to_array(void* h, int64_t* out, int64_t cap) {
    auto* r = (MoRoaring*)h;
    int64_t k = 0;
    for (auto& [key, c] : r->cs) {
        int64_t base = (int64_t)(key << 16);
        if (c.is_bitmap) {
            for (int w = 0; w < 1024 && k < cap; w++) {
                uint64_t word = c.bits[w];
                while (word && k < cap) {
                    int b = __builtin_ctzll(word);
                    out[k++] = base + ((int64_t)w << 6) + b;
                    word &= word - 1;
                }
            }
        } else {
            for (uint16_t v : c.arr) {
                if (k >= cap) break;
                out[k++] = base + v;
            }
        }
    }
    return k;
}

}  // extern "C"

// ---------------------------------------------------------------- HNSW
// Graph vector index walker in C++ (reference analogue: cgo/usearchex.c +
// thirdparties/usearch). The card serves batched IVF scans (the flagship
// ANN path); HNSW exists for the reference's API surface and low-latency
// single-query lookups, and a pointer-chasing graph walk belongs on the
// host in native code — a Python walk is ~100x slower at scale.
// Standard hnswlib-style construction: exponential level sampling,
// efConstruction beam per level, closest-M neighbor selection with
// reverse-link pruning. Metrics: 0 = squared l2, 1 = cosine (vectors
// stored normalized, distance = 1 - dot).

#include <vector>
#include <queue>
#include <cmath>
#include <random>
#include <algorithm>

namespace {

struct MoHnsw {
    int64_t n = 0;
    int d = 0, M = 16, efc = 64, metric = 0;
    int max_level = -1;
    int64_t entry = -1;
    std::vector<float> data;                 // n * d
    std::vector<int> level_of;               // n
    // neighbors[l][i*cap(l) .. ]: -1 padded; cap(0)=2M, cap(l>0)=M
    std::vector<std::vector<int64_t>> nbr;

    int cap(int level) const { return level == 0 ? 2 * M : M; }

    float dist(const float* a, const float* b) const {
        float acc = 0.f;
        if (metric == 1) {
            for (int j = 0; j < d; j++) acc += a[j] * b[j];
            return 1.0f - acc;
        }
        for (int j = 0; j < d; j++) {
            float t = a[j] - b[j];
            acc += t * t;
        }
        return acc;
    }

    const float* vec(int64_t i) const { return data.data() + i * d; }

    // beam search at one level from entry points; returns up to ef
    // (dist, id) pairs, closest first
    void search_layer(const float* q, std::vector<int64_t>& eps, int ef,
                      int level,
                      std::vector<std::pair<float, int64_t>>& out,
                      std::vector<uint8_t>& visited,
                      std::vector<int64_t>& touched) const {
        // max-heap of current results, min-heap of candidates
        std::priority_queue<std::pair<float, int64_t>> results;
        std::priority_queue<std::pair<float, int64_t>,
                            std::vector<std::pair<float, int64_t>>,
                            std::greater<>> cand;
        for (int64_t ep : eps) {
            if (visited[ep]) continue;
            visited[ep] = 1;
            touched.push_back(ep);
            float dq = dist(q, vec(ep));
            results.emplace(dq, ep);
            cand.emplace(dq, ep);
        }
        while (!cand.empty()) {
            auto [dc, c] = cand.top();
            if (!results.empty() && dc > results.top().first &&
                (int)results.size() >= ef)
                break;
            cand.pop();
            const int64_t* ns = nbr[level].data() + c * cap(level);
            for (int j = 0; j < cap(level); j++) {
                int64_t nb = ns[j];
                if (nb < 0) break;
                if (visited[nb]) continue;
                visited[nb] = 1;
                touched.push_back(nb);
                float dn = dist(q, vec(nb));
                if ((int)results.size() < ef || dn < results.top().first) {
                    results.emplace(dn, nb);
                    cand.emplace(dn, nb);
                    if ((int)results.size() > ef) results.pop();
                }
            }
        }
        out.clear();
        while (!results.empty()) {
            out.push_back(results.top());
            results.pop();
        }
        std::reverse(out.begin(), out.end());
        for (int64_t t : touched) visited[t] = 0;
        touched.clear();
    }

    // hnswlib neighbor-select heuristic: keep a candidate only if it is
    // closer to the base than to every already-kept neighbor (diversity
    // beats raw proximity for graph connectivity on clustered data);
    // backfill with the closest rejects if under-full
    void select_heuristic(std::vector<std::pair<float, int64_t>>& cand,
                          int c,
                          std::vector<int64_t>& out) const {
        std::sort(cand.begin(), cand.end());
        out.clear();
        std::vector<int64_t> rejected;
        for (auto& [dq, id] : cand) {
            if ((int)out.size() >= c) break;
            bool good = true;
            for (int64_t kept : out) {
                if (dist(vec(id), vec(kept)) < dq) { good = false; break; }
            }
            if (good) out.push_back(id);
            else rejected.push_back(id);
        }
        for (int64_t id : rejected) {
            if ((int)out.size() >= c) break;
            out.push_back(id);
        }
    }

    void link(int level, int64_t from, int64_t to) {
        int64_t* ns = nbr[level].data() + from * cap(level);
        int c = cap(level);
        for (int j = 0; j < c; j++) {
            if (ns[j] == to) return;
            if (ns[j] < 0) { ns[j] = to; return; }
        }
        // full: re-select with the diversity heuristic over existing + to
        std::vector<std::pair<float, int64_t>> all;
        all.reserve(c + 1);
        for (int j = 0; j < c; j++)
            all.emplace_back(dist(vec(from), vec(ns[j])), ns[j]);
        all.emplace_back(dist(vec(from), vec(to)), to);
        std::vector<int64_t> keep;
        select_heuristic(all, c, keep);
        for (int j = 0; j < c; j++)
            ns[j] = j < (int)keep.size() ? keep[j] : -1;
    }
};

}  // namespace

extern "C" {

void* mo_hnsw_build(const float* data, int64_t n, int d, int M, int efc,
                    int metric, uint64_t seed) {
    auto* h = new MoHnsw();
    h->n = n; h->d = d; h->M = M; h->efc = efc; h->metric = metric;
    h->data.assign(data, data + n * d);
    if (metric == 1) {                       // store normalized
        for (int64_t i = 0; i < n; i++) {
            float* v = h->data.data() + i * d;
            float s = 0.f;
            for (int j = 0; j < d; j++) s += v[j] * v[j];
            s = std::sqrt(std::max(s, 1e-30f));
            for (int j = 0; j < d; j++) v[j] /= s;
        }
    }
    h->level_of.assign(n, 0);
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(1e-12, 1.0);
    const double mL = 1.0 / std::log(std::max(2, M));
    int max_lv = 0;
    for (int64_t i = 0; i < n; i++) {
        int lv = (int)(-std::log(uni(rng)) * mL);
        if (lv > 32) lv = 32;
        h->level_of[i] = lv;
        if (lv > max_lv) max_lv = lv;
    }
    h->nbr.resize(max_lv + 1);
    for (int l = 0; l <= max_lv; l++)
        h->nbr[l].assign(n * h->cap(l), -1);

    std::vector<uint8_t> visited(n, 0);
    std::vector<int64_t> touched;
    std::vector<std::pair<float, int64_t>> found;
    std::vector<int64_t> eps;
    for (int64_t i = 0; i < n; i++) {
        int lv = h->level_of[i];
        if (h->entry < 0) {
            h->entry = i;
            h->max_level = lv;
            continue;
        }
        eps.assign(1, h->entry);
        const float* q = h->vec(i);
        // greedy descent through levels above lv
        for (int l = h->max_level; l > lv; l--) {
            h->search_layer(q, eps, 1, l, found, visited, touched);
            if (!found.empty()) eps.assign(1, found[0].second);
        }
        // beam insert at each level from min(lv, max_level) down to 0
        std::vector<int64_t> picked;
        for (int l = std::min(lv, h->max_level); l >= 0; l--) {
            h->search_layer(q, eps, h->efc, l, found, visited, touched);
            auto cand = found;         // heuristic-select M of the beam
            h->select_heuristic(cand, h->M, picked);
            for (int64_t p : picked) {
                h->link(l, i, p);
                h->link(l, p, i);
            }
            eps.clear();
            for (auto& f : found) eps.push_back(f.second);
        }
        if (lv > h->max_level) {
            h->max_level = lv;
            h->entry = i;
        }
    }
    return h;
}

void mo_hnsw_search(void* handle, const float* queries, int64_t nq, int k,
                    int ef, int64_t* out_ids, float* out_d) {
    auto* h = (MoHnsw*)handle;
    std::vector<uint8_t> visited(h->n, 0);
    std::vector<int64_t> touched;
    std::vector<std::pair<float, int64_t>> found;
    std::vector<float> qbuf(h->d);
    for (int64_t qi = 0; qi < nq; qi++) {
        const float* q0 = queries + qi * h->d;
        const float* q = q0;
        if (h->metric == 1) {
            float s = 0.f;
            for (int j = 0; j < h->d; j++) s += q0[j] * q0[j];
            s = std::sqrt(std::max(s, 1e-30f));
            for (int j = 0; j < h->d; j++) qbuf[j] = q0[j] / s;
            q = qbuf.data();
        }
        std::vector<int64_t> eps;
        if (h->entry >= 0) eps.push_back(h->entry);
        for (int l = h->max_level; l > 0; l--) {
            h->search_layer(q, eps, 1, l, found, visited, touched);
            if (!found.empty()) eps.assign(1, found[0].second);
        }
        h->search_layer(q, eps, std::max(ef, k), 0, found, visited,
                        touched);
        for (int t = 0; t < k; t++) {
            if (t < (int)found.size()) {
                out_ids[qi * k + t] = found[t].second;
                out_d[qi * k + t] = found[t].first;
            } else {
                out_ids[qi * k + t] = -1;
                out_d[qi * k + t] = INFINITY;
            }
        }
    }
}

int64_t mo_hnsw_n(void* handle) { return ((MoHnsw*)handle)->n; }

void mo_hnsw_free(void* handle) { delete (MoHnsw*)handle; }

}  // extern "C"

// dhtcore — native host-side hot path of the host DHT node (the port's
// copy of opendht_tpu/native/dhtcore.cpp).
//
// The reference implements its whole core in C++11 (see SURVEY.md §2);
// here the device engines own the massively batched work and this
// library owns the host hot loops that Python is too slow for:
//
//  * exact 160-bit XOR-metric ops over packed 20-byte ids
//    (ref semantics: InfoHash::cmp/commonBits/xorCmp,
//    include/opendht/infohash.h:101-146)
//  * k-closest selection over large packed node matrices — the host
//    equivalent of RoutingTable::findClosestNodes
//    (src/routing_table.cpp:67-111) and NodeCache::getCachedNodes
//    (src/node_cache.cpp:36-66) for swarm-scale node sets
//  * sliding-window rate limiting (ref: include/opendht/rate_limiter.h)
//  * write-token generation/checking (SHA-512-free variant: the Python
//    layer provides the hash; here we do the constant-time compare)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in-image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC dhtcore.cpp -o libdhtcore.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr size_t HASH_LEN = 20;

// Lexicographic (= big-integer) compare of two 20-byte ids.
inline int cmp_id(const uint8_t* a, const uint8_t* b) {
    return std::memcmp(a, b, HASH_LEN);
}

// XOR-metric three-way compare: is |a^t| < |b^t| ?
// (ref: InfoHash::xorCmp include/opendht/infohash.h:131-146)
inline int xor_cmp(const uint8_t* a, const uint8_t* b, const uint8_t* t) {
    for (size_t i = 0; i < HASH_LEN; i++) {
        uint8_t x = a[i] ^ t[i], y = b[i] ^ t[i];
        if (x != y)
            return x < y ? -1 : 1;
    }
    return 0;
}

inline unsigned clz8(uint8_t x) {
    unsigned n = 0;
    for (uint8_t m = 0x80; m && !(x & m); m >>= 1)
        n++;
    return n;
}

}  // namespace

extern "C" {

// Number of common prefix bits (ref: InfoHash::commonBits
// include/opendht/infohash.h:106-117).
int dhtcore_common_bits(const uint8_t* a, const uint8_t* b) {
    for (size_t i = 0; i < HASH_LEN; i++) {
        uint8_t x = a[i] ^ b[i];
        if (x)
            return int(i * 8 + clz8(x));
    }
    return int(HASH_LEN * 8);
}

int dhtcore_xor_cmp(const uint8_t* a, const uint8_t* b, const uint8_t* t) {
    return xor_cmp(a, b, t);
}

// Exact k XOR-closest rows of a packed [n,20] id matrix.
// out must hold k int32; returns the count written.  Partial-select +
// sort: O(n + k log k) via nth_element on a distance-comparing index
// array — the host twin of ops/pallas_kernels.nearest_ids.
int dhtcore_xor_topk(const uint8_t* ids, int64_t n, const uint8_t* target,
                     int32_t k, int32_t* out) {
    if (n <= 0 || k <= 0)
        return 0;
    if (k > n)
        k = int32_t(n);
    std::vector<int32_t> idx((size_t)n);
    for (int64_t i = 0; i < n; i++)
        idx[(size_t)i] = int32_t(i);
    auto closer = [&](int32_t x, int32_t y) {
        return xor_cmp(ids + (size_t)x * HASH_LEN,
                       ids + (size_t)y * HASH_LEN, target) < 0;
    };
    std::nth_element(idx.begin(), idx.begin() + (k - 1), idx.end(), closer);
    std::sort(idx.begin(), idx.begin() + k, closer);
    std::memcpy(out, idx.data(), sizeof(int32_t) * (size_t)k);
    return k;
}

// Batched common-bits of one id against a packed matrix.
void dhtcore_common_bits_batch(const uint8_t* ids, int64_t n,
                               const uint8_t* target, int32_t* out) {
    for (int64_t i = 0; i < n; i++)
        out[(size_t)i] =
            dhtcore_common_bits(ids + (size_t)i * HASH_LEN, target);
}

// Sort (in place) an array of int32 indices into a packed id matrix by
// XOR distance to target — the reference's XOR-sorted bucket merge.
void dhtcore_xor_sort(const uint8_t* ids, int32_t* idx, int64_t count,
                      const uint8_t* target) {
    std::sort(idx, idx + count, [&](int32_t x, int32_t y) {
        return xor_cmp(ids + (size_t)x * HASH_LEN,
                       ids + (size_t)y * HASH_LEN, target) < 0;
    });
}

// ---------------------------------------------------------------------
// Sliding-window rate limiter (ref: include/opendht/rate_limiter.h:26-48)
// ---------------------------------------------------------------------

struct RateLimiter {
    size_t quota;
    std::deque<double> hits;
};

void* dhtcore_rate_limiter_new(uint64_t quota) {
    return new RateLimiter{(size_t)quota, {}};
}

void dhtcore_rate_limiter_free(void* rl) {
    delete static_cast<RateLimiter*>(rl);
}

// Returns 1 if the packet passes, 0 if over quota.
int dhtcore_rate_limiter_limit(void* p, double now) {
    auto* rl = static_cast<RateLimiter*>(p);
    while (!rl->hits.empty() && rl->hits.front() < now - 1.0)
        rl->hits.pop_front();
    if (rl->hits.size() >= rl->quota)
        return 0;
    rl->hits.push_back(now);
    return 1;
}

// Constant-time token compare (write-token check,
// ref: Dht::tokenMatch src/dht.cpp:2436-2446).
int dhtcore_token_eq(const uint8_t* a, const uint8_t* b, uint64_t len) {
    uint8_t acc = 0;
    for (uint64_t i = 0; i < len; i++)
        acc |= a[i] ^ b[i];
    return acc == 0;
}

}  // extern "C"

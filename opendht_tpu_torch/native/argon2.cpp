// Argon2i (RFC 9106, version 0x13) with its own BLAKE2b (RFC 7693) and
// the variable-length hash H' built on it.  One lane after another in
// each slice, which gives the same tag as the reference's threads: a
// lane reads only blocks of finished slices from the other lanes.
//
// C interface (loaded through ctypes by native/argon2.py):
//   int argon2i_hash_raw(t_cost, m_cost_kib, lanes, pwd, pwdlen, salt,
//                        saltlen, secret, secretlen, ad, adlen, out,
//                        outlen)
// returns 0 on success, -1 on a bad parameter, -2 when the memory
// cannot be allocated.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- BLAKE2b

const uint64_t kIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

const uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, unsigned n) {
  return (x >> n) | (x << (64 - n));
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

inline void store64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; ++i) p[i] = uint8_t(v >> (8 * i));
}

inline void store32(uint8_t* p, uint32_t v) {
  for (int i = 0; i < 4; ++i) p[i] = uint8_t(v >> (8 * i));
}

struct Blake2b {
  uint64_t h[8];
  uint64_t t[2] = {0, 0};
  uint8_t buf[128];
  size_t buflen = 0;
  size_t outlen;

  explicit Blake2b(size_t out) : outlen(out) {
    for (int i = 0; i < 8; ++i) h[i] = kIV[i];
    h[0] ^= 0x01010000ULL ^ uint64_t(out);  // no key, fanout 1, depth 1
  }

  void compress(const uint8_t* block, bool last) {
    uint64_t m[16], v[16];
    for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
    for (int i = 0; i < 8; ++i) {
      v[i] = h[i];
      v[i + 8] = kIV[i];
    }
    v[12] ^= t[0];
    v[13] ^= t[1];
    if (last) v[14] = ~v[14];
    for (int r = 0; r < 12; ++r) {
      const uint8_t* s = kSigma[r];
#define B2_G(a, b, c, d, x, y)       \
  v[a] = v[a] + v[b] + (x);          \
  v[d] = rotr64(v[d] ^ v[a], 32);    \
  v[c] = v[c] + v[d];                \
  v[b] = rotr64(v[b] ^ v[c], 24);    \
  v[a] = v[a] + v[b] + (y);          \
  v[d] = rotr64(v[d] ^ v[a], 16);    \
  v[c] = v[c] + v[d];                \
  v[b] = rotr64(v[b] ^ v[c], 63);
      B2_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
      B2_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
      B2_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
      B2_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
      B2_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
      B2_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
      B2_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
      B2_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
#undef B2_G
    }
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
  }

  void add_counter(uint64_t n) {
    t[0] += n;
    if (t[0] < n) ++t[1];
  }

  void update(const uint8_t* in, size_t n) {
    while (n > 0) {
      if (buflen == 128) {  // a full block is compressed only once more
        add_counter(128);   // input follows it (the last one is final)
        compress(buf, false);
        buflen = 0;
      }
      size_t take = 128 - buflen;
      if (take > n) take = n;
      std::memcpy(buf + buflen, in, take);
      buflen += take;
      in += take;
      n -= take;
    }
  }

  void update32(uint32_t v) {
    uint8_t b[4];
    store32(b, v);
    update(b, 4);
  }

  void final(uint8_t* out) {
    add_counter(buflen);
    std::memset(buf + buflen, 0, 128 - buflen);
    compress(buf, true);
    uint8_t full[64];
    for (int i = 0; i < 8; ++i) store64(full + 8 * i, h[i]);
    std::memcpy(out, full, outlen);
  }
};

// H': BLAKE2b of LE32(outlen) || in, stretched past 64 bytes by a chain
// of 64-byte hashes of which each gives its first 32 bytes.
void blake2b_long(uint8_t* out, size_t outlen, const uint8_t* in,
                  size_t inlen) {
  if (outlen <= 64) {
    Blake2b b(outlen);
    b.update32(uint32_t(outlen));
    b.update(in, inlen);
    b.final(out);
    return;
  }
  uint8_t v[64];
  Blake2b b(64);
  b.update32(uint32_t(outlen));
  b.update(in, inlen);
  b.final(v);
  std::memcpy(out, v, 32);
  out += 32;
  size_t left = outlen - 32;
  while (left > 64) {
    Blake2b c(64);
    c.update(v, 64);
    c.final(v);
    std::memcpy(out, v, 32);
    out += 32;
    left -= 32;
  }
  Blake2b c(left);
  c.update(v, 64);
  c.final(out);
}

// ------------------------------------------------------------- Argon2i

constexpr int kWords = 128;  // 1 KiB block of 64-bit words
constexpr uint32_t kSync = 4;
constexpr uint32_t kVersion = 0x13;
constexpr uint32_t kTypeI = 1;

struct Block {
  uint64_t v[kWords];
};

inline uint64_t blamka(uint64_t x, uint64_t y) {
  return x + y + 2 * ((x & 0xFFFFFFFFULL) * (y & 0xFFFFFFFFULL));
}

#define GB(a, b, c, d)          \
  a = blamka(a, b);             \
  d = rotr64(d ^ a, 32);        \
  c = blamka(c, d);             \
  b = rotr64(b ^ c, 24);        \
  a = blamka(a, b);             \
  d = rotr64(d ^ a, 16);        \
  c = blamka(c, d);             \
  b = rotr64(b ^ c, 63);

#define ROUND(v0, v1, v2, v3, v4, v5, v6, v7, v8, v9, v10, v11, v12, v13, \
              v14, v15)                                                   \
  GB(v0, v4, v8, v12);                                                    \
  GB(v1, v5, v9, v13);                                                    \
  GB(v2, v6, v10, v14);                                                   \
  GB(v3, v7, v11, v15);                                                   \
  GB(v0, v5, v10, v15);                                                   \
  GB(v1, v6, v11, v12);                                                   \
  GB(v2, v7, v8, v13);                                                    \
  GB(v3, v4, v9, v14);

// next = P(prev ^ ref) ^ prev ^ ref, XORed into next when with_xor.
void fill_block(const Block& prev, const Block& ref, Block& next,
                bool with_xor) {
  Block r, tmp;
  for (int i = 0; i < kWords; ++i) r.v[i] = prev.v[i] ^ ref.v[i];
  tmp = r;
  if (with_xor)
    for (int i = 0; i < kWords; ++i) tmp.v[i] ^= next.v[i];
  uint64_t* v = r.v;
  for (int i = 0; i < 8; ++i) {
    uint64_t* q = v + 16 * i;
    ROUND(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10],
          q[11], q[12], q[13], q[14], q[15]);
  }
  for (int i = 0; i < 8; ++i) {
    uint64_t* q = v + 2 * i;
    ROUND(q[0], q[1], q[16], q[17], q[32], q[33], q[48], q[49], q[64],
          q[65], q[80], q[81], q[96], q[97], q[112], q[113]);
  }
  for (int i = 0; i < kWords; ++i) next.v[i] = tmp.v[i] ^ r.v[i];
}

struct Instance {
  std::vector<Block> mem;
  uint32_t passes, lanes, lane_length, segment_length, memory_blocks;
};

uint32_t index_alpha(const Instance& in, uint32_t pass, uint32_t slice,
                     uint32_t index, uint32_t pseudo_rand, bool same_lane) {
  uint32_t area;
  if (pass == 0) {
    if (slice == 0)
      area = index - 1;
    else if (same_lane)
      area = slice * in.segment_length + index - 1;
    else
      area = slice * in.segment_length + (index == 0 ? uint32_t(-1) : 0);
  } else if (same_lane) {
    area = in.lane_length - in.segment_length + index - 1;
  } else {
    area = in.lane_length - in.segment_length +
           (index == 0 ? uint32_t(-1) : 0);
  }
  uint64_t rel = pseudo_rand;
  rel = (rel * rel) >> 32;
  rel = area - 1 - ((uint64_t(area) * rel) >> 32);
  uint32_t start = 0;
  if (pass != 0 && slice != kSync - 1) start = (slice + 1) * in.segment_length;
  return uint32_t((start + rel) % in.lane_length);
}

void next_addresses(Block& address, Block& input, const Block& zero) {
  input.v[6]++;
  fill_block(zero, input, address, false);
  fill_block(zero, address, address, false);
}

void fill_segment(Instance& in, uint32_t pass, uint32_t lane,
                  uint32_t slice) {
  Block address, input, zero;
  std::memset(&zero, 0, sizeof zero);
  std::memset(&input, 0, sizeof input);
  std::memset(&address, 0, sizeof address);
  input.v[0] = pass;
  input.v[1] = lane;
  input.v[2] = slice;
  input.v[3] = in.memory_blocks;
  input.v[4] = in.passes;
  input.v[5] = kTypeI;
  uint32_t start = 0;
  if (pass == 0 && slice == 0) {
    start = 2;
    next_addresses(address, input, zero);
  }
  uint32_t curr = lane * in.lane_length + slice * in.segment_length + start;
  uint32_t prev =
      (curr % in.lane_length == 0) ? curr + in.lane_length - 1 : curr - 1;
  for (uint32_t i = start; i < in.segment_length; ++i, ++curr, ++prev) {
    if (curr % in.lane_length == 1) prev = curr - 1;
    if (i % kWords == 0) next_addresses(address, input, zero);
    uint64_t pseudo = address.v[i % kWords];
    uint32_t ref_lane = uint32_t((pseudo >> 32) % in.lanes);
    if (pass == 0 && slice == 0) ref_lane = lane;
    uint32_t ref_index = index_alpha(in, pass, slice, i,
                                     uint32_t(pseudo & 0xFFFFFFFFULL),
                                     ref_lane == lane);
    const Block& ref = in.mem[size_t(in.lane_length) * ref_lane + ref_index];
    fill_block(in.mem[prev], ref, in.mem[curr], pass != 0);
  }
}

}  // namespace

extern "C" int argon2i_hash_raw(uint32_t t_cost, uint32_t m_cost,
                                uint32_t lanes, const uint8_t* pwd,
                                uint64_t pwdlen, const uint8_t* salt,
                                uint64_t saltlen, const uint8_t* secret,
                                uint64_t secretlen, const uint8_t* ad,
                                uint64_t adlen, uint8_t* out,
                                uint64_t outlen) {
  if (t_cost < 1 || lanes < 1 || outlen < 4 || saltlen < 8 ||
      m_cost < 8 * lanes)
    return -1;
  Instance in;
  uint32_t blocks = m_cost;
  if (blocks < 2 * kSync * lanes) blocks = 2 * kSync * lanes;
  in.segment_length = blocks / (lanes * kSync);
  in.memory_blocks = in.segment_length * lanes * kSync;
  in.lane_length = in.segment_length * kSync;
  in.passes = t_cost;
  in.lanes = lanes;
  try {
    in.mem.resize(in.memory_blocks);
  } catch (...) {
    return -2;
  }

  // H0 over the parameters and inputs, then the first two blocks of
  // every lane.
  uint8_t seed[72];
  {
    Blake2b b(64);
    b.update32(lanes);
    b.update32(uint32_t(outlen));
    b.update32(m_cost);
    b.update32(t_cost);
    b.update32(kVersion);
    b.update32(kTypeI);
    b.update32(uint32_t(pwdlen));
    b.update(pwd, pwdlen);
    b.update32(uint32_t(saltlen));
    b.update(salt, saltlen);
    b.update32(uint32_t(secretlen));
    b.update(secret, secretlen);
    b.update32(uint32_t(adlen));
    b.update(ad, adlen);
    b.final(seed);
  }
  uint8_t bytes[1024];
  for (uint32_t l = 0; l < lanes; ++l) {
    for (uint32_t j = 0; j < 2; ++j) {
      store32(seed + 64, j);
      store32(seed + 68, l);
      blake2b_long(bytes, 1024, seed, 72);
      Block& blk = in.mem[size_t(l) * in.lane_length + j];
      for (int w = 0; w < kWords; ++w) blk.v[w] = load64(bytes + 8 * w);
    }
  }

  for (uint32_t pass = 0; pass < t_cost; ++pass)
    for (uint32_t slice = 0; slice < kSync; ++slice)
      for (uint32_t lane = 0; lane < lanes; ++lane)
        fill_segment(in, pass, lane, slice);

  Block last = in.mem[in.lane_length - 1];
  for (uint32_t l = 1; l < lanes; ++l) {
    const Block& b = in.mem[size_t(l) * in.lane_length + in.lane_length - 1];
    for (int w = 0; w < kWords; ++w) last.v[w] ^= b.v[w];
  }
  for (int w = 0; w < kWords; ++w) store64(bytes + 8 * w, last.v[w]);
  blake2b_long(out, outlen, bytes, 1024);
  return 0;
}

// Native host-side batch planning for the port (dopt_torch), a copy of
// dopt/native/plan.cpp: the same C interface, the same draws.
//
// The engines consume per-round [workers, steps, batch] gather-index
// plans (dopt_torch/data/pipeline.py).  Generating those plans is the only
// per-round host-side loop in the framework; this library fills the plan
// buffers in C++ (one Fisher-Yates shuffle per (round, epoch, worker))
// so large fleets (hundreds of workers × many local epochs) never
// bottleneck on the Python/numpy loop.
//
// Determinism: a SplitMix64-seeded xoshiro256** stream per
// (seed, round_idx, epoch, worker) — reproducible across runs and
// platforms, but intentionally NOT bit-identical to the numpy
// PCG64 path (the numpy path remains the torch-oracle-parity mode;
// this is the throughput mode).  Same contract otherwise: every epoch
// block is a permutation of the worker's index row, wraparound padding
// with 0-weight mask tail.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (see
// dopt_torch/native/__init__.py, which builds at first use into
// build/dopt_torch/native/<source hash>/ and raises if it cannot).

#include <cstdint>
#include <cstring>

namespace {

// SplitMix64: seeds the xoshiro state from a packed key.
inline uint64_t splitmix64(uint64_t &x) {
  x += 0x9E3779B97F4A7C15ULL;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

struct Xoshiro256ss {
  uint64_t s[4];

  explicit Xoshiro256ss(uint64_t seed) {
    uint64_t sm = seed;
    for (int i = 0; i < 4; ++i) s[i] = splitmix64(sm);
  }

  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  inline uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // Unbiased bounded draw (Lemire's method).
  inline uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * (__uint128_t)n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (0ULL - n) % n;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * (__uint128_t)n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

inline uint64_t mix_key(int64_t seed, int64_t round_idx, int64_t ep,
                        int64_t worker) {
  // Feed the four key components through SplitMix64 sequentially — the
  // same construction style as numpy's SeedSequence (hash-mix of an
  // entropy list), collision-free in practice for experiment-sized keys.
  uint64_t x = 0x243F6A8885A308D3ULL;  // pi fraction, arbitrary non-zero
  uint64_t acc = splitmix64(x) ^ (uint64_t)seed;
  x = acc;
  acc = splitmix64(x) ^ (uint64_t)round_idx;
  x = acc;
  acc = splitmix64(x) ^ (uint64_t)ep;
  x = acc;
  acc = splitmix64(x) ^ (uint64_t)worker;
  return acc;
}

}  // namespace

extern "C" {

// Fill one round's plan.
//   index_matrix : [num_workers, row_len] int32 per-worker dataset indices
//   worker_ids   : nullable [num_workers] int64 — the TRUE worker id of each
//                  row, used as the RNG key component.  Null means row i is
//                  worker i.  Passing a subset of rows with their real ids
//                  yields plans bit-identical to the matching rows of the
//                  full-fleet plan (compact-sampling fast path).
//   idx_out      : [num_workers, local_ep * steps_per_epoch, batch] int32
//   w_out        : [num_workers, local_ep * steps_per_epoch, batch] float32
// steps_per_epoch = ceil(row_len / batch) (drop_last=0) or
//                   row_len / batch       (drop_last=1), computed by caller;
// padded tail (drop_last=0) wraps around with weight 0.
// scratch: caller-provided [row_len + pad] int32 workspace per thread
// (we allocate internally instead to keep the ABI simple).
// Returns 0 on success, nonzero on bad arguments.
int dopt_fill_batch_plan(const int32_t *index_matrix, int64_t num_workers,
                         int64_t row_len, int64_t batch, int64_t local_ep,
                         int64_t steps_per_epoch, int32_t drop_last,
                         int64_t seed, int64_t round_idx,
                         const int64_t *worker_ids, int32_t *idx_out,
                         float *w_out) {
  if (!index_matrix || !idx_out || !w_out) return 1;
  if (num_workers <= 0 || row_len <= 0 || batch <= 0 || local_ep <= 0 ||
      steps_per_epoch <= 0)
    return 2;
  const int64_t padded = steps_per_epoch * batch;
  if (drop_last && padded > row_len) return 3;
  if (!drop_last && (padded < row_len || padded - batch >= row_len)) return 4;

  const int64_t ep_stride = padded;                 // per-epoch output elems
  const int64_t worker_stride = local_ep * padded;  // per-worker output elems

  int32_t *perm = new int32_t[row_len];
  for (int64_t wi = 0; wi < num_workers; ++wi) {
    const int32_t *row = index_matrix + wi * row_len;
    const int64_t wid = worker_ids ? worker_ids[wi] : wi;
    for (int64_t ep = 0; ep < local_ep; ++ep) {
      Xoshiro256ss rng(mix_key(seed, round_idx, ep, wid));
      std::memcpy(perm, row, sizeof(int32_t) * (size_t)row_len);
      // Fisher-Yates over the copied row.
      for (int64_t i = row_len - 1; i > 0; --i) {
        int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
        int32_t t = perm[i];
        perm[i] = perm[j];
        perm[j] = t;
      }
      int32_t *out = idx_out + wi * worker_stride + ep * ep_stride;
      float *wout = w_out + wi * worker_stride + ep * ep_stride;
      for (int64_t k = 0; k < padded; ++k) {
        if (k < row_len) {
          out[k] = perm[k];
          wout[k] = 1.0f;
        } else {  // wraparound padding, masked out of the math
          out[k] = perm[k - row_len];
          wout[k] = 0.0f;
        }
      }
    }
  }
  delete[] perm;
  return 0;
}

// Library version tag so the Python side can detect stale cached builds.
int dopt_native_abi_version() { return 2; }

}  // extern "C"

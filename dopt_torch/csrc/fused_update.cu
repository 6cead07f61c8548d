// Hand-written Hopper (sm_90a) kernels for the two bandwidth-bound
// update ops of dopt's training round, with a plain C interface that
// dopt_torch/ops/fused_update.py loads through ctypes.
//
// 1. fused_sgd_momentum — replaces dopt/ops/fused_update.py
//    `fused_sgd_momentum` (Pallas body `_make_kernel`).  Per element,
//    in f32:  buf = mu*m + g;  m = buf;  p = p - lr*buf;  in place.
//    Bound on the H100: bytes.  20 bytes an f32 element (read p, m, g;
//    write p, m) and 4 FLOPs, so 0.2 FLOP/byte against a ridge of
//    ~20 FLOP/byte at f32.  Design: ONE launch covers every tensor of a
//    step (a multi-tensor list passed by value as a kernel argument, up
//    to kMaxTensors), blocks walk 16-byte-per-thread tiles in a
//    grid-stride loop with 16-byte vector loads/stores where all three
//    pointers allow, and a scalar guard on each tensor's ragged tail.
//    The TPU kernel launched once per leaf on [rows, 128] tiles; on
//    Hopper the per-launch cost matters more, so the leaves share one.
//    The gated instantiation (dopt_fused_sgd_momentum_gated) takes the
//    straggler budget: lane w of every [lanes, ...] tensor updates only
//    while step < limit[w]; a gated-off lane skips its loads and stores
//    (dopt computes the update and then selects the old value; that
//    select costs this kernel no traffic).
//
// 2. fused_mix_sgd — replaces dopt/ops/fused_update.py `fused_mix_sgd`
//    (Pallas body `_make_mix_kernel`).  On one [n, F] flat bucket:
//    p = W @ p - lr*buf, W [n, n] f32, n <= 32, accumulation f32, in
//    place.  Bound on the H100: bytes.  12 bytes an f32 element (read p,
//    buf; write p) against 2n+2 FLOPs: at most 5.5 FLOP/byte at n = 32,
//    under the f32 ridge of ~20 FLOP/byte.  The TPU ran the product on
//    its MXU; tensor cores do not apply here: TF32 would break the f32
//    contract, and the product is nowhere near compute-bound.  The work
//    is to keep enough bytes in flight and to add no traffic of its own.
//    No thread holds W across columns.  The design this replaces ran a
//    grid-stride column loop with its i/j loops fully unrolled over a
//    compile-time NMAX: every W read had a constant index, so the
//    compiler hoisted all NMAX^2 of them out of the loop into per-thread
//    storage.  At NMAX = 32 that took 255 registers, a 3.5 KB stack frame
//    and ~3.6 KB of spills reloaded every column, and n = 16 ran at 2% of
//    its bound.  Two kernels now, by n:
//    - n <= 8, mix_sgd_narrow_kernel: one thread, one 4-column pack, all
//      2n row loads in flight at once, W in shared memory.  There is no
//      column loop, so each W read stays where it is used (85 registers,
//      no spills, where the looped version took 128 and spilled).
//    - 9 <= n <= 32, mix_sgd_ring_kernel: persistent blocks walk [n, BF]
//      column tiles.  Each tile of p and buf arrives in a kMixStages-deep
//      shared-memory ring by 16-byte cp.async, issued two tiles ahead of
//      the one being computed.  A thread computes a kMixRows x 4 block of
//      outputs: its accumulators live in registers, it reads x[j][cols]
//      from the ring once for all kMixRows rows, and it reads
//      W^T[j][rows] from shared memory as a warp-wide broadcast inside a
//      j loop whose trip count is the runtime n.  Registers do not grow
//      with n.  In place is race-free: a tile's outputs are written after
//      its loads have landed, and tiles are disjoint column ranges.
//    The ring kernel also runs n <= 8 correctly, but slower than the
//    narrow one at n = 6 (chip_smoke.py times the two in turns), so the
//    wrapper sends n <= 8 to the narrow kernel.
//    Rows may be strided (a bucket is a column range of the trainer's
//    [n, padded] flat store), columns are unit-stride.  The ragged tail,
//    and buckets whose rows are not aligned, take each kernel's scalar
//    path (the ring kernel: plain loads into the ring, guarded stores).
//
// Storage is f32 or bf16 (dtype code 0 / 1); math is always f32.  Each
// entry point launches exactly one kernel on the caller's stream and
// returns cudaGetLastError(), or returns cudaErrorInvalidValue without
// launching for arguments it refuses (empty work included), so a return
// of 0 means one launch and a refused launch is never silent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 16;
constexpr int kMaxBlocks = 4096;
constexpr int kMixMaxN = 32;

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// ---------------------------------------------------------------------
// 1. Multi-tensor momentum SGD
// ---------------------------------------------------------------------

struct SgdList {
  void* p[kMaxTensors];
  void* m[kMaxTensors];
  const void* g[kMaxTensors];
  int64_t size[kMaxTensors];
  int64_t lane_elems[kMaxTensors];      // elements a lane (the gate)
  int64_t tile_start[kMaxTensors + 1];  // prefix sums of per-tensor tiles
  int vec_ok[kMaxTensors];
  int count;
};

// The plain PyTorch version rounds each op separately (m*mu, +g, lr*buf,
// p-...), so the kernel does too: _rn intrinsics are never contracted
// into FMAs, which makes the f32 kernel bit-identical to it.
__device__ __forceinline__ void sgd_math(float& p, float& m, float g,
                                         float lr, float mu) {
  float buf = __fadd_rn(__fmul_rn(m, mu), g);
  m = buf;
  p = __fsub_rn(p, __fmul_rn(lr, buf));
}

// The straggler gate (GATED): every tensor of the list is [lanes, ...]
// with lane_elems elements a lane, and lane w updates only while
// step < limit[w] (dopt freezes a straggler's params and momentum from
// step limit[w] on, selecting the old value after the update).  A
// gated-off lane skips its loads and stores, so its p and m keep their
// bits.  A 16-byte pack inside one lane takes one decision; a pack that
// straddles two lanes (lane_elems not a multiple of VEC) takes the
// scalar path, which decides per element.  GATED = false is the ungated
// instantiation, unchanged.
template <typename T, int VEC, bool GATED>
__global__ void __launch_bounds__(kThreads)
    sgd_momentum_kernel(const SgdList list, float lr, float mu,
                        const int* __restrict__ limit, int64_t step) {
  constexpr int64_t kTile = int64_t(kThreads) * VEC;
  const int64_t total = list.tile_start[list.count];
  for (int64_t tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int t = 0;
    while (tile >= list.tile_start[t + 1]) ++t;
    T* p = static_cast<T*>(list.p[t]);
    T* m = static_cast<T*>(list.m[t]);
    const T* g = static_cast<const T*>(list.g[t]);
    const int64_t size = list.size[t];
    const int64_t i =
        (tile - list.tile_start[t]) * kTile + int64_t(threadIdx.x) * VEC;
    bool whole = list.vec_ok[t] && i + VEC <= size;
    if (GATED && whole) {
      const int64_t lane0 = i / list.lane_elems[t];
      if (lane0 == (i + VEC - 1) / list.lane_elems[t]) {
        if (step >= limit[lane0]) continue;
      } else {
        whole = false;
      }
    }
    if (whole) {
      Pack<T, VEC> pv = *reinterpret_cast<const Pack<T, VEC>*>(p + i);
      Pack<T, VEC> mv = *reinterpret_cast<const Pack<T, VEC>*>(m + i);
      const Pack<T, VEC> gv = *reinterpret_cast<const Pack<T, VEC>*>(g + i);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float pf = Cvt<T>::load(pv.v[k]);
        float mf = Cvt<T>::load(mv.v[k]);
        sgd_math(pf, mf, Cvt<T>::load(gv.v[k]), lr, mu);
        pv.v[k] = Cvt<T>::store(pf);
        mv.v[k] = Cvt<T>::store(mf);
      }
      *reinterpret_cast<Pack<T, VEC>*>(p + i) = pv;
      *reinterpret_cast<Pack<T, VEC>*>(m + i) = mv;
    } else {
      for (int k = 0; k < VEC; ++k) {
        const int64_t j = i + k;
        if (j >= size) break;
        if (GATED && step >= limit[j / list.lane_elems[t]]) continue;
        float pf = Cvt<T>::load(p[j]);
        float mf = Cvt<T>::load(m[j]);
        sgd_math(pf, mf, Cvt<T>::load(g[j]), lr, mu);
        p[j] = Cvt<T>::store(pf);
        m[j] = Cvt<T>::store(mf);
      }
    }
  }
}

// limit == nullptr launches the ungated kernel; otherwise every tensor
// is [lanes, ...] and lane w updates while step < limit[w].
template <typename T>
cudaError_t launch_sgd(int count, void* const* p, void* const* m,
                       const void* const* g, const int64_t* sizes, float lr,
                       float mu, const int* limit, int64_t lanes,
                       int64_t step, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int64_t kTile = int64_t(kThreads) * VEC;
  SgdList list;
  list.count = count;
  list.tile_start[0] = 0;
  if (limit != nullptr && lanes < 1) return cudaErrorInvalidValue;
  for (int t = 0; t < count; ++t) {
    if (sizes[t] < 0) return cudaErrorInvalidValue;
    if (limit != nullptr && (sizes[t] % lanes) != 0)
      return cudaErrorInvalidValue;
    list.p[t] = p[t];
    list.m[t] = m[t];
    list.g[t] = g[t];
    list.size[t] = sizes[t];
    list.lane_elems[t] = limit != nullptr ? sizes[t] / lanes : 1;
    if (list.lane_elems[t] < 1) list.lane_elems[t] = 1;
    list.vec_ok[t] = ((reinterpret_cast<uintptr_t>(p[t]) |
                       reinterpret_cast<uintptr_t>(m[t]) |
                       reinterpret_cast<uintptr_t>(g[t])) % 16) == 0;
    list.tile_start[t + 1] = list.tile_start[t] + (sizes[t] + kTile - 1) / kTile;
  }
  const int64_t tiles = list.tile_start[count];
  if (tiles == 0) return cudaErrorInvalidValue;  // nothing to launch
  const int blocks = int(tiles < kMaxBlocks ? tiles : kMaxBlocks);
  if (limit == nullptr)
    sgd_momentum_kernel<T, VEC, false>
        <<<blocks, kThreads, 0, stream>>>(list, lr, mu, nullptr, 0);
  else
    sgd_momentum_kernel<T, VEC, true>
        <<<blocks, kThreads, 0, stream>>>(list, lr, mu, limit, step);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// 2. Fused mix + update over one flat bucket
// ---------------------------------------------------------------------

// -- n <= 8: a 4-column pack a thread ---------------------------------

constexpr int kNarrowN = 8;
constexpr int kNarrowVec = 4;
constexpr int kNarrowThreads = 256;

template <typename T, int VEC>
__device__ __forceinline__ void load_cols(const T* row, int64_t col,
                                          int64_t f, bool vec, float* out) {
  if (vec && col + VEC <= f) {
    const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(row + col);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = Cvt<T>::load(v.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      out[k] = col + k < f ? Cvt<T>::load(row[col + k]) : 0.0f;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_cols(T* row, int64_t col, int64_t f,
                                           bool vec, const float* in) {
  if (vec && col + VEC <= f) {
    Pack<T, VEC> v;
#pragma unroll
    for (int k = 0; k < VEC; ++k) v.v[k] = Cvt<T>::store(in[k]);
    *reinterpret_cast<Pack<T, VEC>*>(row + col) = v;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (col + k < f) row[col + k] = Cvt<T>::store(in[k]);
  }
}

// The column stacks x and b [kNarrowN][kNarrowVec] live in registers;
// rows j >= n are skipped by the runtime guards.  All 2n row loads are
// issued before any FMA, so a thread's whole input is in flight at once.
// The cap of two blocks an SM (128 registers) leaves room to spare: with
// no column loop to hoist W out of, ptxas gives it 85 registers (f32,
// sm_90a) and no spills.
template <typename T>
__global__ void __launch_bounds__(kNarrowThreads, 2)
    mix_sgd_narrow_kernel(T* __restrict__ p, int64_t ldp,
                          const T* __restrict__ buf, int64_t ldb,
                          const float* __restrict__ w, int n, int64_t f,
                          float lr, int vec) {
  __shared__ float ws[kNarrowN * kNarrowN];
  for (int k = threadIdx.x; k < kNarrowN * kNarrowN; k += blockDim.x) {
    const int i = k / kNarrowN, j = k % kNarrowN;
    ws[k] = (i < n && j < n) ? w[i * n + j] : 0.0f;
  }
  __syncthreads();
  const int64_t col =
      (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) * kNarrowVec;
  if (col >= f) return;
  float x[kNarrowN][kNarrowVec];
  float b[kNarrowN][kNarrowVec];
#pragma unroll
  for (int j = 0; j < kNarrowN; ++j) {
    if (j < n) {
      load_cols<T, kNarrowVec>(p + j * ldp, col, f, vec, x[j]);
      load_cols<T, kNarrowVec>(buf + j * ldb, col, f, vec, b[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < kNarrowN; ++i) {
    if (i >= n) break;
    float acc[kNarrowVec];
#pragma unroll
    for (int k = 0; k < kNarrowVec; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < kNarrowN; ++j) {
      if (j < n) {
        const float wij = ws[i * kNarrowN + j];
#pragma unroll
        for (int k = 0; k < kNarrowVec; ++k)
          acc[k] = fmaf(wij, x[j][k], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kNarrowVec; ++k)
      acc[k] = __fsub_rn(acc[k], __fmul_rn(lr, b[i][k]));
    store_cols<T, kNarrowVec>(p + i * ldp, col, f, vec, acc);
  }
}

template <typename T>
cudaError_t launch_mix_narrow(T* p, int64_t ldp, const T* buf, int64_t ldb,
                              const float* w, int n, int64_t f, float lr,
                              cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(buf)) %
                        (sizeof(T) * kNarrowVec) ==
                    0) &&
                   ldp % kNarrowVec == 0 && ldb % kNarrowVec == 0;
  const int64_t packs = (f + kNarrowVec - 1) / kNarrowVec;
  const int64_t blocks = (packs + kNarrowThreads - 1) / kNarrowThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  mix_sgd_narrow_kernel<T><<<int(blocks), kNarrowThreads, 0, stream>>>(
      p, ldp, buf, ldb, w, n, f, lr, vec ? 1 : 0);
  return cudaGetLastError();
}

// -- 9 <= n <= 32: column tiles through a shared-memory ring ----------

// The tile plan (tile width BF) is chosen by the wrapper
// (dopt_torch/ops/fused_update.py `mix_plan`), which mirrors these
// constants; the launch refuses a plan that breaks them.  512 threads
// and j unrolled by two: the fastest of the thread counts (128-512),
// unrolls (1, 2), rows a thread (4, 8) and ring depths (2-6) timed on an
// H100 SXM at n = 6-32.
constexpr int kMixThreads = 512;
constexpr int kMixRows = 8;     // output rows a thread (n <= 32: 4 groups)
constexpr int kMixStages = 3;   // depth of the shared-memory ring
constexpr int kMixWBytes = kMixMaxN * kMixMaxN * sizeof(float);
constexpr int kMixMaxSmem = 232448;  // 227 KB, a block's limit on sm_90

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ void load4(const T* src, float* out) {
  const Pack<T, 4> v = *reinterpret_cast<const Pack<T, 4>*>(src);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = Cvt<T>::load(v.v[k]);
}

// Copy one [n, bf] column tile of p and buf (starting at column col0)
// into a ring stage, 16 bytes a cp.async; rows are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void issue_tile(T* xs, T* bs, const T* p,
                                           int64_t ldp, const T* buf,
                                           int64_t ldb, int n, int bf,
                                           int64_t col0) {
  constexpr int kChunk = 16 / sizeof(T);
  const int shift = __ffs(bf / kChunk) - 1;  // bf is a power of two
  for (int c = threadIdx.x; c < n << shift; c += blockDim.x) {
    const int j = c >> shift, e = (c & ((1 << shift) - 1)) * kChunk;
    cp_async16(xs + j * bf + e, p + j * ldp + col0 + e);
    cp_async16(bs + j * bf + e, buf + j * ldb + col0 + e);
  }
}

// The synchronous twin of issue_tile for the ragged tail and unaligned
// rows: plain loads, zeros past column f.
template <typename T>
__device__ __forceinline__ void load_tile(T* xs, T* bs, const T* p,
                                          int64_t ldp, const T* buf,
                                          int64_t ldb, int n, int bf,
                                          int64_t col0, int64_t f) {
  for (int e = threadIdx.x; e < n * bf; e += blockDim.x) {
    const int j = e / bf;
    const int64_t col = col0 + (e - j * bf);
    xs[e] = col < f ? p[j * ldp + col] : Cvt<T>::store(0.0f);
    bs[e] = col < f ? buf[j * ldb + col] : Cvt<T>::store(0.0f);
  }
}

// out = W @ x - lr*b on one staged tile, written to p at column col0.
// wt is W transposed, zero past n: wt[j*kMixMaxN + i] = W[i][j].  The
// sum over j runs in order 0..n-1 from 0 by fmaf, then the subtract is
// rounded on its own, as in the kernel this design replaces.
template <typename T, bool kVec>
__device__ __forceinline__ void mix_tile(const float* wt, const T* xs,
                                         const T* bs, T* p, int64_t ldp,
                                         int n, int bf, int64_t col0,
                                         int64_t f, float lr) {
  const int shift = __ffs(bf / 4) - 1;  // quads a row; bf a power of two
  const int items = (n + kMixRows - 1) / kMixRows << shift;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int r0 = (it >> shift) * kMixRows;
    const int c = (it & ((1 << shift) - 1)) * 4;
    float acc[kMixRows][4] = {};
    // A runtime trip count: the W reads below stay inside the loop.
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      float x[4];
      load4(xs + j * bf + c, x);
      const float* wr = wt + j * kMixMaxN + r0;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
      const float wj[kMixRows] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < kMixRows; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(wj[i], x[k], acc[i][k]);
    }
#pragma unroll
    for (int i = 0; i < kMixRows; ++i) {
      const int row = r0 + i;
      if (row >= n) break;
      float b[4];
      load4(bs + row * bf + c, b);
      T* dst = p + row * ldp + col0 + c;
      if (kVec) {
        Pack<T, 4> v;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v.v[k] = Cvt<T>::store(__fsub_rn(acc[i][k], __fmul_rn(lr, b[k])));
        *reinterpret_cast<Pack<T, 4>*>(dst) = v;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col0 + c + k < f)
            dst[k] = Cvt<T>::store(__fsub_rn(acc[i][k], __fmul_rn(lr, b[k])));
      }
    }
  }
}

// Tiles [0, ring_tiles) are whole and aligned and go through the
// cp.async ring; tiles [ring_tiles, ceil(f/bf)) through the synchronous
// path.  Block b takes tiles b, b + grid, ... across both ranges.
template <typename T>
__global__ void __launch_bounds__(kMixThreads)
    mix_sgd_ring_kernel(T* __restrict__ p, int64_t ldp,
                        const T* __restrict__ buf, int64_t ldb,
                        const float* __restrict__ w, int n, int64_t f,
                        float lr, int bf, int64_t ring_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wt = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + kMixWBytes);
  const int stage_elems = 2 * n * bf;
  for (int k = threadIdx.x; k < kMixMaxN * kMixMaxN; k += blockDim.x) {
    const int j = k / kMixMaxN, i = k % kMixMaxN;
    wt[k] = (i < n && j < n) ? w[i * n + j] : 0.0f;
  }
  __syncthreads();

  const int64_t grid = gridDim.x;
  int64_t next = blockIdx.x;
  for (int s = 0; s < kMixStages - 1; ++s, next += grid) {
    if (next < ring_tiles)
      issue_tile(ring + s * stage_elems, ring + s * stage_elems + n * bf, p,
                 ldp, buf, ldb, n, bf, next * bf);
    cp_async_commit();
  }
  int stage = 0;
  for (int64_t t = blockIdx.x; t < ring_tiles; t += grid, next += grid) {
    // Refill the stage computed last iteration (its readers passed the
    // barrier at the end of that iteration).
    const int fill = (stage + kMixStages - 1) % kMixStages;
    if (next < ring_tiles)
      issue_tile(ring + fill * stage_elems,
                 ring + fill * stage_elems + n * bf, p, ldp, buf, ldb, n,
                 bf, next * bf);
    cp_async_commit();
    cp_async_wait<kMixStages - 1>();  // this tile's group has landed
    __syncthreads();
    T* xs = ring + stage * stage_elems;
    mix_tile<T, true>(wt, xs, xs + n * bf, p, ldp, n, bf, t * bf, f, lr);
    __syncthreads();
    stage = (stage + 1) % kMixStages;
  }
  cp_async_wait<0>();

  const int64_t tiles = (f + bf - 1) / bf;
  for (int64_t t = ring_tiles + (blockIdx.x - ring_tiles % grid + grid) % grid;
       t < tiles; t += grid) {
    load_tile(ring, ring + n * bf, p, ldp, buf, ldb, n, bf, t * bf, f);
    __syncthreads();
    mix_tile<T, false>(wt, ring, ring + n * bf, p, ldp, n, bf, t * bf, f, lr);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_mix_ring(T* p, int64_t ldp, const T* buf, int64_t ldb,
                            const float* w, int n, int64_t f, float lr,
                            int bf, cudaStream_t stream) {
  if (bf < 32 || (bf & (bf - 1)) != 0) return cudaErrorInvalidValue;
  const int64_t smem =
      kMixWBytes + int64_t(kMixStages) * 2 * n * bf * int64_t(sizeof(T));
  if (smem > kMixMaxSmem) return cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(buf)) % 16 == 0) &&
                       (ldp * int64_t(sizeof(T))) % 16 == 0 &&
                       (ldb * int64_t(sizeof(T))) % 16 == 0;
  const int64_t tiles = (f + bf - 1) / bf;
  const int64_t ring_tiles = aligned ? f / bf : 0;
  auto kernel = mix_sgd_ring_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kMixThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t resident = int64_t(per_sm) * sms;
  const int blocks = int(tiles < resident ? tiles : resident);
  mix_sgd_ring_kernel<T><<<blocks, kMixThreads, smem, stream>>>(
      p, ldp, buf, ldb, w, n, f, lr, bf, ring_tiles);
  return cudaGetLastError();
}

// One launch a bucket: bf == 0 takes the narrow kernel (n <= kNarrowN),
// bf > 0 the ring kernel with tiles of bf columns (any n).
template <typename T>
cudaError_t launch_mix(T* p, int64_t ldp, const T* buf, int64_t ldb,
                       const float* w, int n, int64_t f, float lr, int bf,
                       cudaStream_t stream) {
  if (bf == 0) {
    if (n > kNarrowN) return cudaErrorInvalidValue;
    return launch_mix_narrow<T>(p, ldp, buf, ldb, w, n, f, lr, stream);
  }
  return launch_mix_ring<T>(p, ldp, buf, ldb, w, n, f, lr, bf, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  p/m/g: host arrays of `count`
// device pointers; sizes: host array of element counts.
int dopt_fused_sgd_momentum(int count, void* const* p, void* const* m,
                            const void* const* g, const int64_t* sizes,
                            int dtype, float lr, float mu, void* stream) {
  if (count < 1 || count > kMaxTensors) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sgd<float>(count, p, m, g, sizes, lr, mu, nullptr, 0, 0, s);
  if (dtype == 1)
    return launch_sgd<__nv_bfloat16>(count, p, m, g, sizes, lr, mu, nullptr,
                                     0, 0, s);
  return cudaErrorInvalidValue;
}

// The straggler-gated step: as dopt_fused_sgd_momentum, with every
// tensor [lanes, ...] and limit a device array of `lanes` int32 step
// budgets; lane w updates only while step < limit[w].
int dopt_fused_sgd_momentum_gated(int count, void* const* p, void* const* m,
                                  const void* const* g, const int64_t* sizes,
                                  int dtype, float lr, float mu,
                                  const int* limit, int64_t lanes,
                                  int64_t step, void* stream) {
  if (count < 1 || count > kMaxTensors || limit == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_sgd<float>(count, p, m, g, sizes, lr, mu, limit, lanes,
                             step, s);
  if (dtype == 1)
    return launch_sgd<__nv_bfloat16>(count, p, m, g, sizes, lr, mu, limit,
                                     lanes, step, s);
  return cudaErrorInvalidValue;
}

// p, buf: [n, f] with row strides ldp, ldb (elements) and unit column
// stride; w: [n, n] row-major float32 on the device; bf: 0 for the
// narrow kernel (n <= 8), else the ring kernel's tile width in columns (a
// power of two, at least 32, whose ring fits in kMixMaxSmem).
int dopt_fused_mix_sgd(void* p, int64_t ldp, const void* buf, int64_t ldb,
                       const float* w, int n, int64_t f, int dtype, float lr,
                       int bf, void* stream) {
  if (n < 1 || n > kMixMaxN || f < 1 || ldp < f || ldb < f)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mix<float>(static_cast<float*>(p), ldp,
                             static_cast<const float*>(buf), ldb, w, n, f, lr,
                             bf, s);
  if (dtype == 1)
    return launch_mix<__nv_bfloat16>(static_cast<__nv_bfloat16*>(p), ldp,
                                     static_cast<const __nv_bfloat16*>(buf),
                                     ldb, w, n, f, lr, bf, s);
  return cudaErrorInvalidValue;
}

const char* dopt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
//
// 2. fused_mix_sgd — replaces dopt/ops/fused_update.py `fused_mix_sgd`
//    (Pallas body `_make_mix_kernel`).  On one [n, F] flat bucket:
//    p = W @ p - lr*buf, W [n, n] f32, accumulation f32, in place.
//    Bound on the H100: bytes.  12 bytes an f32 element (read p, buf;
//    write p) against 2n+2 FLOPs, so under 6 FLOP/byte for n <= 32.
//    The TPU ran the [n,n]x[n,BF] product on the MXU; n <= 32 is far
//    too narrow for tensor cores, so here each thread owns VEC columns:
//    it loads p[0..n-1, cols] and buf[0..n-1, cols] into registers,
//    computes all n outputs with FMAs against W held in shared memory,
//    then writes them back.
//    In place is race-free because no other thread touches those
//    columns.  Rows may be strided (a bucket is a column range of the
//    trainer's [n, padded] flat store), columns are unit-stride.
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    sgd_momentum_kernel(const SgdList list, float lr, float mu) {
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
    if (list.vec_ok[t] && i + VEC <= size) {
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
        float pf = Cvt<T>::load(p[j]);
        float mf = Cvt<T>::load(m[j]);
        sgd_math(pf, mf, Cvt<T>::load(g[j]), lr, mu);
        p[j] = Cvt<T>::store(pf);
        m[j] = Cvt<T>::store(mf);
      }
    }
  }
}

template <typename T>
cudaError_t launch_sgd(int count, void* const* p, void* const* m,
                       const void* const* g, const int64_t* sizes, float lr,
                       float mu, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int64_t kTile = int64_t(kThreads) * VEC;
  SgdList list;
  list.count = count;
  list.tile_start[0] = 0;
  for (int t = 0; t < count; ++t) {
    if (sizes[t] < 0) return cudaErrorInvalidValue;
    list.p[t] = p[t];
    list.m[t] = m[t];
    list.g[t] = g[t];
    list.size[t] = sizes[t];
    list.vec_ok[t] = ((reinterpret_cast<uintptr_t>(p[t]) |
                       reinterpret_cast<uintptr_t>(m[t]) |
                       reinterpret_cast<uintptr_t>(g[t])) % 16) == 0;
    list.tile_start[t + 1] = list.tile_start[t] + (sizes[t] + kTile - 1) / kTile;
  }
  const int64_t tiles = list.tile_start[count];
  if (tiles == 0) return cudaErrorInvalidValue;  // nothing to launch
  const int blocks = int(tiles < kMaxBlocks ? tiles : kMaxBlocks);
  sgd_momentum_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(list, lr, mu);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// 2. Fused mix + update over one flat bucket
// ---------------------------------------------------------------------

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

// NMAX bounds n at compile time so the column stacks x and b [NMAX][VEC]
// live in registers; rows j >= n are skipped by the runtime guards.  All
// 2n row loads are issued before any FMA, so a thread's whole input is in
// flight at once.  MINB caps registers so MINB blocks fit on an SM: for
// n <= 8 two blocks (uncapped it took 142 registers, one block an SM, and
// ran the main path's epilogue in 90 us instead of 58 us, H100 SXM); the
// wider stacks keep one, since the cap made them spill kilobytes.
template <typename T, int NMAX, int VEC, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    mix_sgd_kernel(T* __restrict__ p, int64_t ldp, const T* __restrict__ buf,
                   int64_t ldb, const float* __restrict__ w, int n, int64_t f,
                   float lr, int vec) {
  __shared__ float ws[NMAX * NMAX];
  for (int k = threadIdx.x; k < NMAX * NMAX; k += blockDim.x) {
    const int i = k / NMAX, j = k % NMAX;
    ws[k] = (i < n && j < n) ? w[i * n + j] : 0.0f;
  }
  __syncthreads();
  const int64_t packs = (f + VEC - 1) / VEC;
  for (int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; c < packs;
       c += int64_t(gridDim.x) * blockDim.x) {
    const int64_t col = c * VEC;
    float x[NMAX][VEC];
    float b[NMAX][VEC];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        load_cols<T, VEC>(p + j * ldp, col, f, vec, x[j]);
        load_cols<T, VEC>(buf + j * ldb, col, f, vec, b[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i >= n) break;
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const float wij = ws[i * NMAX + j];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wij, x[j][k], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = __fsub_rn(acc[k], __fmul_rn(lr, b[i][k]));
      store_cols<T, VEC>(p + i * ldp, col, f, vec, acc);
    }
  }
}

template <typename T, int NMAX, int VEC, int MINB>
cudaError_t launch_mix_nv(T* p, int64_t ldp, const T* buf, int64_t ldb,
                          const float* w, int n, int64_t f, float lr,
                          cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(buf)) %
                        (sizeof(T) * VEC) ==
                    0) &&
                   ldp % VEC == 0 && ldb % VEC == 0;
  const int64_t packs = (f + VEC - 1) / VEC;
  int64_t blocks = (packs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  mix_sgd_kernel<T, NMAX, VEC, MINB><<<int(blocks), kThreads, 0, stream>>>(
      p, ldp, buf, ldb, w, n, f, lr, vec ? 1 : 0);
  return cudaGetLastError();
}

// The vector width is fixed per NMAX (registers: 2*NMAX*VEC floats of the
// column stacks); an unaligned bucket takes the same kernel's scalar path.
// Two instantiations: n <= 8 (the slice's six workers) and n <= 32.
template <typename T>
cudaError_t launch_mix(T* p, int64_t ldp, const T* buf, int64_t ldb,
                       const float* w, int n, int64_t f, float lr,
                       cudaStream_t stream) {
  if (n <= 8)
    return launch_mix_nv<T, 8, 4, 2>(p, ldp, buf, ldb, w, n, f, lr, stream);
  return launch_mix_nv<T, 32, 1, 1>(p, ldp, buf, ldb, w, n, f, lr, stream);
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
  if (dtype == 0) return launch_sgd<float>(count, p, m, g, sizes, lr, mu, s);
  if (dtype == 1)
    return launch_sgd<__nv_bfloat16>(count, p, m, g, sizes, lr, mu, s);
  return cudaErrorInvalidValue;
}

// p, buf: [n, f] with row strides ldp, ldb (elements) and unit column
// stride; w: [n, n] row-major float32 on the device.
int dopt_fused_mix_sgd(void* p, int64_t ldp, const void* buf, int64_t ldb,
                       const float* w, int n, int64_t f, int dtype, float lr,
                       void* stream) {
  if (n < 1 || n > kMixMaxN || f < 1 || ldp < f || ldb < f)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mix<float>(static_cast<float*>(p), ldp,
                             static_cast<const float*>(buf), ldb, w, n, f, lr,
                             s);
  if (dtype == 1)
    return launch_mix<__nv_bfloat16>(static_cast<__nv_bfloat16*>(p), ldp,
                                     static_cast<const __nv_bfloat16*>(buf),
                                     ldb, w, n, f, lr, s);
  return cudaErrorInvalidValue;
}

const char* dopt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

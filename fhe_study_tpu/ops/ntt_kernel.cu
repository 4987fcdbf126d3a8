// Negacyclic NTT / INTT over many RNS primes, one CUDA thread block per
// (row, prime), the whole row resident in shared memory.
//
// Bit-identical to ops/ntt.py's XLA path (ntt_multi / intt_multi):
//   forward: Cooley-Tukey, m = 1 .. n/2, t = n / 2m; butterfly (a, a + t)
//            with twiddle w[m + i] of the bit-reversed root table;
//   inverse: Gentleman-Sande, m = n/2 .. 1, t = n / 2m, twiddle winv[m + i];
//   epilogue: every output is multiplied by one per-prime constant c
//            (forward: 1 or the Montgomery lift 2^32 mod q; inverse:
//            n^-1 * scale mod q).
// Every intermediate value is canonical in [0, q), so the result does not
// depend on how butterflies are spread over threads.
//
// Arithmetic: u32 Shoup products with the native 32x32 -> hi 32 multiply
// (__umulhi). Valid for q < 2^31: a*w - floor(a*w'/2^32)*q lies in [0, 2q).
//
// Operands (all u32, row-major):
//   x      [L, rows, n]  residues in [0, q_l)
//   tw     [L, 2, n]     per prime: twiddles, then their Shoup companions
//                        floor(w * 2^32 / q)
//   consts [L, 4]        per prime: q, c, floor(c * 2^32 / q), unused
//   y      [L, rows, n]  result
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> (ops/ntt_cuda.py).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_shoup, uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, w_shoup) * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

template <bool kInverse>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_rows(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
             const uint32_t* __restrict__ consts, uint32_t* __restrict__ y,
             int log_n, int64_t rows) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  const int prime = blockIdx.y;
  const size_t off = (static_cast<size_t>(prime) * rows + blockIdx.x) *
                     static_cast<size_t>(n);
  const uint32_t* w = tw + static_cast<size_t>(prime) * 2 * n;
  const uint32_t* w_shoup = w + n;
  const uint32_t q = consts[4 * prime];

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = x[off + i];
  __syncthreads();

  for (int st = 0; st < log_n; ++st) {
    // forward: t = n/2 .. 1 (m = 1 .. n/2); inverse: t = 1 .. n/2
    const int log_t = kInverse ? st : log_n - 1 - st;
    const int m = half >> log_t;
    const int t_mask = (1 << log_t) - 1;
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      const int g = j >> log_t;
      const int a = (g << (log_t + 1)) + (j & t_mask);
      const int b = a + (1 << log_t);
      const uint32_t wi = __ldg(w + m + g);
      const uint32_t wsi = __ldg(w_shoup + m + g);
      const uint32_t u = s[a];
      if (kInverse) {
        const uint32_t v = s[b];
        s[a] = add_mod(u, v, q);
        s[b] = shoup_mul(sub_mod(u, v, q), wi, wsi, q);
      } else {
        const uint32_t v = shoup_mul(s[b], wi, wsi, q);
        s[a] = add_mod(u, v, q);
        s[b] = sub_mod(u, v, q);
      }
    }
    __syncthreads();
  }

  const uint32_t c = consts[4 * prime + 1];
  const uint32_t c_shoup = consts[4 * prime + 2];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    y[off + i] = shoup_mul(s[i], c, c_shoup, q);
}

template <bool kInverse>
ffi::Error launch(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                  ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> consts,
                  ffi::ResultBuffer<ffi::U32> y) {
  const auto dims = x.dimensions();
  if (dims.size() != 3)
    return ffi::Error::InvalidArgument("ntt: x must have shape [L, rows, n]");
  const int64_t primes = dims[0], rows = dims[1], n = dims[2];
  int log_n = 0;
  while ((int64_t{1} << log_n) < n) ++log_n;
  if (n < 2 || (int64_t{1} << log_n) != n || log_n > 15)
    return ffi::Error::InvalidArgument("ntt: n must be a power of two in [2, 2^15]");
  const auto tdims = tw.dimensions();
  if (tdims.size() != 3 || tdims[0] != primes || tdims[1] != 2 || tdims[2] != n)
    return ffi::Error::InvalidArgument("ntt: tw must have shape [L, 2, n]");
  if (consts.element_count() != static_cast<size_t>(4 * primes))
    return ffi::Error::InvalidArgument("ntt: consts must have shape [L, 4]");
  if (primes > 65535 || rows > 2147483647)
    return ffi::Error::InvalidArgument("ntt: grid too large");
  if (primes == 0 || rows == 0) return ffi::Error::Success();

  const int threads = static_cast<int>(n / 2 < kMaxThreads ? n / 2 : kMaxThreads);
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_rows<kInverse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) {
    const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(primes));
    ntt_rows<kInverse><<<grid, threads, smem, stream>>>(
        x.typed_data(), tw.typed_data(), consts.typed_data(),
        y->typed_data(), log_n, rows);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("ntt: ") + cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error forward(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                   ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> consts,
                   ffi::ResultBuffer<ffi::U32> y) {
  return launch<false>(stream, x, tw, consts, y);
}

ffi::Error inverse(cudaStream_t stream, ffi::Buffer<ffi::U32> x,
                   ffi::Buffer<ffi::U32> tw, ffi::Buffer<ffi::U32> consts,
                   ffi::ResultBuffer<ffi::U32> y) {
  return launch<true>(stream, x, tw, consts, y);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FheNttForward, forward,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(FheNttInverse, inverse,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

// Fused W8A8 int8 matmul for Hopper (sm_90a): quantize x per row in shared
// memory, int8 x int8 -> int32 over K, dequant epilogue.
//
// Replaces: tpuflow/ops/int8_matmul.py::_pallas_int8_matmul, the Pallas
// kernel _int8_matmul_kernel. Same contract, bit for bit against the plain
// version (_plain_int8_matmul in ops/int8_matmul.py):
//   xq  = clip(rintf(__fdiv_rn(x, s[m])), -127, 127)     (IEEE division,
//         round half to even: no fast math anywhere in this file)
//   acc = sum_k xq[m, k] * wq[k, n]                         (exact int32)
//   out = __fmul_rn(__fmul_rn((float)acc, s[m]), ws[n])    (that order, no
//         fused multiply-add)
// s (the per-row activation scale, amax/127) is computed by the wrapper with
// the same formula as row_scales, as the TPU wrapper does.
//
// What bounds it on the H100: the serving path calls it at M = 8 (decode)
// and M = a prefill bucket width, with K, N = 768..3072 and the 50257-row
// LM head. At M = 8 every weight byte is used for 16 int ops, far below the
// ~590 ops/byte the int8 tensor cores need, so it is bound by the bytes of
// the int8 weight stream. At M = 512 it is bound by operations.
//
// Design: one thread block per (32-row, 32-column) output tile; a loop over
// K in 64-wide steps. Each step quantizes its x tile into shared memory (the
// int8 activations never reach device memory), stages the int8 weight tile
// transposed so that four consecutive k of one column pack into one 32-bit
// word, and accumulates with __dp4a. Both weight layouts are handled ((K, N)
// Dense kernels and the (N, K) LM head with w_contract_last, which is read
// in place, never transposed in memory). Every M, K and N edge is masked by
// zero-filling. Tensor-core MMA (mma.sync s8.s8.s32 / wgmma), split-K for
// the decode shapes and vectorised loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int KW = BK / 4 + 1;  // words per shared row (+1: no bank clash)

template <bool CONTRACT_LAST>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const float* __restrict__ x, const float* __restrict__ s,
                   const int8_t* __restrict__ w, const float* __restrict__ ws,
                   float* __restrict__ out, int M, int K, int N) {
  __shared__ int32_t xq_s[BM][KW];  // 4 int8 of consecutive k per word
  __shared__ int32_t wq_s[BN][KW];
  __shared__ float s_s[BM];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  if (tid < BM) s_s[tid] = m0 + tid < M ? s[m0 + tid] : 1.f;

  // Thread tile: rows ty*2 + i, columns tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  int acc[2][2] = {{0, 0}, {0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // s_s written / previous tile consumed
    for (int i = tid; i < BM * BK; i += THREADS) {
      int m = i / BK, kk = i % BK;
      int gm = m0 + m, gk = k0 + kk;
      int8_t qv = 0;
      if (gm < M && gk < K) {
        float r = rintf(__fdiv_rn(x[(long long)gm * K + gk], s_s[m]));
        qv = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
      }
      reinterpret_cast<int8_t*>(&xq_s[m][0])[kk] = qv;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      int n, kk;
      if (CONTRACT_LAST) {  // w is (N, K): consecutive threads walk k
        n = i / BK;
        kk = i % BK;
      } else {  // w is (K, N): consecutive threads walk n
        kk = i / BN;
        n = i % BN;
      }
      int gn = n0 + n, gk = k0 + kk;
      int8_t wv = 0;
      if (gn < N && gk < K)
        wv = CONTRACT_LAST ? w[(long long)gn * K + gk]
                           : w[(long long)gk * N + gn];
      reinterpret_cast<int8_t*>(&wq_s[n][0])[kk] = wv;
    }
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      int a0 = xq_s[ty * 2][k4], a1 = xq_s[ty * 2 + 1][k4];
      int b0 = wq_s[tx][k4], b1 = wq_s[tx + 16][k4];
      acc[0][0] = __dp4a(a0, b0, acc[0][0]);
      acc[0][1] = __dp4a(a0, b1, acc[0][1]);
      acc[1][0] = __dp4a(a1, b0, acc[1][0]);
      acc[1][1] = __dp4a(a1, b1, acc[1][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int m = ty * 2 + i, gm = m0 + m;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float r = __fmul_rn(__int2float_rn(acc[i][j]), s_s[m]);
      out[(long long)gm * N + gn] = __fmul_rn(r, ws[gn]);
    }
  }
}

}  // namespace

extern "C" {

// x: (M, K) float32 contiguous; s: (M,) float32 row scales; w: int8, (K, N)
// or (N, K) when w_contract_last, contiguous; ws: (N,) float32; out: (M, N)
// float32. Returns cudaGetLastError() after the launch (0 on success).
int tpuflow_int8_matmul(const void* x, const void* s, const void* w,
                        const void* ws, void* out, int M, int K, int N,
                        int w_contract_last, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = (cudaStream_t)stream;
  if (w_contract_last)
    int8_matmul_kernel<true><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const float*)s, (const int8_t*)w,
        (const float*)ws, (float*)out, M, K, N);
  else
    int8_matmul_kernel<false><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const float*)s, (const int8_t*)w,
        (const float*)ws, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

const char* tpuflow_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

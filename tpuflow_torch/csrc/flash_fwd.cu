// Causal flash-attention forward for Hopper (sm_90a), with or without the
// row logsumexp.
//
// Replaces: tpuflow/ops/flash_attention.py::_flash_fwd, both variants: the
// Pallas kernels _fwd_kernel_nolse (with_lse=False, the serving path) and
// _fwd_kernel (with_lse=True, the training forward). Same numerics contract:
// scores (q.k) * 1/sqrt(D) in f32, causal mask value -1e30, f32 online
// softmax (running max m, denominator l, accumulator acc), tiles strictly
// above the diagonal skipped, output acc / max(l, 1e-30) written in the
// input dtype. For bf16 inputs P is rounded to bf16 before P.V, as the TPU
// kernel casts p to v's dtype before its second matrix product. With a
// non-null lse pointer the kernel also writes lse = m + log(max(l, 1e-30))
// per row into a compact (B*H, Tq) f32 array (the TPU kernel broadcasts it
// over 128 lanes only for Mosaic's tiling); with a null pointer it writes
// nothing more, and the output is bit-identical either way.
//
// What bounds it on the H100: at the serving prefill shapes (T = 512..1024,
// D = 64) the work is ~T^2*D*H*2 flops against ~4*T*H*D elements of traffic,
// so it is bound by operations, not bytes. This first version runs the two
// products on the f32 CUDA cores (67 TFLOP/s peak), not the tensor cores.
//
// Design: one thread block per (q-tile of 64 rows, batch*head). The TPU's
// sequential k grid axis becomes a loop inside the block; the q tile, the
// current k and v tiles and the 64x64 score tile sit in shared memory, and
// the f32 accumulator in registers (each of the 128 threads owns 8 rows x
// D/16 columns). Ragged T is masked in the kernel: rows >= Tq are not
// written, keys >= Tk get p = 0 and zero-filled v rows. Tensor cores
// (mma.sync / wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// P rounded to the input dtype before P.V (identity for f32).
__device__ __forceinline__ float round_p(float p, float*) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq,
                 int Tk, int causal, float scale, long long sqb,
                 long long sqt, long long sqh, long long skb, long long skt,
                 long long skh, long long svb, long long svt, long long svh) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D]
  float* Ks = Qs + BQ * D;             // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D]
  float* S = Vs + BK * D;              // [BQ][BK + 1]
  float* m_s = S + BQ * (BK + 1);      // [BQ] running max
  float* l_s = m_s + BQ;               // [BQ] running denominator
  float* c_s = l_s + BQ;               // [BQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    int r = i / D, d = i % D;
    int t = q0 + r;
    Qs[i] = t < Tq ? to_f32(qb[t * sqt + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // Thread tile: rows ty*8 .. ty*8+7; score columns tx*4 .. tx*4+3 and
  // output columns tx + 16*j, j < D/16.
  const int ty = tid / 16, tx = tid % 16;
  constexpr int DJ = D / 16;
  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // Causal block skip: k tiles starting past this q tile's last row are
  // fully masked (the TPU kernel's ik*block_k <= iq*block_q + block_q - 1).
  int k_end = Tk;
  if (causal) k_end = min(Tk, q0 + BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's S / Vs fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      int r = i / D, d = i % D;
      int t = k0 + r;
      bool ok = t < Tk;
      Ks[r * (D + 1) + d] = ok ? to_f32(kb[t * skt + d]) : 0.f;
      Vs[i] = ok ? to_f32(vb[t * svt + d]) : 0.f;
    }
    __syncthreads();

    // S = (Q K^T) * scale, masked.
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx * 4 + j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float qv = Qs[(ty * 8 + i) * D + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int qp = q0 + ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int kp = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (causal && qp < kp) x = NEG_INF;
        // Keys past Tk are not part of the sequence: -inf-like sentinel
        // that the softmax pass below turns into p = 0 exactly.
        if (kp >= Tk) x = -INFINITY;
        S[(ty * 8 + i) * (BK + 1) + tx * 4 + j] = x;
      }
    }
    __syncthreads();

    // Online softmax, one thread per row.
    if (tid < BQ) {
      float* row = S + tid * (BK + 1);
      float m_old = m_s[tid];
      float mx = m_old;
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, row[j]);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        float p = row[j] == -INFINITY ? 0.f : expf(row[j] - mx);
        sum += p;
        row[j] = round_p(p, (T*)nullptr);
      }
      float corr = expf(m_old - mx);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = mx;
      c_s[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float c = c_s[ty * 8 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= c;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float p = S[(ty * 8 + i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

  // Output (B, Tq, H, D) contiguous, in the input dtype.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int r = ty * 8 + i;
    int t = q0 + r;
    if (t >= Tq) continue;
    float l = fmaxf(l_s[r], 1e-30f);
    T* ob = o + (((long long)b * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(ob + tx + 16 * j, acc[i][j] / l);
  }
  // The softmax residual of the backward: lse[b*H + h][t].
  if (lse != nullptr && tid < BQ && q0 + tid < Tq)
    lse[(long long)bh * Tq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B,
           int H, int Tq, int Tk, int causal, const long long* st,
           cudaStream_t stream) {
  size_t smem = sizeof(float) *
                (BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  float scale = 1.0f / sqrtf((float)D);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, Tq, Tk, causal,
      scale,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Tq, int Tk, int D, int causal,
               const long long* st, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, causal, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, causal, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, causal, st,
                            stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, T, H, D) with unit stride over D and the given element
// strides over (batch, seq, head); o: contiguous (B, Tq, H, D); lse: null,
// or a contiguous (B*H, Tq) float32 array. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch (0 on success).
int tpuflow_flash_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Tq, int Tk, int D,
                      int dtype,
                      int causal, long long sqb, long long sqt, long long sqh,
                      long long skb, long long skt, long long skh,
                      long long svb, long long svt, long long svh,
                      void* stream) {
  const long long st[9] = {sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, (float*)lse, B, H, Tq, Tk, D,
                             causal, st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, (float*)lse, B, H, Tq, Tk,
                                     D, causal, st, s);
  return (int)cudaErrorInvalidValue;
}

const char* tpuflow_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

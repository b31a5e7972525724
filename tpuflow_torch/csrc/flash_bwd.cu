// Flash-attention backward for Hopper (sm_90a): the fused dq and dk/dv pair.
//
// Replaces: tpuflow/ops/flash_attention.py::_flash_bwd_fused, the Pallas
// kernels _bwd_dq_fused_kernel (dq plus the row delta) and
// _bwd_dkv_fused_kernel (dk and dv from the residuals, never reading O).
// The FlashAttention-2 recompute: with the forward's row logsumexp,
//   P  = exp(S - lse),  S = (Q K^T) * 1/sqrt(D), causal mask value -1e30,
//   dP = dO V^T,  D = rowsum(dO o O),  dS = P o (dP - D) * 1/sqrt(D),
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
// For bf16 inputs P is rounded to dO's dtype before P^T dO and dS to the
// input dtype before dS K and dS^T Q, as the TPU kernels cast them; every
// product sums in f32 and the gradients are written in the input dtype.
//
// What bounds it on the H100: at the training shape (B*H = 96, T = 1024,
// D = 64) the pair does five causal T x T x D products (S and dP twice,
// once per kernel, then dQ, dK, dV) against ~10 (B*H, T, D) arrays of
// traffic, so it is bound by operations. This first version runs the
// products on the f32 CUDA cores, not the tensor cores.
//
// Design. The TPU walks a sequential grid axis and carries dq (or dk, dv)
// in scratch across it; here each block owns one output tile and loops:
// - dq kernel: one block per (64-row q tile, batch*head). It computes D once
//   for its rows (f32, from dO and O) and writes it to a compact (B*H, Tq)
//   f32 delta array, then loops over the k tiles up to the causal bound (the
//   TPU kernel's block skip becomes the loop bound), accumulating dq in
//   registers.
// - dk/dv kernel: one block per (64-row k tile, batch*head). It loops over
//   the q tiles from the causal start, reading q, dO, lse and delta (never
//   O: the fused contract), accumulating dk and dv in registers.
// Each output tile has one owner and no atomics are used, so the result is
// deterministic: two runs give the same bits. Ragged T is masked in the
// kernels (p = 0 for rows or keys past the sequence, zero-filled tiles).
// Tensor cores (mma.sync / wgmma) and TMA are later work.

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
// A value rounded to the input dtype before a product (identity for f32).
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element strides over (batch, seq, head) of one (B, T, H, D) tensor with
// unit stride over D.
struct Strides {
  long long b, t, h;
};

// Strides of the inputs, in the order the C entry points take them.
struct DqStrides {
  Strides q, k, v, o, g;
};
struct DkvStrides {
  Strides q, k, v, g;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta, int H,
                    int Tq, int Tk, int causal, float scale, DqStrides st) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D]
  float* Gs = Qs + BQ * D;             // [BQ][D]      dO
  float* Ks = Gs + BQ * D;             // [BK][D + 1]  (O before the loop)
  float* Vs = Ks + BK * (D + 1);       // [BK][D + 1]
  float* dS = Vs + BK * (D + 1);       // [BQ][BK + 1]
  float* lse_s = dS + BQ * (BK + 1);   // [BQ]
  float* dl_s = lse_s + BQ;            // [BQ] row delta D

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  const T* ob = o + b * st.o.b + h * st.o.h;
  const T* gb = g + b * st.g.b + h * st.g.h;

  // q, dO, and O (into the k buffer, free until the loop) for this tile.
  for (int i = tid; i < BQ * D; i += THREADS) {
    int r = i / D, d = i % D;
    int t = q0 + r;
    bool ok = t < Tq;
    Qs[i] = ok ? to_f32(qb[t * st.q.t + d]) : 0.f;
    Gs[i] = ok ? to_f32(gb[t * st.g.t + d]) : 0.f;
    Ks[r * (D + 1) + d] = ok ? to_f32(ob[t * st.o.t + d]) : 0.f;
  }
  __syncthreads();
  // D = rowsum(dO o O) once per row, in f32; lse for the same rows.
  if (tid < BQ) {
    int t = q0 + tid;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += Gs[tid * D + d] * Ks[tid * (D + 1) + d];
    dl_s[tid] = s;
    lse_s[tid] = t < Tq ? lse[(long long)bh * Tq + t] : 0.f;
    if (t < Tq) delta[(long long)bh * Tq + t] = s;
  }

  // Thread tile: rows ty*8 .. ty*8+7; score columns tx*4 .. tx*4+3 and
  // dq columns tx + 16*j, j < D/16.
  const int ty = tid / 16, tx = tid % 16;
  constexpr int DJ = D / 16;
  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // Causal: k tiles starting past this q tile's last row hold no key any
  // row may see (the TPU kernel's ik*block_k <= iq*block_q + block_q - 1).
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // O, or the previous tile's K / V / dS, consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      int r = i / D, d = i % D;
      int t = k0 + r;
      bool ok = t < Tk;
      Ks[r * (D + 1) + d] = ok ? to_f32(kb[t * st.k.t + d]) : 0.f;
      Vs[r * (D + 1) + d] = ok ? to_f32(vb[t * st.v.t + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the thread's 8 x 4 tile.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx * 4 + j) * (D + 1) + d];
        vv[j] = Vs[(tx * 4 + j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float qv = Qs[(ty * 8 + i) * D + d];
        float gv = Gs[(ty * 8 + i) * D + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv, kv[j], s[i][j]);
          dp[i][j] = fmaf(gv, vv[j], dp[i][j]);
        }
      }
    }
    // P = exp(S - lse), dS = P o (dP - D) * scale, rounded to k's dtype.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int r = ty * 8 + i;
      int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int kp = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (causal && qp < kp) x = NEG_INF;
        float p = (qp < Tq && kp < Tk) ? expf(x - lse_s[r]) : 0.f;
        float ds = p * (dp[i][j] - dl_s[r]) * scale;
        dS[r * (BK + 1) + tx * 4 + j] = round_to(ds, (T*)nullptr);
      }
    }
    __syncthreads();

    // dq += dS K.
    for (int kk = 0; kk < BK; ++kk) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float w = dS[(ty * 8 + i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(w, kv[j], acc[i][j]);
      }
    }
  }

  // dq: contiguous (B, Tq, H, D) in the input dtype.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int t = q0 + ty * 8 + i;
    if (t >= Tq) continue;
    T* out = dq + (((long long)b * Tq + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(out + tx + 16 * j, acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk, int causal,
                     float scale, DkvStrides st) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][D]
  float* Vs = Ks + BK * D;             // [BK][D]
  float* Qs = Vs + BK * D;             // [BQ][D + 1]
  float* Gs = Qs + BQ * (D + 1);       // [BQ][D + 1]  dO
  float* Pt = Gs + BQ * (D + 1);       // [BK][BQ + 1] P^T, dO's dtype
  float* dSt = Pt + BK * (BQ + 1);     // [BK][BQ + 1] dS^T, q's dtype
  float* lse_s = dSt + BK * (BQ + 1);  // [BQ]
  float* dl_s = lse_s + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const T* qb = q + b * st.q.b + h * st.q.h;
  const T* kb = k + b * st.k.b + h * st.k.h;
  const T* vb = v + b * st.v.b + h * st.v.h;
  const T* gb = g + b * st.g.b + h * st.g.h;

  for (int i = tid; i < BK * D; i += THREADS) {
    int r = i / D, d = i % D;
    int t = k0 + r;
    bool ok = t < Tk;
    Ks[i] = ok ? to_f32(kb[t * st.k.t + d]) : 0.f;
    Vs[i] = ok ? to_f32(vb[t * st.v.t + d]) : 0.f;
  }

  // Thread tile: key rows ty*8 .. ty*8+7; query columns tx*4 .. tx*4+3 of
  // the transposed scores, and dk/dv columns tx + 16*j, j < D/16.
  const int ty = tid / 16, tx = tid % 16;
  constexpr int DJ = D / 16;
  float ak[8][DJ], av[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) ak[i][j] = av[i][j] = 0.f;

  // Causal: a q tile whose last row precedes this k tile sees none of it.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous tile's Q / dO / P^T / dS^T consumed
    for (int i = tid; i < BQ * D; i += THREADS) {
      int r = i / D, d = i % D;
      int t = q0 + r;
      bool ok = t < Tq;
      Qs[r * (D + 1) + d] = ok ? to_f32(qb[t * st.q.t + d]) : 0.f;
      Gs[r * (D + 1) + d] = ok ? to_f32(gb[t * st.g.t + d]) : 0.f;
    }
    if (tid < BQ) {
      int t = q0 + tid;
      bool ok = t < Tq;
      lse_s[tid] = ok ? lse[(long long)bh * Tq + t] : 0.f;
      dl_s[tid] = ok ? delta[(long long)bh * Tq + t] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the thread's 8 x 4 tile.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx * 4 + j) * (D + 1) + d];
        gv[j] = Gs[(tx * 4 + j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float kv = Ks[(ty * 8 + i) * D + d];
        float vv = Vs[(ty * 8 + i) * D + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[j], kv, s[i][j]);
          dp[i][j] = fmaf(gv[j], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int kp = k0 + ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = tx * 4 + j;
        int qp = q0 + c;
        float x = s[i][j] * scale;
        if (causal && qp < kp) x = NEG_INF;
        float p = (qp < Tq && kp < Tk) ? expf(x - lse_s[c]) : 0.f;
        Pt[(ty * 8 + i) * (BQ + 1) + c] = round_to(p, (T*)nullptr);
        dSt[(ty * 8 + i) * (BQ + 1) + c] =
            round_to(p * (dp[i][j] - dl_s[c]) * scale, (T*)nullptr);
      }
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T Q.
    for (int c = 0; c < BQ; ++c) {
      float gv[DJ], qv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = Gs[c * (D + 1) + tx + 16 * j];
        qv[j] = Qs[c * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float pw = Pt[(ty * 8 + i) * (BQ + 1) + c];
        float sw = dSt[(ty * 8 + i) * (BQ + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          av[i][j] = fmaf(pw, gv[j], av[i][j]);
          ak[i][j] = fmaf(sw, qv[j], ak[i][j]);
        }
      }
    }
  }

  // dk, dv: contiguous (B, Tk, H, D) in the input dtype.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int t = k0 + ty * 8 + i;
    if (t >= Tk) continue;
    long long off = (((long long)b * Tk + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store(dk + off + tx + 16 * j, ak[i][j]);
      store(dv + off + tx + 16 * j, av[i][j]);
    }
  }
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* g, const float* lse, void* dq, float* delta, int B,
              int H, int Tq, int Tk, int causal, const long long* st,
              cudaStream_t stream) {
  size_t smem = sizeof(float) * (2 * BQ * D + 2 * BK * (D + 1) +
                                 BQ * (BK + 1) + 2 * BQ);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  DqStrides s{strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
              strides_at(st, 3), strides_at(st, 4)};
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)g, lse,
      (T*)dq, delta, H, Tq, Tk, causal, 1.0f / sqrtf((float)D), s);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, int causal, const long long* st,
               cudaStream_t stream) {
  size_t smem = sizeof(float) * (2 * BK * D + 2 * BQ * (D + 1) +
                                 2 * BK * (BQ + 1) + 2 * BQ);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  DkvStrides s{strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
               strides_at(st, 3)};
  dim3 grid((Tk + BK - 1) / BK, B * H);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, lse, delta,
      (T*)dk, (T*)dv, H, Tq, Tk, causal, 1.0f / sqrtf((float)D), s);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_d(const void* q, const void* k, const void* v, const void* o,
         const void* g, const float* lse, void* dq, float* delta, int B,
         int H, int Tq, int Tk, int D, int causal, const long long* st,
         cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dq<T, 32>(q, k, v, o, g, lse, dq, delta, B, H, Tq, Tk,
                              causal, st, s);
    case 64:
      return launch_dq<T, 64>(q, k, v, o, g, lse, dq, delta, B, H, Tq, Tk,
                              causal, st, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, o, g, lse, dq, delta, B, H, Tq, Tk,
                               causal, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_d(const void* q, const void* k, const void* v, const void* g,
          const float* lse, const float* delta, void* dk, void* dv, int B,
          int H, int Tq, int Tk, int D, int causal, const long long* st,
          cudaStream_t s) {
  switch (D) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, g, lse, delta, dk, dv, B, H, Tq, Tk,
                               causal, st, s);
    case 64:
      return launch_dkv<T, 64>(q, k, v, g, lse, delta, dk, dv, B, H, Tq, Tk,
                               causal, st, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, g, lse, delta, dk, dv, B, H, Tq,
                                Tk, causal, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o, g (= dO): (B, T, H, D) with unit stride over D; `strides`
// holds 15 element strides, (batch, seq, head) of q, k, v, o, g in turn.
// lse: contiguous (B*H, Tq) f32. Writes dq, contiguous (B, Tq, H, D) in the
// input dtype, and delta = rowsum(dO o O), contiguous (B*H, Tq) f32.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
int tpuflow_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* o, const void* g, const void* lse,
                         void* dq, void* delta, int B, int H, int Tq, int Tk,
                         int D, int dtype, int causal, const void* strides,
                         void* stream) {
  const long long* st = (const long long*)strides;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dq_d<float>(q, k, v, o, g, (const float*)lse, dq, (float*)delta,
                       B, H, Tq, Tk, D, causal, st, s);
  if (dtype == 1)
    return dq_d<__nv_bfloat16>(q, k, v, o, g, (const float*)lse, dq,
                               (float*)delta, B, H, Tq, Tk, D, causal, st, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, g (= dO): (B, T, H, D) with unit stride over D; `strides` holds
// 12 element strides, (batch, seq, head) of q, k, v, g in turn. lse and
// delta: contiguous (B*H, Tq) f32. Writes dk and dv, contiguous
// (B, Tk, H, D) in the input dtype. Returns cudaGetLastError().
int tpuflow_flash_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, int B, int H, int Tq, int Tk,
                          int D, int dtype, int causal, const void* strides,
                          void* stream) {
  const long long* st = (const long long*)strides;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dkv_d<float>(q, k, v, g, (const float*)lse, (const float*)delta,
                        dk, dv, B, H, Tq, Tk, D, causal, st, s);
  if (dtype == 1)
    return dkv_d<__nv_bfloat16>(q, k, v, g, (const float*)lse,
                                (const float*)delta, dk, dv, B, H, Tq, Tk, D,
                                causal, st, s);
  return (int)cudaErrorInvalidValue;
}

const char* tpuflow_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

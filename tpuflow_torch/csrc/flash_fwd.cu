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
// Key tiles are 64 wide and anchored at key 0 for every launch plan, and a
// row's arithmetic never involves another row: a row's bits depend only on
// its q and the keys at or before it, not on B, Tq, the q tile height or
// keys after it. A tile that is fully masked for a row adds exact zeros, so
// skipping it (per block or per warp) changes no bit.
//
// What bounds it on the H100: at the main paths' shapes (T = 512..1024,
// D = 64) the work is ~T^2*D*H*2 flops against ~4*T*H*D elements of
// traffic: it is bound by operations.
//
// Design, bf16 (flash_fwd_mma, FlashAttention-2 style): each warp owns 16
// q rows of one of two warp groups (BQ = 32 or 64: 4 or 8 warps); group 0
// walks the even 64-key tiles, group 1 the odd ones, and their online-
// softmax states are merged at the end, which halves the longest chain of
// key tiles a warp walks (at T = 1024, 8 instead of 16). S = Q K^T runs on
// mma.sync m16n8k16 bf16 -> f32 with the Q fragments held in registers for
// the whole key loop and K read by ldmatrix.x4. The online softmax runs on
// the accumulator fragments (a row's max and sum reduced over the 4 lanes
// that hold it by __shfl_xor_sync), P is rounded to bf16 in registers and
// its C fragments are fed straight back as the A operand of P.V, V read by
// ldmatrix.x4.trans. No S tile goes through shared memory.
//
// Design, f32 (flash_fwd_fma): IEEE f32 FMAs on the CUDA cores, no TF32.
// A pair of lanes per 8 q rows x 8 keys of S (2*BQ threads, BQ = 32 or
// 64), each lane over one half of d; the halves are added by a shuffle.
// Every word loaded from shared memory feeds 8 FMAs (4 per word with both
// operands counted), as against 2.7 before. Rows of a thread are
// interleaved (stride BQ/8) and keys too (stride 8) so that the float4
// reads hit distinct banks. A row's 8 key groups are 8 lanes of one warp:
// its max and sum go by shuffles, and its P row through a warp-private
// shared buffer to the P.V product, where each lane of the pair takes one
// half of the keys for 8 rows x D/8 columns and the halves are added at
// the end.
//
// Head dims. D = 32, 64 and 128 are instantiated as they are; the wrapper
// zero-pads any other D % 8 == 0 up to the next of 32, 64, 128, 256 and
// passes the true scale 1/sqrt(D): zero columns add exact zeros to every
// score and output column, so only the scale needs the true D. D = 256
// keeps the D = 128 register layout by splitting the output columns: a
// block owns DV of them (grid.z = D / DV; bf16 128, f32 64), computes the
// scores over the full 256 and accumulates P.V for its own columns only,
// with V staged at its DV columns; the lse row is written by column block
// 0 alone. The S work is done once a column block; nothing else changes.
// At D = 256 the q tile is 32 rows (64 would overrun shared memory).
// Above 256 a full-width K tile no longer fits: flash_fwd_wide contracts
// the scores over D in 32-wide chunks (see "wide heads" below).
//
// Both: K and V tiles come by 16-byte cp.async into a two-stage ring (the
// next stage loads while this one computes; a bf16 stage holds a tile for
// each warp group), one barrier per stage. The grid is
// (B*H, q tiles) with the q tiles in reverse order under the causal mask,
// so the longest run first and the short ones fill the tail. Ragged Tq and
// Tk are masked in the kernel; rows or strides that are not 16-byte
// aligned are staged by plain loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;
constexpr int STAGES = 2;  // K/V ring depth (a bf16 stage holds 2 tiles)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x D elements of (seq-strided) global memory, rows t0.., into shared
// memory with row stride RS elements; rows >= T are zero.
template <typename T, int D, int RS>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long st, int t0, int T_len,
                                          int rows, bool aligned) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / E;
  for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
    const int r = i / CPR, ch = i % CPR, t = t0 + r;
    T* d = dst + r * RS + ch * E;
    const bool ok = t < T_len;
    if (aligned) {
      cp_async16(d, ok ? src + t * st + ch * E : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = ok ? src[t * st + ch * E + e] : T(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Scores of one key: scale, causal mask, keys past Tk (p = 0 exactly).
__device__ __forceinline__ float masked(float s, float scale, int row,
                                        int key, int Tk, int causal) {
  float x = s * scale;
  if (causal && row < key) x = NEG_INF;
  if (key >= Tk) x = -INFINITY;
  return x;
}
__device__ __forceinline__ float prob(float x, float mx) {
  return x == -INFINITY ? 0.f : expf(x - mx);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Tq, Tk, causal, aligned;
  float scale;  // 1/sqrt(D) of the caller's D, before any padding
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
};

// D: the score width; DV: the output columns a block owns (D, or 128 at
// D = 256), from column DV * blockIdx.z on.
template <int D, int DV>
__global__ void __launch_bounds__(256)
flash_fwd_mma(const Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = D + 8;  // +16 bytes a row: ldmatrix rows hit all banks
  constexpr int RSV = DV + 8;  // V's rows: its DV columns only
  extern __shared__ __align__(16) uint8_t smem[];
  // Two warp groups, 16 rows a warp: group 0 takes the even key tiles,
  // group 1 the odd ones; a stage holds one tile for each.
  constexpr int S = STAGES, KT = 2 * BK;
  const int BQ = blockDim.x / 4, WR = BQ / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * RS;      // [S][KT][RS]
  bf16* Vs = Ks + S * KT * RS;  // [S][KT][RSV]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / WR, wr = warp % WR;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, col0 = blockIdx.z * DV;
  const bf16* qb = (const bf16*)a.q + b * a.sqb + h * a.sqh;
  const bf16* kb = (const bf16*)a.k + b * a.skb + h * a.skh;
  const bf16* vb = (const bf16*)a.v + b * a.svb + h * a.svh + col0;
  const bool al = a.aligned;

  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_st = (k_end + KT - 1) / KT;  // stages of two key tiles
  // Stages 0 .. S-2 in flight (Q with stage 0), one commit group each.
  load_rows<bf16, D, RS>(Qs, qb, a.sqt, q0, a.Tq, BQ, al);
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_st) {
      load_rows<bf16, D, RS>(Ks + i * KT * RS, kb, a.skt, i * KT, a.Tk, KT,
                             al);
      load_rows<bf16, DV, RSV>(Vs + i * KT * RSV, vb, a.svt, i * KT, a.Tk,
                               KT, al);
    }
    cp_async_commit();
  }

  const int w0 = wr * 16;              // this warp's first row in the tile
  const int row_last = q0 + w0 + 15;
  uint32_t qf[D / 16][4];
  float o[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int j = 0; j < n_st; ++j) {
    cp_async_wait<S - 2>();  // stage j has landed
    __syncthreads();         // ... for every thread; stage j-1's slot is free
    if (j + S - 1 < n_st) {
      const int jn = j + S - 1, slot = jn % S;
      load_rows<bf16, D, RS>(Ks + slot * KT * RS, kb, a.skt, jn * KT, a.Tk,
                             KT, al);
      load_rows<bf16, DV, RSV>(Vs + slot * KT * RSV, vb, a.svt, jn * KT,
                               a.Tk, KT, al);
    }
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (w0 + (lane & 15)) * RS + kk * 16 +
                            (lane >> 4) * 8);
    }
    const int k0 = j * KT + grp * BK;  // this group's key tile
    // Tiles past the diagonal or past Tk add exact zeros: skipped.
    if (!((a.causal && k0 > row_last) || k0 >= a.Tk)) {
      const bf16* Kt = Ks + ((j % S) * KT + grp * BK) * RS;
      const bf16* Vt = Vs + ((j % S) * KT + grp * BK) * RSV;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ldsm_x4(r, Kt + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * RS +
                         kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
        }
      // Tiles wholly below the warp's diagonal and inside Tk need no mask.
      const bool mask = (a.causal && k0 + BK - 1 > q0 + w0) || k0 + BK > a.Tk;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = q0 + w0 + g + 8 * (c >> 1);
          const int key = k0 + 8 * n + 2 * t + (c & 1);
          s[n][c] = mask ? masked(s[n][c], a.scale, row, key, a.Tk, a.causal)
                         : s[n][c] * a.scale;
        }
      // Row max and sum as pairwise trees over the lane's 16 values of a
      // row (short dependency chains), then over the row's 4 lanes.
      float mx[2], sum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          v[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int n = 0; n < w; ++n) v[n] = fmaxf(v[n], v[n + w]);
        mx[r] = fmaxf(m_r[r], v[0]);
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[n][2 * r] = prob(s[n][2 * r], mx[r]);
          s[n][2 * r + 1] = prob(s[n][2 * r + 1], mx[r]);
          v[n] = s[n][2 * r] + s[n][2 * r + 1];
        }
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int n = 0; n < w; ++n) v[n] += v[n + w];
        sum[r] = v[0];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float corr = expf(m_r[r] - mx[r]);
        l_r[r] = l_r[r] * corr + sum[r];  // this lane's columns
        m_r[r] = mx[r];
#pragma unroll
        for (int i = 0; i < DV / 8; ++i) {
          o[i][2 * r] *= corr;
          o[i][2 * r + 1] *= corr;
        }
      }
      // P (bf16) as the A operand: C fragments of key tiles 2kk, 2kk+1.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DV / 16; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               RSV + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
  }

  // Group 1 hands its state to group 0 through the free ring, which merges
  // (a fixed formula, so the bits do not depend on the plan): with
  // m = max(mA, mB), l = lA e^(mA-m) + lB e^(mB-m), the same for o. A
  // group that saw no key has mB = -1e30, l = o = 0, and adds exact zeros.
  cp_async_wait<0>();  // no copy outlives the block (n_st may be 0)
  __syncthreads();
  constexpr int XW = 4 + DV / 2;  // floats a lane hands over
  float* xp = reinterpret_cast<float*>(Ks) + (wr * 32 + lane) * XW;
  if (grp == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xp[r] = m_r[r];
      xp[2 + r] = l_r[r];
    }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) xp[4 + 4 * i + c] = o[i][c];
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m = fmaxf(m_r[r], xp[r]);
    const float ca = expf(m_r[r] - m), cb = expf(xp[r] - m);
    l_r[r] = l_r[r] * ca + xp[2 + r] * cb;
    m_r[r] = m;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      o[i][2 * r] = o[i][2 * r] * ca + xp[4 + 4 * i + 2 * r] * cb;
      o[i][2 * r + 1] = o[i][2 * r + 1] * ca + xp[4 + 4 * i + 2 * r + 1] * cb;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + w0 + g + 8 * r;
    if (row >= a.Tq) continue;
    l = fmaxf(l, 1e-30f);
    bf16* ob =
        (bf16*)a.o + (((long long)b * a.Tq + row) * a.H + h) * D + col0;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(ob + 8 * i + 2 * t) =
          pack_bf16(o[i][2 * r] / l, o[i][2 * r + 1] / l);
    if (a.lse != nullptr && t == 0 && blockIdx.z == 0)
      a.lse[(long long)bh * a.Tq + row] = m_r[r] + logf(l);
  }
}

// D: the score width; DV: the output columns a block owns (D, or 64 at
// D = 256), from column DV * blockIdx.z on.
template <int D, int DV>
__global__ void __launch_bounds__(128)
flash_fwd_fma(const Args a) {
  constexpr int RS = D + 4;   // float4 rows land on distinct banks
  constexpr int RSV = DV + 4;  // V's rows: its DV columns only
  constexpr int PS = BK + 8;  // P rows of one warp on distinct banks
  constexpr int NC = DV / 32;  // float4 column groups per thread in P.V
  constexpr int DH = D / 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const int BQ = blockDim.x / 2, R = BQ / 8;  // thread rows ty + R*i
  float* Qs = reinterpret_cast<float*>(smem);
  constexpr int S = STAGES;
  float* Ks = Qs + BQ * RS;       // [S][BK][RS]
  float* Vs = Ks + S * BK * RS;   // [S][BK][RSV]
  float* Ps = Vs + S * BK * RSV;  // [BQ][PS]
  // Lane bits: tx (0-2) picks keys tx + 8c, h (3) the half of d in S and
  // of the keys in P.V, ty (4 and up) the rows ty + R*i.
  const int tid = threadIdx.x, tx = tid & 7, h = (tid >> 3) & 1;
  const int ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h_ = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, col0 = blockIdx.z * DV;
  const float* qb = (const float*)a.q + b * a.sqb + h_ * a.sqh;
  const float* kb = (const float*)a.k + b * a.skb + h_ * a.skh;
  const float* vb = (const float*)a.v + b * a.svb + h_ * a.svh + col0;
  const bool al = a.aligned;

  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  load_rows<float, D, RS>(Qs, qb, a.sqt, q0, a.Tq, BQ, al);
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_kt) {
      load_rows<float, D, RS>(Ks + i * BK * RS, kb, a.skt, i * BK, a.Tk, BK,
                              al);
      load_rows<float, DV, RSV>(Vs + i * BK * RSV, vb, a.svt, i * BK, a.Tk,
                                BK, al);
    }
    cp_async_commit();
  }

  // Partial P.V over this lane's half of every key tile; the halves are
  // added at the end.
  float acc[8][4 * NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  float m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait<S - 2>();  // tile j has landed
    __syncthreads();  // ... for every thread; tile j-1's slot and P are free
    if (j + S - 1 < n_kt) {
      const int jn = j + S - 1, slot = jn % S;
      load_rows<float, D, RS>(Ks + slot * BK * RS, kb, a.skt, jn * BK, a.Tk,
                              BK, al);
      load_rows<float, DV, RSV>(Vs + slot * BK * RSV, vb, a.svt, jn * BK,
                                a.Tk, BK, al);
    }
    cp_async_commit();
    const int k0 = j * BK;
    const float* Kt = Ks + (j % S) * BK * RS;
    const float* Vt = Vs + (j % S) * BK * RSV;

    // S = Q K^T: f32 FMAs in d order over this lane's half of d, then the
    // two halves added (lower + upper; a + b == b + a, so both lanes of
    // the pair hold the same bits).
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = h * DH; d < h * DH + DH; d += 4) {
      float4 qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + R * i) * RS + d);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Kt + (tx + 8 * c) * RS + d);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float x = fmaf(qv[i].x, kv.x, s[i][c]);
          x = fmaf(qv[i].y, kv.y, x);
          x = fmaf(qv[i].z, kv.z, x);
          s[i][c] = fmaf(qv[i].w, kv.w, x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        s[i][c] += __shfl_xor_sync(0xffffffffu, s[i][c], 8);
    // Online softmax; a row's 8 key groups are lanes tx = 0..7 of a warp.
    // Tiles wholly below the block's diagonal and inside Tk need no mask.
    const bool mask = (a.causal && k0 + BK - 1 > q0) || k0 + BK > a.Tk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + ty + R * i;
      float mx = m_r[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[i][c] = mask ? masked(s[i][c], a.scale, row, k0 + tx + 8 * c, a.Tk,
                                a.causal)
                       : s[i][c] * a.scale;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = prob(s[i][c], mx);
        sum += p;
        if ((i >> 2) == h) Ps[(ty + R * i) * PS + tx + 8 * c] = p;
      }
      const float corr = expf(m_r[i] - mx);
      l_r[i] = l_r[i] * corr + sum;  // this lane's keys
      m_r[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // the warp's P rows are written
    // acc += P V over keys 32h .. 32h + 31 in order: 8 rows x columns
    // 4tx + 32q .. +3.
#pragma unroll 2
    for (int kk = 32 * h; kk < 32 * h + 32; kk += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + R * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int qc = 0; qc < NC; ++qc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vt + (kk + u) * RSV + 4 * tx + 32 * qc);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float p = u == 0 ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * qc] = fmaf(p, vv.x, acc[i][4 * qc]);
            acc[i][4 * qc + 1] = fmaf(p, vv.y, acc[i][4 * qc + 1]);
            acc[i][4 * qc + 2] = fmaf(p, vv.z, acc[i][4 * qc + 2]);
            acc[i][4 * qc + 3] = fmaf(p, vv.w, acc[i][4 * qc + 3]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();  // no copy outlives the block (n_kt may be 0)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c)
      acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 8);
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + ty + R * i;
    if (row >= a.Tq || (i >> 2) != h) continue;
    l = fmaxf(l, 1e-30f);
    float* ob =
        (float*)a.o + (((long long)b * a.Tq + row) * a.H + h_) * D + col0;
#pragma unroll
    for (int qc = 0; qc < NC; ++qc)
      *reinterpret_cast<float4*>(ob + 4 * tx + 32 * qc) =
          make_float4(acc[i][4 * qc] / l, acc[i][4 * qc + 1] / l,
                      acc[i][4 * qc + 2] / l, acc[i][4 * qc + 3] / l);
    if (a.lse != nullptr && tx == 0 && blockIdx.z == 0)
      a.lse[(long long)bh * a.Tq + row] = m_r[i] + logf(l);
  }
}

// ------------------------------------------------------------ wide heads
// D > 256, a multiple of WV (the wrapper pads other head dims up): a full
// K tile no longer fits shared memory, so the scores are contracted over D
// in chunks, S = sum_c Q_c K_c^T, with one WC-wide chunk of Q and K staged
// at a time. A block owns WQ q rows and WV output columns (grid.z =
// D / WV); it computes the scores over the whole D for every key tile and
// accumulates P V for its own columns only, V staged at those columns; the
// lse row is written by column block 0 alone. One kernel for both dtypes:
// the tiles are staged as f32 and every product is an f32 FMA on the CUDA
// cores; for bf16 P is rounded to bf16 before P.V, as everywhere else.
// Four lanes hold a q row (lane bits 0-1 = `part`): each computes the
// scores of keys part + 4j and the output columns part + 4i, and the row's
// max and sum go by two xor shuffles. Limit: grid.z holds at most 65535
// column blocks (D <= 65535 * WV); the wrapper raises above it.
constexpr int WQ = 32;   // q rows a block
constexpr int WK = 32;   // keys a tile
constexpr int WC = 32;   // d columns a chunk of the score product
constexpr int WV = 128;  // output columns a block
constexpr int WIDE_MAX_Z = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// rows x cols elements of a (seq-strided) tensor from row t0 and column c0
// on, as f32 into shared memory with row stride RS; rows >= T_len are 0.
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, int RS, const T* src,
                                          long long st, int t0, int T_len,
                                          int c0, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols, t = t0 + r;
    dst[r * RS + c] = t < T_len ? to_f32(src[t * st + c0 + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
flash_fwd_wide(const Args a, int D) {
  __shared__ float Qc[WQ][WC + 1], Kc[WK][WC + 1];  // +1: rows on all banks
  __shared__ float Ps[WQ][WK + 1];
  __shared__ float Vs[WK][WV];
  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * WQ, row = q0 + r, col0 = blockIdx.z * WV;
  const T* qb = (const T*)a.q + b * a.sqb + h * a.sqh;
  const T* kb = (const T*)a.k + b * a.skb + h * a.skh;
  const T* vb = (const T*)a.v + b * a.svb + h * a.svh;
  const int k_end = a.causal ? min(a.Tk, q0 + WQ) : a.Tk;

  float acc[WV / 4];
#pragma unroll
  for (int i = 0; i < WV / 4; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += WK) {
    float s[WK / 4];
#pragma unroll
    for (int j = 0; j < WK / 4; ++j) s[j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += WC) {
      __syncthreads();  // the previous chunk and V tile have been read
      stage_f32(&Qc[0][0], WC + 1, qb, a.sqt, q0, a.Tq, c0, WQ, WC);
      stage_f32(&Kc[0][0], WC + 1, kb, a.skt, k0, a.Tk, c0, WK, WC);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < WC; ++d) {
        const float qv = Qc[r][d];
#pragma unroll
        for (int j = 0; j < WK / 4; ++j)
          s[j] = fmaf(qv, Kc[part + 4 * j][d], s[j]);
      }
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < WK / 4; ++j) {
      s[j] = masked(s[j], a.scale, row, k0 + part + 4 * j, a.Tk, a.causal);
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < WK / 4; ++j) {
      const float p = prob(s[j], mx);
      sum += p;
      Ps[r][part + 4 * j] = round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - mx);
    l = l * corr + sum;
    m = mx;
#pragma unroll
    for (int i = 0; i < WV / 4; ++i) acc[i] *= corr;
    stage_f32(&Vs[0][0], WV, vb, a.svt, k0, a.Tk, col0, WK, WV);
    __syncthreads();  // P and the V tile are written
    for (int k = 0; k < WK; ++k) {
      const float p = Ps[r][k];
#pragma unroll
      for (int i = 0; i < WV / 4; ++i)
        acc[i] = fmaf(p, Vs[k][part + 4 * i], acc[i]);
    }
  }
  if (row >= a.Tq) return;
  l = fmaxf(l, 1e-30f);
  T* ob = (T*)a.o + (((long long)b * a.Tq + row) * a.H + h) * D + col0;
#pragma unroll
  for (int i = 0; i < WV / 4; ++i) ob[part + 4 * i] = from_f32<T>(acc[i] / l);
  if (a.lse != nullptr && part == 0 && blockIdx.z == 0)
    a.lse[(long long)bh * a.Tq + row] = m + logf(l);
}

constexpr int wide_smem_bytes() {
  return 4 * ((WQ + WK) * (WC + 1) + WQ * (WK + 1) + WK * WV);
}

int launch_wide(int dtype, const Args& a, int B, int D, int bq,
                cudaStream_t stream) {
  if (bq != WQ || D % WV || D / WV > WIDE_MAX_Z)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * a.H, (a.Tq + WQ - 1) / WQ, D / WV);
  if (dtype == 1)
    flash_fwd_wide<__nv_bfloat16><<<grid, 4 * WQ, 0, stream>>>(a, D);
  else
    flash_fwd_wide<float><<<grid, 4 * WQ, 0, stream>>>(a, D);
  return (int)cudaGetLastError();
}

// The output columns a block owns: all of D up to 128; at D = 256, 128 in
// bf16 and 64 in f32 (whose K ring at full width leaves no room for more
// of V).
constexpr int out_cols(int dtype, int D) {
  return D <= 128 ? D : dtype == 1 ? 128 : 64;
}

// Dynamic shared memory of one block: Q, the K/V ring (a bf16 stage holds
// a key tile for each warp group; V at the block's DV columns) and f32's P
// rows, at the kernels' padded row strides. A size above the card's
// per-block limit fails the launch (cudaFuncSetAttribute), so no q tile
// height can overrun it.
int smem_bytes(int dtype, int D, int bq) {
  const int DV = out_cols(dtype, D);
  if (dtype == 1)
    return 2 * ((bq + STAGES * 2 * BK) * (D + 8) +
                STAGES * 2 * BK * (DV + 8));
  return 4 * ((bq + STAGES * BK) * (D + 4) + STAGES * BK * (DV + 4) +
              bq * (BK + 8));
}

template <int D>
int launch(int dtype, const Args& a, int B, int bq, cudaStream_t stream) {
  if (bq != 32 && bq != 64) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(dtype, D, bq);
  const int n_qt = (a.Tq + bq - 1) / bq;
  dim3 grid(B * a.H, n_qt, D / out_cols(dtype, D));
  cudaError_t err;
  if (dtype == 1) {
    const auto kern = flash_fwd_mma<D, out_cols(1, D)>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, 4 * bq, smem, stream>>>(a);
  } else {
    const auto kern = flash_fwd_fma<D, out_cols(0, D)>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, 2 * bq, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (B, T, H, D) with unit stride over D and the given element
// strides over (batch, seq, head); o: contiguous (B, Tq, H, D); lse: null,
// or a contiguous (B*H, Tq) float32 array. D: 32, 64, 128, 256 or a
// multiple of 128 above 256 (the wide-head kernel; the wrapper pads other
// head dims). dtype: 0 = float32, 1 = bfloat16. bq, the q tile height (32
// or 64; 32 at D >= 256), is the launch plan's
// (ops/flash_attention.py::_flash_bq). scale: 1/sqrt of the head dim
// before padding. Returns cudaGetLastError() after the launch (0 on
// success).
int tpuflow_flash_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Tq, int Tk, int D,
                      int dtype, int causal, int bq, float scale,
                      long long sqb, long long sqt, long long sqh,
                      long long skb, long long skt, long long skh,
                      long long svb, long long svt, long long svh,
                      void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int esz = dtype == 1 ? 2 : 4;
  // 16-byte staging needs every row start 16-byte aligned.
  auto al = [esz](const void* p, long long sb, long long st, long long sh) {
    return (uintptr_t)p % 16 == 0 && (sb * esz) % 16 == 0 &&
           (st * esz) % 16 == 0 && (sh * esz) % 16 == 0;
  };
  Args a{q, k, v, o, (float*)lse, H, Tq, Tk, causal,
         al(q, sqb, sqt, sqh) && al(k, skb, skt, skh) && al(v, svb, svt, svh),
         scale, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(dtype, a, B, bq, s);
    case 64: return launch<64>(dtype, a, B, bq, s);
    case 128: return launch<128>(dtype, a, B, bq, s);
    case 256: return launch<256>(dtype, a, B, bq, s);
    default:
      if (D > 256) return launch_wide(dtype, a, B, D, bq, s);
      return (int)cudaErrorInvalidValue;
  }
}

// The shared memory bytes tpuflow_flash_fwd launches a block with (dynamic;
// static for the wide-head kernel above D = 256); the card tests hold it to
// the per-block limit.
int tpuflow_flash_fwd_smem(int dtype, int D, int bq) {
  return D > 256 ? wide_smem_bytes() : smem_bytes(dtype, D, bq);
}

const char* tpuflow_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

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
// Above 256 flash_fwd_wide takes over (see "wide heads" below): a block
// keeps Q at 512 columns and computes S once a tile.
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
// D > 256, a multiple of 128 (the wrapper pads other head dims up):
// flash_fwd_wide, one kernel for both variants (lse or not) and both
// dtypes. It replaces the same TPU kernels as the narrow ones
// (tpuflow/ops/flash_attention.py::_fwd_kernel_nolse, _fwd_kernel).
//
// What bounds it on the H100 at (1, 1024, 12, 512) causal: the S and P.V
// products, 12.9 GFLOP against 50 MB of q, k, v and o: operations in f32
// (0.1925 ms at 67 TFLOP/s), bytes in bf16 (0.0150 ms at 3.35 TB/s; the
// tensor cores would take 0.0130).
//
// Design. A block owns BQ q rows and a panel of WP = 512 output columns
// (grid.z = ceil(D / WP)); at D <= WP that is every column, so S is
// computed once per (q tile, key tile). Q stays in shared memory at full
// width for the whole key loop; K and V tiles of BK keys at full width
// come by 16-byte cp.async into a two-stage ring (dynamic shared memory,
// 214-217 KB), the next tile loading while this one computes. Per key
// tile: S = Q K^T into a small f32 tile in shared memory; the online
// softmax, TPR lanes a row (max and sum by xor shuffles), writes P
// (rounded to the input dtype, as the TPU kernel casts it before P.V) and
// the row's correction exp(m_old - m_new); then O = O * corr + P V in
// registers over the block's columns.
// bf16 (4 BQ threads, BQ = 32 or 64, BK = 32), both products on mma.sync
// m16n8k16 bf16 -> f32 with ldmatrix fragments, laid out for shared-memory
// traffic, the first bound the tiles met (it cost 13% over the layout of
// 16 x 16 S tiles and 16 x 256 O tiles a warp): a warp sums S for 16 rows
// x all BK keys over half of D (two halves added in a fixed order), and
// owns 32 rows x 128 columns of O (128 f32 registers a lane), each V
// fragment feeding both 16-row halves of P.
// f32 (256 threads, BQ = 32, BK = 16): IEEE FMAs on the CUDA cores, no
// TF32; each warp sums S over an eighth of D (a lane 4 rows x 4 keys, a
// float4 of Q and one of K feed 16 FMAs), the eight partial tiles added in
// a fixed order; a thread owns 8 rows x 8 columns of O and each float4 of
// V feeds 32 FMAs. Neither kernel spills (f32 190 registers, bf16 226).
// Above WP columns a block contracts S over the 512-wide panels in order
// (Q and K staged one panel at a time, without the ring) and keeps P V for
// its own panel. Key tiles are anchored at key 0 and a row's arithmetic
// involves no other row, so the bits depend on neither the plan (BQ) nor
// B, Tq or later keys; fully masked tiles add exact zeros.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W), device ms at
// (1, 1024, 12, 512) causal: f32 0.601-0.606 (bound 0.1925, plain version
// 1.02, SDPA 0.557); bf16 0.139-0.145 (bound 0.0150, plain 1.12, SDPA
// 0.159). The kernel it replaced (S redone per 128-column block, scalar
// f32 FMAs for both dtypes) took 5.03-5.05 and 4.46-4.47 in the same
// call.
constexpr int WP = 512;  // output columns a block owns; a score panel
constexpr int WIDE_MAX_D = 65535 * 128;  // the wrappers' MAX_HEAD_DIM

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

// rows x WP elements into shared memory (row stride RS): rows t0.. and
// columns c0 .. c0 + width - 1 of a seq-strided tensor; rows >= T_len and
// columns >= width are zero.
template <typename T>
__device__ __forceinline__ void load_panel(T* dst, int RS, const T* src,
                                           long long st, int t0, int T_len,
                                           int rows, int c0, int width,
                                           bool aligned) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = WP / E;
  for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * E, t = t0 + r;
    T* d = dst + r * RS + c;
    const bool ok = t < T_len && c < width;
    if (aligned) {
      cp_async16(d, ok ? src + t * st + c0 + c : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = ok ? src[t * st + c0 + c + e] : T(0.f);
    }
  }
}

// A warp's 16 x 8NT tile of A B^T over `width` (a multiple of 16): A's 16
// rows and B's 8NT rows in shared memory (bf16, row stride RS), summed on
// mma.sync in 16-wide steps of d in order.
template <int NT>
__device__ __forceinline__ void mma_scores(float (&c)[NT][4],
                                           const __nv_bfloat16* A,
                                           const __nv_bfloat16* B, int RS,
                                           int width, int lane) {
#pragma unroll 2
  for (int kk = 0; kk < width; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * RS + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, B + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * RS + kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], a, r[0], r[1]);
      mma_bf16(c[2 * np + 1], a, r[2], r[3]);
    }
  }
}

// c[hf] += W[16 hf ..] X for a warp's 32 rows x 8NT columns: W (32 x NK,
// bf16, row stride WS) as A fragments, X (NK x columns, row stride RS) by
// ldmatrix.trans, each B fragment feeding both 16-row halves; column pairs
// of 16 at or past `valid` are skipped.
template <int NT, int NK>
__device__ __forceinline__ void mma_out2(float (&c)[2][NT][4],
                                         const __nv_bfloat16* W, int WS,
                                         const __nv_bfloat16* X, int RS,
                                         int valid, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK; kk += 16) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, W + (lane & 15) * WS + kk + (lane >> 4) * 8);
    ldsm_x4(a1, W + (16 + (lane & 15)) * WS + kk + (lane >> 4) * 8);
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      if (16 * dp < valid) {  // warp-uniform
        uint32_t r[4];
        ldsm_x4_t(r, X + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                         dp * 16 + (lane >> 4) * 8);
        mma_bf16(c[0][2 * dp], a0, r[0], r[1]);
        mma_bf16(c[0][2 * dp + 1], a0, r[2], r[3]);
        mma_bf16(c[1][2 * dp], a1, r[0], r[1]);
        mma_bf16(c[1][2 * dp + 1], a1, r[2], r[3]);
      }
    }
  }
}

// acc[i][c] += A[RSTEP i] . B[CSTEP c] over d in [d0, d1) (f32, row
// stride RS; A and B point at the lane's first rows), four FMAs a float4
// in d order.
template <int NR, int NC, int RSTEP, int CSTEP>
__device__ __forceinline__ void fma_dots(float (&acc)[NR][NC], const float* A,
                                         const float* B, int RS, int d0,
                                         int d1) {
#pragma unroll 2
  for (int d = d0; d < d1; d += 4) {
    float4 av[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + RSTEP * i * RS + d);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 bv =
          *reinterpret_cast<const float4*>(B + CSTEP * c * RS + d);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float x = fmaf(av[i].x, bv.x, acc[i][c]);
        x = fmaf(av[i].y, bv.y, x);
        x = fmaf(av[i].z, bv.z, x);
        acc[i][c] = fmaf(av[i].w, bv.w, x);
      }
    }
  }
}

// acc[i][4j + e] += sum over u < NK, in order, of W[4i][u] X[u][256j + e]
// (f32; W points at the lane's first row, row stride WS; X at its first
// column, row stride RS): 8 rows 4 apart x columns 4cx .. +3 and 256 +
// 4cx .. +3. Each float4 of X feeds 32 FMAs.
template <int NK>
__device__ __forceinline__ void fma_out(float (&acc)[8][8], const float* W,
                                        int WS, const float* X, int RS) {
#pragma unroll
  for (int u0 = 0; u0 < NK; u0 += 4) {
    float4 wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wv[i] = *reinterpret_cast<const float4*>(W + 4 * i * WS + u0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x0 = *reinterpret_cast<const float4*>(X + (u0 + u) * RS);
      const float4 x1 =
          *reinterpret_cast<const float4*>(X + (u0 + u) * RS + 256);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = u == 0 ? wv[i].x
                      : u == 1 ? wv[i].y
                      : u == 2 ? wv[i].z : wv[i].w;
        acc[i][0] = fmaf(w, x0.x, acc[i][0]);
        acc[i][1] = fmaf(w, x0.y, acc[i][1]);
        acc[i][2] = fmaf(w, x0.z, acc[i][2]);
        acc[i][3] = fmaf(w, x0.w, acc[i][3]);
        acc[i][4] = fmaf(w, x1.x, acc[i][4]);
        acc[i][5] = fmaf(w, x1.y, acc[i][5]);
        acc[i][6] = fmaf(w, x1.z, acc[i][6]);
        acc[i][7] = fmaf(w, x1.w, acc[i][7]);
      }
    }
  }
}

// Tile sizes by dtype: BK keys a tile, row strides (elements) of the
// staged tiles (RS), of the f32 S tile (SS, bf16 only) and of P (PS).
template <typename T>
struct WideFwd {  // f32: 8 BQ threads, BQ = 32
  static constexpr int BK = 16, RS = WP + 4, SS = 0, PS = BK + 4;
  static constexpr int TPR = 8;  // softmax lanes a row
};
template <>
struct WideFwd<__nv_bfloat16> {  // 4 BQ threads, BQ = 32 or 64
  static constexpr int BK = 32, RS = WP + 8, SS = BK + 4, PS = BK + 8;
  static constexpr int TPR = 4;
};

// The block's shared memory: Q, the K/V ring, S (bf16) or the eight
// partial S tiles (f32), P, and the rows' correction and denominator.
template <typename T>
__host__ __device__ constexpr int wide_fwd_smem(int bq) {
  using C = WideFwd<T>;
  return (int)sizeof(T) * (bq + 4 * C::BK) * C::RS +
         4 * (sizeof(T) == 2 ? 2 * bq * C::SS : 8 * bq * C::BK) +
         (int)sizeof(T) * bq * C::PS + 8 * bq;
}

template <typename T>
__global__ void __launch_bounds__(256, 1)
flash_fwd_wide(const Args a, int D) {
  using C = WideFwd<T>;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int BK = C::BK, RS = C::RS, PS = C::PS, TPR = C::TPR;
  constexpr int KPT = BK / TPR;  // softmax keys a lane
  extern __shared__ __align__(16) uint8_t smem[];
  const int BQ = blockDim.x / (BF ? 4 : 8);
  T* Qs = reinterpret_cast<T*>(smem);
  T* ring = Qs + BQ * RS;  // [2][K, V][BK][RS]
  float* Sb = reinterpret_cast<float*>(ring + 4 * BK * RS);
  T* Ps = reinterpret_cast<T*>(Sb + (BF ? 2 * BQ * C::SS : 8 * BQ * BK));
  float* corr_s = reinterpret_cast<float*>(Ps + BQ * PS);
  float* l_s = corr_s + BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, col0 = blockIdx.z * WP;
  const int n_pan = (D + WP - 1) / WP, own = min(WP, D - col0);
  const T* qb = (const T*)a.q + b * a.sqb + h * a.sqh;
  const T* kb = (const T*)a.k + b * a.skb + h * a.skh;
  const T* vb = (const T*)a.v + b * a.svb + h * a.svh;
  const bool al = a.aligned;
  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  auto kslot = [&](int s) { return ring + 2 * s * BK * RS; };
  auto vslot = [&](int s) { return ring + (2 * s + 1) * BK * RS; };

  // bf16 warps: S rows 16 rg over d half dh (all BK keys); O rows 32 rp,
  // columns 128 cq.
  const int WR = BQ / 16, rg = warp % WR, dh = warp / WR;
  const int rp = warp >> 2, cq = warp & 3;
  // f32 lanes: S rows ry + 8i of keys kx + 4c over d eighth `warp`; O rows
  // oy + 4i, columns 4 ox (+ 256).
  const int kx = lane & 3, ry = lane >> 2, oy = tid >> 6, ox = tid & 63;
  float sc[4][4];
  float o2[BF ? 2 : 1][BF ? 16 : 1][4];    // bf16 O
  float o[BF ? 1 : 8][BF ? 1 : 8];         // f32 O
#pragma unroll
  for (int i = 0; i < (BF ? 2 : 1); ++i)
#pragma unroll
    for (int n = 0; n < (BF ? 16 : 1); ++n)
      o2[i][n][0] = o2[i][n][1] = o2[i][n][2] = o2[i][n][3] = 0.f;
#pragma unroll
  for (int i = 0; i < (BF ? 1 : 8); ++i)
#pragma unroll
    for (int c = 0; c < (BF ? 1 : 8); ++c) o[i][c] = 0.f;
  auto scores_acc = [&](const T* Qp, const T* Kp, int width) {
    if constexpr (BF) {
      const int hw = width / 2;
      mma_scores<4>(sc, Qp + 16 * rg * RS + dh * hw, Kp + dh * hw, RS, hw,
                    lane);
    } else {
      const int w8 = width / 8;
      fma_dots<4, 4, 8, 4>(sc, Qp + ry * RS, Kp + kx * RS, RS, warp * w8,
                           warp * w8 + w8);
    }
  };
  // The S entry (row r, key k) of the tile, once the tile is stored.
  auto score = [&](int r, int k) {
    if constexpr (BF) {
      return Sb[r * C::SS + k] + Sb[(BQ + r) * C::SS + k];
    } else {
      float s = Sb[r * BK + k];
#pragma unroll
      for (int w = 1; w < 8; ++w) s += Sb[(w * BQ + r) * BK + k];
      return s;
    }
  };

  const int srow = tid / TPR, part = tid % TPR;  // softmax: row, lane
  float m_r = NEG_INF, l_r = 0.f;
  if (n_pan == 1) {
    load_panel<T>(Qs, RS, qb, a.sqt, q0, a.Tq, BQ, 0, D, al);
    if (n_kt > 0) {
      load_panel<T>(kslot(0), RS, kb, a.skt, 0, a.Tk, BK, 0, D, al);
      load_panel<T>(vslot(0), RS, vb, a.svt, 0, a.Tk, BK, 0, D, al);
    }
    cp_async_commit();
  }

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    const int slot = n_pan == 1 ? j & 1 : 0;
    if (n_pan == 1) {
      cp_async_wait<0>();  // tile j has landed
      __syncthreads();     // ... for every thread; the other slot is free
      if (j + 1 < n_kt) {
        load_panel<T>(kslot(slot ^ 1), RS, kb, a.skt, k0 + BK, a.Tk, BK, 0,
                      D, al);
        load_panel<T>(vslot(slot ^ 1), RS, vb, a.svt, k0 + BK, a.Tk, BK, 0,
                      D, al);
      }
      cp_async_commit();
      scores_acc(Qs, kslot(slot), D);
    } else {
      // Above WP columns: S over the panels in order, Q and K staged one
      // panel at a time; V at the block's own panel.
      __syncthreads();  // the previous tile's V, S and P have been read
      load_panel<T>(vslot(0), RS, vb + col0, a.svt, k0, a.Tk, BK, 0, own,
                    al);
      for (int p = 0; p < n_pan; ++p) {
        const int w = min(WP, D - p * WP);
        if (p) __syncthreads();  // panel p-1 has been read
        load_panel<T>(Qs, RS, qb + p * WP, a.sqt, q0, a.Tq, BQ, 0, w, al);
        load_panel<T>(kslot(0), RS, kb + p * WP, a.skt, k0, a.Tk, BK, 0, w,
                      al);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        scores_acc(Qs, kslot(0), w);
      }
    }
    if constexpr (BF) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Sb[(dh * BQ + 16 * rg + g + 8 * (c >> 1)) * C::SS + 8 * n + 2 * t +
             (c & 1)] = sc[n][c];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Sb[(warp * BQ + ry + 8 * i) * BK + kx + 4 * c] = sc[i][c];
    }
    __syncthreads();  // S is stored

    // Online softmax of row srow over this lane's KPT keys.
    {
      const int row = q0 + srow;
      float x[KPT];
      float mx = m_r;
#pragma unroll
      for (int e = 0; e < KPT; ++e) {
        const int k = part * KPT + e;
        x[e] = masked(score(srow, k), a.scale, row, k0 + k, a.Tk, a.causal);
        mx = fmaxf(mx, x[e]);
      }
#pragma unroll
      for (int s = 1; s < TPR; s <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < KPT; ++e) {
        const float p = prob(x[e], mx);
        sum += p;
        Ps[srow * PS + part * KPT + e] = from_f32<T>(p);
      }
#pragma unroll
      for (int s = 1; s < TPR; s <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, s);
      const float corr = expf(m_r - mx);
      l_r = l_r * corr + sum;
      m_r = mx;
      if (part == 0) corr_s[srow] = corr;
    }
    __syncthreads();  // P and the corrections are written

    // O = O * corr + P V over the block's columns.
    const T* Vt = vslot(slot);
    if constexpr (BF) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float c0 = corr_s[32 * rp + 16 * hf + g];
        const float c1 = corr_s[32 * rp + 16 * hf + g + 8];
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          o2[hf][n][0] *= c0;
          o2[hf][n][1] *= c0;
          o2[hf][n][2] *= c1;
          o2[hf][n][3] *= c1;
        }
      }
      mma_out2<16, BK>(o2, Ps + 32 * rp * PS, PS, Vt + 128 * cq, RS,
                       own - 128 * cq, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = corr_s[oy + 4 * i];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] *= c;
      }
      fma_out<BK>(o, Ps + oy * PS, PS, Vt + 4 * ox, RS);
    }
  }

  cp_async_wait<0>();  // no copy outlives the block (n_kt may be 0)
  __syncthreads();
  if (part == 0) {
    const float l = fmaxf(l_r, 1e-30f);
    l_s[srow] = l;
    if (a.lse != nullptr && blockIdx.z == 0 && q0 + srow < a.Tq)
      a.lse[(long long)bh * a.Tq + q0 + srow] = m_r + logf(l);
  }
  __syncthreads();
  T* ob = (T*)a.o + col0;
  if constexpr (BF) {
#pragma unroll
    for (int hr = 0; hr < 4; ++hr) {
      const int hf = hr >> 1, r = hr & 1;
      const int lr = 32 * rp + 16 * hf + g + 8 * r, row = q0 + lr;
      if (row >= a.Tq) continue;
      const float l = l_s[lr];
      T* orow = ob + (((long long)b * a.Tq + row) * a.H + h) * D;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = 128 * cq + 8 * n + 2 * t;
        if (col < own)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o2[hf][n][2 * r] / l, o2[hf][n][2 * r + 1] / l);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lr = oy + 4 * i, row = q0 + lr;
      if (row >= a.Tq) continue;
      const float l = l_s[lr];
      T* orow = ob + (((long long)b * a.Tq + row) * a.H + h) * D;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 4 * ox + 256 * j;
        if (col < own)
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(o[i][4 * j] / l, o[i][4 * j + 1] / l,
                          o[i][4 * j + 2] / l, o[i][4 * j + 3] / l);
      }
    }
  }
}

// bq: the plan's q tile height (bf16 32 or 64, f32 32).
int wide_smem_bytes(int dtype, int bq) {
  return dtype == 1 ? wide_fwd_smem<__nv_bfloat16>(bq)
                    : wide_fwd_smem<float>(bq);
}

int launch_wide(int dtype, const Args& a, int B, int D, int bq,
                cudaStream_t stream) {
  const int n_z = (D + WP - 1) / WP;
  if ((dtype == 1 ? bq != 32 && bq != 64 : bq != 32) || D % 128 ||
      D > WIDE_MAX_D)
    return (int)cudaErrorInvalidValue;
  const int smem = wide_smem_bytes(dtype, bq);
  const dim3 grid(B * a.H, (a.Tq + bq - 1) / bq, n_z);
  const auto kern = dtype == 1 ? flash_fwd_wide<__nv_bfloat16>
                               : flash_fwd_wide<float>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, (dtype == 1 ? 4 : 8) * bq, smem, stream>>>(a, D);
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
// or 64; 32 at D = 256 and in f32 above it), is the launch plan's
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

// The dynamic shared memory bytes tpuflow_flash_fwd launches a block with;
// the card tests hold it to the per-block limit.
int tpuflow_flash_fwd_smem(int dtype, int D, int bq) {
  return D > 256 ? wide_smem_bytes(dtype, bq) : smem_bytes(dtype, D, bq);
}

const char* tpuflow_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

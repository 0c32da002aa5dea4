// Fused RMSNorm for Hopper (sm_90a): forward (B1) and backward (B2).
//
// B1 replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel
// (pallas_call at rmsnorm.py:76, reached through rmsnorm() :133):
//     y = x * rsqrt(mean(x^2) + eps) * (1 + g)   per row, f32 accumulation.
//
// What bounds it on the H100: device-memory bandwidth.  Each element is read
// once and written once (2 * rows * D * itemsize bytes, plus the gain)
// against ~4 flops per element, far below the card's ~295 flop/byte ridge.
//
// What the design does about it: it spends nothing on tiling.  One warp owns
// one row, so the row's sum of squares is a register sum plus a five-step
// shuffle, with no shared memory and no __syncthreads.  The second pass
// re-reads the row it has just loaded, which hits L1/L2, so device-memory
// traffic stays one read and one write per element.  Lanes stride over the
// row, so any D works (576 is not a power of two).  The decode case (8 rows)
// runs 8 warps; large row counts fill the card with 4-warp blocks.  Where
// the TPU kernel zero-pads rows to its block, a warp past the last row here
// simply exits.
//
// A gain per group (an HP sweep's candidates, each with its own norm gains,
// batched on a leading axis): the gain is (G, D) and the rows are G equal
// contiguous groups, row r taking gain row r / (rows / G).  Where jax.vmap
// turns the TPU kernel's pallas_call into a grid axis over the candidates,
// here it is one more index in the same single launch.  G = 1 is the (D,)
// gain.
//
// B2 replaces src/repro/kernels/rmsnorm.py::_rmsnorm_bwd_kernel (pallas_call
// at rmsnorm.py:92, the custom_vjp backward at :117).  With
// r = rsqrt(mean(x^2) + eps):
//     dx    = r (1 + g) dy - x r^3 / D * sum_j dy_j (1 + g_j) x_j
//     dgain = sum_rows dy * x * r   (with G groups: (G, D), row g summed
//                                   over group g's rows only)
// Like the TPU kernel it recomputes r from x instead of reading a residual.
//
// What bounds it: bandwidth again — x and dy are read once, dx written
// once (3 * rows * D * itemsize bytes), ~12 flops per element.
//
// What the design does about it: one launch, each row read once.  dx is
// B1's warp-per-row scheme (the row's sum of squares and its dy.(1+g).x dot
// product reduced together in registers and shuffles).  Where D and the
// pointers allow (D a multiple of 16 bytes' elements and at most 1024,
// every tensor 16-byte aligned: D = 1024 and 576 do) a lane loads
// its share of the row as 16-byte pieces (column pieces lane, lane + 32,
// ...), keeps x and dy in registers for the second pass, and loads its
// share of the warp's next row while it works on this one (at D = 1024,
// f32: 208 registers, one block of 8 warps an SM, ~4 rows a warp; without
// the prefetch 128 registers and two blocks an SM ran 24.4 us against
// 21.7 on an H100); any other D takes a scalar path that reads the row
// again (from L1/L2).  dgain is
// the hard part: the TPU sums it across a *sequential* grid in VMEM, but
// GPU blocks run in no order.  The grid is the blocks that are resident at
// once (the occupancy times the SM count, read from the device), each
// walking a fixed set of rows; a lane keeps its columns' dgain partial sums
// in registers across its rows (the scalar path in its warp's row of shared
// memory), the block sums its warps in order into its row of an f32
// scratch (n_blocks, D) that the wrapper allocates, and after a grid-wide
// barrier (a cooperative launch) the warps of every block sum the
// scratch's columns, a warp a column, its lanes over the blocks, then a
// butterfly.  The result is
// deterministic: the same inputs give the same bits.
//
// With G groups no partial sum may mix two groups' rows.  So the work is
// cut into G x bpg *virtual blocks*, each confined to one group (its rows
// j*warps + warp, (j + bpg)*warps + warp, ... of that group) and owning one
// row of the scratch; the resident blocks walk the virtual blocks in turn
// (v = blockIdx.x, + gridDim.x, ...), flushing each one's sums before the
// next.  bpg is the resident blocks over G (at least 1, no more than a
// group's rows need), so at G = 1 a block is one virtual block, as before,
// and for G above the resident blocks a block runs several.  After the
// barrier a warp sums one (group, column) over that group's bpg scratch
// rows in a fixed order.  The scratch costs
// 2 * n_blocks * D * 4 bytes of traffic (~1 MB at the training shape, 4096
// x 1024 f32, against 50 MB), in L2.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kWarpsPerBlock = 4;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
               T* __restrict__ y, int rows, int D, int rpg, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  g += (size_t)(row / rpg) * D;  // the row's group's gain (rpg = rows at G = 1)
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / (float)D + eps);

  for (int c = lane; c < D; c += 32) {
    yr[c] = from_f32<T>(to_f32(xr[c]) * r * (1.f + g[c]));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); the gain is always float32,
// (groups, D), and groups divides rows.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int repro_rmsnorm_grouped(const void* x, const void* g, void* y, int rows,
                                     int D, int groups, float eps, int dtype,
                                     void* stream) {
  if (groups < 1 || rows % groups != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rpg = rows / groups;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(y), rows, D, rpg, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(y), rows, D, rpg, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The (D,) gain: one group (B1's serve path).
extern "C" int repro_rmsnorm(const void* x, const void* g, void* y, int rows,
                             int D, float eps, int dtype, void* stream) {
  return repro_rmsnorm_grouped(x, g, y, rows, D, 1, eps, dtype, stream);
}

namespace {

namespace cg = cooperative_groups;

constexpr int kBwdMaxWarps = 8;
constexpr int kMaxBwdSmem = 227 * 1024;

// warps per block: as many as fit 48 KB of per-warp dgain rows, at most 8
int bwd_warps(int D) {
  int w = (48 * 1024) / (D * (int)sizeof(float));
  return w < 1 ? 1 : (w > kBwdMaxWarps ? kBwdMaxWarps : w);
}

// 16 bytes of T as f32, and back (each value rounded as from_f32 rounds it)
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(w[e] << 16);
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = __bfloat16_as_ushort(from_f32<__nv_bfloat16>(x[2 * e]));
    const uint32_t hi = __bfloat16_as_ushort(from_f32<__nv_bfloat16>(x[2 * e + 1]));
    w[e] = lo | hi << 16;
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
// V consecutive floats of the f32 gain
template <int V>
__device__ __forceinline__ void load_gain(const float* g, float (&w)[V]) {
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    const float4 a = *reinterpret_cast<const float4*>(g + e);
    w[e] = a.x; w[e + 1] = a.y; w[e + 2] = a.z; w[e + 3] = a.w;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NV > 0: the row in registers, NV 16-byte pieces a lane at most; NV = 0:
// the scalar path.  Launched cooperatively with at most the resident blocks,
// which walk the groups x bpg virtual blocks (the scratch's rows) in turn.
template <typename T, int NV>
__global__ void __launch_bounds__(kBwdMaxWarps * 32)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g0,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, float* __restrict__ dgain, int rows,
                   int D, int groups, int bpg, float eps) {
  extern __shared__ float acc[];  // (warps, D): each warp's dgain sums
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* mine = acc + (size_t)warp * D;
  const long long rpg = rows / groups;
  const long long stride = (long long)bpg * warps;
  const int n_virtual = groups * bpg;

  for (int vb = blockIdx.x; vb < n_virtual; vb += gridDim.x) {
    const int grp = vb / bpg;
    const float* __restrict__ g = g0 + (size_t)grp * D;  // this group's gain
    const long long end = (grp + 1) * rpg;                // past its last row
    const long long row0 = grp * rpg + (long long)(vb % bpg) * warps + warp;

    if constexpr (NV > 0) {
      constexpr int V = 16 / sizeof(T);
      const int pieces = D / V;
      // this lane's share of a row, pieces lane, lane + 32, ... (zeros past
      // D or past the last row)
      auto load_row = [&](long long row, float (&xv)[NV][V], float (&yv)[NV][V]) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = (lane + 32 * i) * V;
          if (row < end && lane + 32 * i < pieces) {
            load16(x + row * D + c, xv[i]);
            load16(dy + row * D + c, yv[i]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) xv[i][e] = yv[i][e] = 0.f;
          }
        }
      };
      float dg[NV][V], xv[NV][V], yv[NV][V];
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) dg[i][e] = 0.f;
      load_row(row0, xv, yv);
      for (long long row = row0; row < end; row += stride) {
        float xn[NV][V], yn[NV][V];
        load_row(row + stride, xn, yn);   // the next row's loads fly during this row
        float ss = 0.f, dot = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if (lane + 32 * i >= pieces) continue;
          float w[V];
          load_gain<V>(g + (lane + 32 * i) * V, w);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            ss += xv[i][e] * xv[i][e];
            dot += yv[i][e] * (1.f + w[e]) * xv[i][e];
          }
        }
        ss = warp_sum(ss);
        dot = warp_sum(dot);
        const float r = rsqrtf(ss / (float)D + eps);
        const float k = r * r * r / (float)D * dot;
        T* dxr = dx + row * D;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          if (lane + 32 * i >= pieces) continue;
          float w[V], out[V];
          load_gain<V>(g + (lane + 32 * i) * V, w);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            out[e] = r * ((1.f + w[e]) * yv[i][e]) - xv[i][e] * k;
            dg[i][e] += yv[i][e] * xv[i][e] * r;
          }
          store16(dxr + (lane + 32 * i) * V, out);
        }
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            xv[i][e] = xn[i][e];
            yv[i][e] = yn[i][e];
          }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (lane + 32 * i < pieces)
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(mine + (lane + 32 * i) * V + e) =
                make_float4(dg[i][e], dg[i][e + 1], dg[i][e + 2], dg[i][e + 3]);
    } else {
      // a warp's row of acc is touched only by its own lanes (lane c owns
      // columns c, c + 32, ...) until the __syncthreads below
      for (int c = lane; c < D; c += 32) mine[c] = 0.f;
      for (long long row = row0; row < end; row += stride) {
        const T* xr = x + row * D;
        const T* dyr = dy + row * D;
        T* dxr = dx + row * D;
        float ss = 0.f, dot = 0.f;
        for (int c = lane; c < D; c += 32) {
          const float xv = to_f32(xr[c]);
          ss += xv * xv;
          dot += to_f32(dyr[c]) * (1.f + g[c]) * xv;
        }
        ss = warp_sum(ss);
        dot = warp_sum(dot);
        const float r = rsqrtf(ss / (float)D + eps);
        const float k = r * r * r / (float)D * dot;
        for (int c = lane; c < D; c += 32) {
          const float xv = to_f32(xr[c]);
          const float dyv = to_f32(dyr[c]);
          dxr[c] = from_f32<T>(r * ((1.f + g[c]) * dyv) - xv * k);
          mine[c] += dyv * xv * r;
        }
      }
    }
    __syncthreads();
    // the block's warps in order into the virtual block's row of the scratch
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < warps; ++w) s += acc[(size_t)w * D + c];
      partial[(size_t)vb * D + c] = s;
    }
    __syncthreads();  // acc is the next virtual block's
  }
  __threadfence();
  cg::this_grid().sync();

  // dgain[grp][c] = the scratch's column c over the group's bpg rows, summed
  // in a fixed order: a warp a (group, column), lane l adding the rows l,
  // l + 32, ... in turn, then a butterfly over the lanes (read through L2:
  // other blocks wrote the scratch)
  const long long tasks = (long long)groups * D;
  for (long long t = (long long)blockIdx.x * warps + warp; t < tasks;
       t += (long long)gridDim.x * warps) {
    const float* col = partial + (size_t)(t / D) * bpg * D + t % D;
    float s = 0.f;
#pragma unroll 4
    for (int b = lane; b < bpg; b += 32) s += __ldcg(col + (size_t)b * D);
    s = warp_sum(s);
    if (lane == 0) dgain[t] = s;
  }
}

// the current device's SM count, read once
cudaError_t sm_count(int* n) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *n = count;
  return cudaSuccess;
}

// One call's launch: the kernel instance, its block and shared memory, and
// its grid (the resident blocks, no more than the rows need).
struct BwdPlan {
  const void* fn;
  int warps, blocks;   // the grid: at most the resident blocks
  int bpg;             // virtual blocks a group (the scratch has groups x bpg rows)
  size_t smem;
};

template <typename T, int NV>
const void* bwd_fn() {
  return reinterpret_cast<const void*>(&rmsnorm_bwd_kernel<T, NV>);
}

// a lane holds at most 32 values of a row in registers (and 32 of the next):
// D <= 1024 with whole 16-byte pieces takes the register path
template <typename T>
const void* bwd_instance(int D, bool aligned) {
  constexpr int V = 16 / sizeof(T), kMax = 32 / V;
  const int need = (D / V + 31) / 32;
  if (!aligned || D % V != 0 || need > kMax) return bwd_fn<T, 0>();
  return need <= 4 ? bwd_fn<T, 4>() : bwd_fn<T, kMax>();
}

// blocks an SM of (fn, threads, smem), asked of the runtime once each
cudaError_t resident(const void* fn, int threads, size_t smem, int* per_sm) {
  struct Entry { const void* fn; int threads; size_t smem; int n; };
  static Entry seen[32];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (seen[i].fn == fn && seen[i].threads == threads && seen[i].smem == smem) {
      *per_sm = seen[i].n;
      return cudaSuccess;
    }
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, smem);
  if (e != cudaSuccess) return e;
  if (used < 32) seen[used++] = Entry{fn, threads, smem, *per_sm};
  return cudaSuccess;
}

cudaError_t bwd_plan(BwdPlan* pl, const void* x, const void* g, const void* dy, const void* dx,
                     int rows, int D, int groups, int dtype) {
  if (rows < 1 || D < 1 || (dtype != 0 && dtype != 1) || groups < 1 || rows % groups != 0)
    return cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx);
  const bool aligned = (any & 15) == 0;
  pl->fn = dtype == 0 ? bwd_instance<float>(D, aligned) : bwd_instance<__nv_bfloat16>(D, aligned);
  pl->warps = bwd_warps(D);
  pl->smem = (size_t)pl->warps * D * sizeof(float);
  if (pl->smem > (size_t)kMaxBwdSmem) return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t e = resident(pl->fn, pl->warps * 32, pl->smem, &per_sm);
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // a group's rows over the resident blocks' share of it
  const long long need = ((long long)(rows / groups) + pl->warps - 1) / pl->warps;
  const long long cap = (long long)per_sm * sms;
  const long long share = cap / groups > 0 ? cap / groups : 1;
  pl->bpg = (int)(need < share ? need : share);
  const long long virt = (long long)groups * pl->bpg;
  if (virt >= (1LL << 31) || virt * D >= (1LL << 40)) return cudaErrorInvalidValue;
  pl->blocks = (int)(virt < cap ? virt : cap);
  return cudaSuccess;
}

}  // namespace

// Rows of the f32 dgain scratch that repro_rmsnorm_bwd needs for these
// tensors (its virtual blocks: groups x bpg); a negative CUDA error code if
// it cannot launch.
extern "C" int repro_rmsnorm_bwd_blocks(const void* x, const void* g, const void* dy,
                                        const void* dx, int rows, int D, int groups,
                                        int dtype) {
  BwdPlan pl;
  const cudaError_t e = bwd_plan(&pl, x, g, dy, dx, rows, D, groups, dtype);
  return e == cudaSuccess ? groups * pl.bpg : -static_cast<int>(e);
}

// dtype as repro_rmsnorm (x, dy and dx share it); g and dgain float32,
// (groups, D); partial is float32 (n_blocks, D) scratch, n_blocks from
// repro_rmsnorm_bwd_blocks for the same tensors.  One (cooperative)
// launch; returns cudaGetLastError() after it.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* g, const void* dy,
                                 void* dx, void* dgain, void* partial,
                                 int n_blocks, int rows, int D, int groups, float eps,
                                 int dtype, void* stream) {
  BwdPlan pl;
  cudaError_t e = bwd_plan(&pl, x, g, dy, dx, rows, D, groups, dtype);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_blocks != groups * pl.bpg) return static_cast<int>(cudaErrorInvalidValue);
  int bpg = pl.bpg;
  void* args[] = {(void*)&x, (void*)&g, (void*)&dy, &dx, &partial, &dgain, &rows, &D,
                  &groups, &bpg, &eps};
  e = cudaLaunchCooperativeKernel(pl.fn, dim3(pl.blocks), dim3(pl.warps * 32), args, pl.smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

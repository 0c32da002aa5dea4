// Hopper tensor-core and asynchronous-copy primitives for the flash
// attention kernels (csrc/flash_attention.cu), as inline PTX for sm_90a:
// bf16 mma.sync m16n8k16 with f32 accumulators, s8 mma.sync m16n8k32 with
// s32 accumulators, ldmatrix (plain and transposed) from shared memory,
// cp.async copies into shared memory, tensor copies by the copy engine
// (TMA) that complete on an mbarrier, and the round-to-nearest-even packing
// of two f32 values into a bf16x2 word.
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4; each 32-bit
// register holds two bf16 values, the lower column in the low half):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, k by n):     b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so a C tile of 16 rows by 16 columns, rounded and packed pairwise, is the
// A fragment of the next product (flash attention's p).
//
// Fragment layouts of m16n8k32 s8 (each register four bytes, the lowest k
// in the low byte):
//   A (16 x 32, row-major): a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..),
//                           a3 (g+8, 16+4t..)
//   B (32 x 8, k by n):     b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g)
//   C (16 x 8, s32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// Both operands are K-contiguous (8-bit operands have no transposed
// ldmatrix), so ldmatrix (b16) of byte rows gives them: 8 rows of 16 bytes
// a matrix, register i of lane (g, t) bytes 4t..4t+3 of row g.  A C tile of
// 16 columns does not hold A's bytes: a thread has columns 2t, 2t+1, 8+2t,
// 9+2t where A wants 4t..4t+3, so the int8 kernels permute the contraction
// axis in each 16-group (flash_attention.cu, frag_perm).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: one m16n8k32 product, s8 operands, s32 accumulators (exact:
// no sum of the flash kernels' int8 products comes near 2^31)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i's (row g, columns 2t, 2t+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed: register i receives matrix i's (rows
// 2t, 2t+1; column g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 4 bytes from device memory to shared memory
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 16 bytes from device memory to shared memory, past L1 (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// close the group of cp.async this thread started since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
// (groups land in the order they were committed)
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// An mbarrier in shared memory: a phase completes when `count` arrivals
// have been made and every byte announced by expect_tx has landed (the
// copies that complete on it).  An arrival releases the arriving thread's
// writes to the threads that wait on the phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// phase that never completes (a byte count that does not match its copies)
// traps after some seconds instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// The box of a 3-D tensor (its tensor map `map`, a __grid_constant__
// kernel parameter) at coordinates (c0, c1, c2), innermost first, from
// device memory to shared memory (128-byte aligned, the box dense, its
// innermost axis fastest) by the copy engine (TMA), completing on `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_addr(bar))
      : "memory");
}

// wait until every cp.async this thread started has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace repro

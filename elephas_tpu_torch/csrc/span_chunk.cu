// Chunk attention over the fixed KV arena for Hopper (sm_90a): C query rows
// a slot, each at its own absolute position, over the first `span` positions
// of the slot's arena row, on the tensor cores in 3xTF32, with the span split
// over the card and the splits merged by their lse.
//
// Replaces elephas_tpu/ops/flash_serving.py::flash_span_chunk (:93), plain
// XLA in the reference, not a Pallas kernel: the attention of chunked
// prefill, of the suffix prefill after a prefix-cache hit and of the
// speculative verify pass (elephas_tpu/serving/kv_cache.py:476, :603).
//
// What it computes, per (slot b, chunk row c, head h): with p = pos[b, c]
// read from device memory (no host sync), the keys j with j <= p and
// j < span are visible; s_j = q . k_j * scale in fp32, softmax over the
// visible keys in fp32 and out = sum_j p_j v_j, or zeros when no key is
// visible. A row's position past the span (a padded tail, an inactive
// lane) reads nothing beyond the span: its visible count is clamped, as the
// decode kernel clamps a stale cursor.
//
// Layout: q and out are contiguous [B, H, C, D]; pos is contiguous [B, C]
// int32; k and v are views of the arena [slots, maxlen, H, D] cut to
// [slots, span, H, D], passed as element strides (slot, position, head)
// with unit stride on D; row b of q reads arena slot slot_map[b] (int64,
// null = b), so a call over some of the arena's slots copies nothing.
//
// What bounds it on the H100: each row does 4 * D flops a visible key, and a
// slot's K and V rows (8 * D bytes a key) serve all its C rows, so at C = 64
// it is bound by operations. On the CUDA cores (fp32 FMA, 67 TFLOP/s) that
// bound is 2.5x the one on the tensor cores in 3xTF32 (495 / 3 TFLOP/s).
//
// Design.
// - Tensor cores: both products, S = Q.K^T and O += P.V, are warp-level
//   mma.sync.m16n8k8 in TF32 with the 3xTF32 split (x = hi + lo, hi the 10
//   mantissa bits TF32 keeps, lo = x - hi exact; lo.hi + hi.lo + hi.hi
//   accumulated in fp32), as csrc/flash_fwd.cu's fp32 route: fp32 accuracy
//   at a third of the TF32 rate. mma.sync and not wgmma: wgmma takes TF32
//   operands K-major only, so V would need a transpose in shared memory
//   (and P a round trip through it), and a warp's 16 rows fit the chunk's
//   ragged row counts (1 for verify) better than a warpgroup's 64. The k
//   index of each mma is permuted so q and k fragments load as 128-bit
//   words and the score C fragment is P's A fragment with no shuffle.
// - Q in registers: a warp owns 16 rows; their fragments are loaded once
//   from device memory, scaled by scale * log2(e) (softmax in exp2) before
//   the split, and kept raw in registers over the whole span (split again
//   at each use: two instructions, where keeping hi and lo would double the
//   D / 2 registers they take). At D = 128 those 64 registers beside the
//   output's 64 spill, so there the scaled fragments are written once to a
//   Q tile in shared memory and read back each step, as flash_fwd.cu reads
//   its Q tile.
// - Eight warps a block, two a slice of 16 rows: one takes the first 32
//   keys of every tile, the other the last 32, each with its own online
//   softmax state, and the second's state folds into the first's through
//   shared memory at the end, in that order. A 32-key step keeps the score
//   fragments small beside Q and the output at D = 128, and two warps a
//   slice keep two independent chains of mma on each SM sub-partition,
//   where the grid is small (one slot's chunk: 4 heads x a few splits).
// - Tiles: 64 keys of K and V a stage, in a ring of two stages in shared
//   memory filled by 16-byte cp.async (keys past the block's last visible
//   one zero-filled), so the copy of tile j + 1 runs under tile j's
//   products; one barrier a tile. Row strides are padded so the fragment
//   loads hit distinct banks (K: rows 16 words apart mod 32 for 128-bit
//   loads; V: 4 words for scalar loads).
// - Masks: a half tile wholly visible to the warp's rows takes no mask;
//   only one that crosses a row's visible count is masked; halves past the
//   warp's deepest row are skipped, and tiles past the block's deepest row
//   are never loaded.
// - Grid: (slot x group of 64 rows, head, split); the deeper groups of a
//   slot start first. Each block stops at its own group's deepest visible
//   key, which every warp finds by itself (the group's positions one a
//   lane, a shuffle reduction: no barrier before the first copies), so the
//   early groups of a wide chunk (a prefix hit's suffix of up to maxlen
//   rows) read fewer tiles. C is any count from 1 (verify) up.
// - Splits: the host picks them from the span, the rows and groups, the
//   head dim and the SM count (ops/flash_serving.py::span_chunk_splits),
//   never from the positions; every split is whole 64-key tiles. With more
//   than one, each block writes its unnormalised partial (m, l, acc[D]) per
//   row to a workspace the wrapper allocates on the caller's stream, and a
//   second kernel merges a row's partials in split order by lse; with one,
//   the block writes the output and nothing else runs. Every order is
//   fixed: a call repeats bit for bit, and a CUDA graph replays it as it is.
//
// Paged variant (elephas_paged_span_chunk). Replaces paged_chunk_forward's
// gather and attention (elephas_tpu/serving/paged_kv.py:479; its attention
// flash_span_chunk with kv_dtype and kv_scales, dequantizing in the tile
// loop at elephas_tpu/ops/flash_serving.py:130-141): plain XLA in the
// reference. Row b of q reads the keys of table row b: key j in block
// tables[b, j / block_size] of the pool [num_blocks + 1, block_size, H, Ds],
// row j % block_size; a sentinel id (num_blocks) reads the sink block, which
// no request leases, and feeds only masked rows. Only the tile loader
// changes (ArenaTiles / PagedTiles below) and, with 2 to 8 splits, where the
// partials merge; the products, the split rule, the tile order and the merge
// arithmetic are the arena kernel's, and the hi/lo split of 3xTF32 is taken
// from the dequantized fp32 value, so the output is bit-equal to the arena
// kernel over the gathered, dequantized span. Bound: the visible codes and
// scales read once, or the products at the 3xTF32 rate.
//
// At the paged engine's launch (one table row of 64 rows, 4 heads, spans of
// 128-512 split into 2-8 splits of one 64-key tile) a block holds one tile,
// so its time is a serial chain, not work. What the paged design does:
// - Before any barrier, every warp reads its rows' positions and, one
//   position a lane, the group's deepest visible key (a shuffle reduction:
//   no shared memory, no barrier); the first tile's table entries are read
//   in the same breath, and its row copies go out after Q's fetch (issued
//   ahead of it they measured slower). Keys past the group's deepest visible
//   one are never copied (zero-filled, or zeros in the dequantized stage):
//   a non-finite value in a stale or unleased pool row cannot reach p . v.
// - Later tiles read their block ids from a window of kTable table entries
//   staged in shared memory once a block (refilled only when a range with
//   block_size 1 outgrows it), and walk the pages key-major: one division a
//   tile, not one a 16-byte piece.
// - fp rows go by 16-byte cp.async straight into a ring of two K/V stages;
//   int8 and int4 codes (a D-128 row: 8 or 4 pieces of 16 bytes) and their
//   (position, head) scales go by cp.async into a ring of code stages, and
//   are dequantized into one K/V stage once a tile (one code * scale product
//   a value, as the reference's dequantize_rows) while the next tile's codes
//   are in flight, between two barriers.
// - With 2 to 8 splits the grid is launched in thread-block clusters of the
//   splits of one (row group, head) (cudaLaunchKernelEx), and the partials
//   merge in the cluster, with no workspace and no second launch. The splits
//   that see no key of the group leave at once, before any cluster barrier
//   (which waits only for threads that have not exited), so their SMs take
//   the next clusters; one live split (a chunk early in a long table span)
//   writes the output itself, as an unsplit block does. Two or more own the
//   group's rows in equal runs: each stores its partial (m, l, acc) of
//   every row into the inbox of the row's owner through distributed shared
//   memory, one release / acquire cluster barrier follows, and each block
//   merges its own rows from its inbox with the merge kernel's arithmetic,
//   in split order (each row's weights and 1 / l once, then its pieces).
//   Only stores cross blocks: reading the partials remotely, and a second
//   barrier to keep them alive, measured slower than the merge kernel. Past
//   8 splits (spans over 512 keys) the workspace and the merge kernel stay.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowWarps = 4;          // 16 query rows a warp
constexpr int kWarps = 2 * kRowWarps;  // two warps a row slice, one a tile half
constexpr int kGroup = 16 * kRowWarps;  // query rows a block
constexpr int kTile = 64;              // keys a staged tile; a split is whole tiles
constexpr int kStep = kTile / 2;       // keys a warp takes of each tile
constexpr int kStages = 2;
constexpr int kMergeThreads = 128;
// the most splits the paged kernel merges in a thread-block cluster (the
// portable cluster size); past it, the workspace and the merge kernel
constexpr int kClusterMax = 8;
// table entries a paged block stages in shared memory at once
constexpr int kTable = 1024;
// floats a cluster-merge inbox entry takes: acc [D], m, l, padded to whole
// float4s
template <int D>
constexpr int kEntry = D + 4;

template <int D>
struct Cfg {
  // K rows 16 words apart mod 32 (128-bit fragment loads of two rows);
  // V rows 4 words apart (scalar loads of four rows)
  static constexpr int kKStride = (D + 16) % 32 == 16 ? D + 16 : D + 32;
  static constexpr int kVStride = D + 4;
  static constexpr int kStage = kTile * (kKStride + kVStride);  // floats
  // Q's fragments: in registers, but at D = 128 their D / 2 registers (beside
  // the output's D / 2) push a thread past 255 and it spills, so there they
  // sit in shared memory after the ring, rows kKStride apart as K's
  static constexpr bool kQShared = D == 128;
  static constexpr int kQ = kQShared ? kGroup * kKStride : 0;  // floats
  static constexpr int kBytes = (kStages * kStage + kQ) * static_cast<int>(sizeof(float));
  // after the loop the ring's first stage holds the second halves' states
  // for the first halves to fold in: (m, l) of two rows and acc, a thread
  static constexpr int kState = 4 + D / 2;
  static_assert(kRowWarps * 32 * kState <= kStage, "the combine fits a stage");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// N bytes global -> shared (16: cached in L2 only)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(N));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi keeps the 10 mantissa bits a tf32 operand holds (by
// truncation: one AND), lo = x - hi is exact in fp32; what the tensor core
// drops of lo is below 2^-21 of |x|. Rounding hi to nearest instead
// (cvt.rna.tf32, or adding half a unit before the AND) makes those drops
// unbiased, but on an H100 it slowed the kernel more than it cut the error:
// the splits are much of the kernel's instruction issue.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a.b in fp32 accuracy: the small products first, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// keys [k0, k0 + kTile) of the slot's K and V into one stage of the ring;
// keys at or past `end` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(float* stage, const float* kb, long long k_pos,
                                          const float* vb, long long v_pos, int k0, int end) {
  using C = Cfg<D>;
  constexpr int kChunks = D / 4;  // 16-byte pieces of a row
  float* ks = stage;
  float* vs = stage + kTile * C::kKStride;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kWarps * 32) {
    const int r = e / kChunks, col = (e % kChunks) * 4;
    const int j = k0 + r;
    const bool in = j < end;
    cp_async16(ks + r * C::kKStride + col, kb + (in ? j * k_pos : 0) + col, in ? 16 : 0);
    cp_async16(vs + r * C::kVStride + col, vb + (in ? j * v_pos : 0) + col, in ? 16 : 0);
  }
}

// the keys of one (slot, head) of the fixed arena; `ok` false for a slot
// map entry outside the arena (its rows see no key). Tile t lands in stage
// t % kStages of the ring.
struct ArenaTiles {
  const float* kb;
  const float* vb;
  long long k_pos, v_pos;
  bool ok;
  static constexpr bool kDequant = false;
  static constexpr int kFpStages = kStages;  // K/V stages of the ring
  static constexpr int kInbox = 0;           // no cluster merge
  __device__ __forceinline__ void lookahead(int, int) {}
  template <int D, bool kFirst>
  __device__ __forceinline__ void load(float* ring, int tile, int k0, int end) {
    load_tile<D>(ring + (tile % kStages) * Cfg<D>::kStage, kb, k_pos, vb, v_pos, k0, end);
  }
  __device__ __forceinline__ void stage(int, int, int) {}
  template <int D>
  __device__ __forceinline__ void dequant(float*, int, int, int) const {}
};

// the stored type of a paged pool
enum KvDtype { kFp = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ float4 dequant4(int c0, int c1, int c2, int c3, float s) {
  return make_float4(static_cast<float>(c0) * s, static_cast<float>(c1) * s,
                     static_cast<float>(c2) * s, static_cast<float>(c3) * s);
}

// The keys of one (table row, head) of a paged pool [num_blocks + 1,
// block_size, heads, stored]: key j in block table[j / block_size] (the sink
// for the sentinel), row j % block_size. Copies run key-major: a thread
// copies piece threadIdx % kCopiesPerRow of the K and V rows of every
// kPerPass-th key of the tile, walking the pages without a division. fp rows
// land in the K/V stage; codes and scales in a code stage (a ring of
// kStages after the K/V ring and Q), dequantized into the K/V stage by
// dequant().
template <int D, int Q>
struct PagedTiles {
  using C = Cfg<D>;
  static constexpr bool kDequant = Q != kFp;
  static constexpr int kRowBytes = Q == kFp ? D * 4 : Q == kInt8 ? D : D / 2;  // a head row
  static constexpr int kCopy = kRowBytes < 16 ? kRowBytes : 16;  // bytes a cp.async
  static constexpr int kCopiesPerRow = kRowBytes / kCopy;
  static constexpr int kPerPass = kWarps * 32 / kCopiesPerRow;  // keys a pass of the block
  static constexpr int kPasses = kPerPass < kTile ? kTile / kPerPass : 1;
  // a code stage: K codes, V codes, then K and V scales of kTile keys
  static constexpr int kCodeStage = 2 * kTile * kRowBytes + 2 * kTile * 4;
  // K/V stages: fp rows land in them by cp.async, two for the overlap; codes
  // are dequantized into one, between two barriers a tile
  static constexpr int kFpStages = kDequant ? 1 : kStages;
  // bytes: the K/V stages and Q, the code stages, then the inbox of a merge
  // in the cluster: an entry (acc [D], m, l) per split and owned row, at
  // most owned_rows(splits) * splits <= kGroup + kClusterMax of them
  static constexpr int kCodes = (kFpStages * C::kStage + C::kQ) * 4;
  static constexpr int kInbox = kCodes + (kDequant ? kStages * kCodeStage : 0);
  static constexpr int kBytes = kInbox + (kGroup + kClusterMax) * kEntry<D> * 4;
  static_assert(kPasses * kPerPass >= kTile, "a tile is whole passes");

  const unsigned char* kp;  // the pool's (row 0, head h) row
  const unsigned char* vp;
  const float* ks;  // the scale planes at (row 0, head h)
  const float* vs;
  const int* table;  // the row's table
  int* s_table;      // its staged window: entries [win0, win0 + kTable)
  int block_size, num_blocks, heads;
  int step_pages, step_rows;  // kPerPass keys in whole pages and rows
  int win0;
  int ids[kPasses];  // the first tile's block ids, read ahead of the positions
  bool ok;

  // the thread's first key of the tile at k0: its table entry and row
  __device__ __forceinline__ void place(int k0, int& key, int& e, int& in_page) const {
    key = threadIdx.x / kCopiesPerRow;
    e = (k0 + key) / block_size;
    in_page = k0 + key - e * block_size;
  }
  __device__ __forceinline__ void advance(int& key, int& e, int& in_page) const {
    key += kPerPass;
    e += step_pages;
    in_page += step_rows;
    if (in_page >= block_size) {
      ++e;
      in_page -= block_size;
    }
  }

  // the block ids of the first tile's keys [k0, lim), before anything is
  // known of the positions (`lim`: the split's range within the span)
  __device__ __forceinline__ void lookahead(int k0, int lim) {
    step_pages = kPerPass / block_size;
    step_rows = kPerPass - step_pages * block_size;
    int key, e, in_page;
    place(k0, key, e, in_page);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      ids[p] = key < kTile && k0 + key < lim ? __ldg(table + e) : 0;
      advance(key, e, in_page);
    }
  }

  // entries [e0, e0 + kTable) of the block's range [.., end) into the window
  // (plain loads; a barrier publishes them)
  __device__ __forceinline__ void stage_table(int e0, int end) {
    const int last = (end - 1) / block_size;
    for (int i = threadIdx.x; i < kTable && e0 + i <= last; i += kWarps * 32)
      s_table[i] = __ldg(table + e0 + i);
    win0 = e0;
  }
  // the window of tiles 1.. (the loop's first barrier publishes it)
  __device__ __forceinline__ void stage(int begin, int end, int n_tiles) {
    if (n_tiles > 1) stage_table((begin + kTile) / block_size, end);
  }

  // tile `tile` (keys [k0, k0 + kTile), those at or past `end` not copied)
  // into its stages by cp.async, not committed; the first tile takes its ids
  // from lookahead, the others from the window, restaged (uniform over the
  // block) when the tile's last entry is past it
  template <int, bool kFirst>
  __device__ __forceinline__ void load(float* ring, int tile, int k0, int end) {
    if constexpr (!kFirst) {
      if ((min(k0 + kTile, end) - 1) / block_size >= win0 + kTable) {
        stage_table(k0 / block_size, end);
        __syncthreads();
      }
    }
    float* kd = ring + (tile % kFpStages) * C::kStage;
    float* vd = kd + kTile * C::kKStride;
    unsigned char* cs = reinterpret_cast<unsigned char*>(ring) + kCodes +
                        (tile % kStages) * kCodeStage;
    float* sc = reinterpret_cast<float*>(cs + 2 * kTile * kRowBytes);
    const int piece = threadIdx.x % kCopiesPerRow;
    int key, e, in_page;
    place(k0, key, e, in_page);
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (key < kTile) {
        const bool in = k0 + key < end;
        long long row = 0;
        if (in) {
          int id;
          if constexpr (kFirst) {
            id = ids[p];
          } else {
            id = s_table[e - win0];
          }
          row = static_cast<long long>(min(max(id, 0), num_blocks)) * block_size + in_page;
        }
        const long long at = row * heads * kRowBytes + piece * kCopy;
        if constexpr (Q == kFp) {
          cp_async16(kd + key * C::kKStride + piece * 4, kp + at, in ? 16 : 0);
          cp_async16(vd + key * C::kVStride + piece * 4, vp + at, in ? 16 : 0);
        } else if (in) {
          cp_async<kCopy>(cs + key * kRowBytes + piece * kCopy, kp + at);
          cp_async<kCopy>(cs + (kTile + key) * kRowBytes + piece * kCopy, vp + at);
          if (piece == 0) {
            cp_async<4>(sc + key, ks + row * heads);
            cp_async<4>(sc + kTile + key, vs + row * heads);
          }
        }
      }
      advance(key, e, in_page);
    }
  }
  // the codes of tile `tile` (landed) times their scales into its K/V stage,
  // zeros at or past `end`
  template <int>
  __device__ __forceinline__ void dequant(float* ring, int tile, int k0, int end) const {
    constexpr int kPieces = D / 4;  // 4 values a thread and step
    float* kd = ring + (tile % kFpStages) * C::kStage;
    float* vd = kd + kTile * C::kKStride;
    const unsigned char* cs = reinterpret_cast<const unsigned char*>(ring) + kCodes +
                              (tile % kStages) * kCodeStage;
    const float* sc = reinterpret_cast<const float*>(cs + 2 * kTile * kRowBytes);
    for (int i = threadIdx.x; i < kTile * kPieces; i += kWarps * 32) {
      const int r = i / kPieces, piece = i % kPieces;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < end) {
        const unsigned char* kr = cs + r * kRowBytes;
        const unsigned char* vr = cs + (kTile + r) * kRowBytes;
        if constexpr (Q == kInt8) {
          kx = unpack8(reinterpret_cast<const uint32_t*>(kr)[piece], sc[r]);
          vx = unpack8(reinterpret_cast<const uint32_t*>(vr)[piece], sc[kTile + r]);
        } else {
          kx = unpack4(reinterpret_cast<const uint16_t*>(kr)[piece], sc[r]);
          vx = unpack4(reinterpret_cast<const uint16_t*>(vr)[piece], sc[kTile + r]);
        }
      }
      *reinterpret_cast<float4*>(kd + r * C::kKStride + piece * 4) = kx;
      *reinterpret_cast<float4*>(vd + r * C::kVStride + piece * 4) = vx;
    }
  }

  // four int8 codes (byte i value i) times the scale
  __device__ __forceinline__ static float4 unpack8(uint32_t w, float s) {
    return dequant4(static_cast<int8_t>(w), static_cast<int8_t>(w >> 8),
                    static_cast<int8_t>(w >> 16), static_cast<int8_t>(w >> 24), s);
  }
  // two bytes of int4 nibbles (low nibble the even index), sign-extended by
  // shifts, times the scale
  __device__ __forceinline__ static float4 unpack4(uint32_t w, float s) {
    const int b0 = static_cast<int8_t>(w), b1 = static_cast<int8_t>(w >> 8);
    return dequant4(static_cast<int>(static_cast<uint32_t>(b0) << 28) >> 28, b0 >> 4,
                    static_cast<int>(static_cast<uint32_t>(b1) << 28) >> 28, b1 >> 4, s);
  }
};

// The warp's q fragments: qf[kc][r] holds columns kc*16 + 4t..+3 of row
// g + 8r in registers; with Cfg<D>::kQShared they are read from the warp's
// rows of the shared Q tile (Qw) instead, and qf is empty.
template <int D>
using QFrag = float4[Cfg<D>::kQShared ? 1 : D / 16][2];

template <int D>
__device__ __forceinline__ float4 q_frag(const QFrag<D>& qf, const float* Qw, int kc, int r,
                                         int g, int t) {
  if constexpr (Cfg<D>::kQShared) {
    return *reinterpret_cast<const float4*>(Qw + (g + 8 * r) * Cfg<D>::kKStride + kc * 16 +
                                            4 * t);
  } else {
    return qf[kc][r];
  }
}

// s[n] (keys 8n.. of the step, C fragments) = q.k^T for the warp's 16 rows.
// In each 16-column chunk the first k-step's index t and t + 4 are columns
// 4t and 4t + 1, the second's 4t + 2 and 4t + 3.
template <int D, int NS>
__device__ __forceinline__ void scores(float (&s)[NS][4], const QFrag<D>& qf, const float* Qw,
                                       const float* Ks, int g, int t) {
  constexpr int kStride = Cfg<D>::kKStride;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const float4 qa = q_frag<D>(qf, Qw, kc, 0, g, t), qb = q_frag<D>(qf, Qw, kc, 1, g, t);
    uint32_t a_hi[2][4], a_lo[2][4];
    split_tf32(qa.x, a_hi[0][0], a_lo[0][0]);
    split_tf32(qb.x, a_hi[0][1], a_lo[0][1]);
    split_tf32(qa.y, a_hi[0][2], a_lo[0][2]);
    split_tf32(qb.y, a_hi[0][3], a_lo[0][3]);
    split_tf32(qa.z, a_hi[1][0], a_lo[1][0]);
    split_tf32(qb.z, a_hi[1][1], a_lo[1][1]);
    split_tf32(qa.w, a_hi[1][2], a_lo[1][2]);
    split_tf32(qb.w, a_hi[1][3], a_lo[1][3]);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float4 kb =
          *reinterpret_cast<const float4*>(Ks + (n * 8 + g) * kStride + kc * 16 + 4 * t);
      uint32_t b_hi[2][2], b_lo[2][2];
      split_tf32(kb.x, b_hi[0][0], b_lo[0][0]);
      split_tf32(kb.y, b_hi[0][1], b_lo[0][1]);
      split_tf32(kb.z, b_hi[1][0], b_lo[1][0]);
      split_tf32(kb.w, b_hi[1][1], b_lo[1][1]);
      mma_3xtf32(s[n], a_hi[0], a_lo[0], b_hi[0], b_lo[0]);
      mma_3xtf32(s[n], a_hi[1], a_lo[1], b_hi[1], b_lo[1]);
    }
  }
}

// acc[n] (columns 8n..) += p.v. With the k index permuted (index t is key
// 2t, t + 4 is key 2t + 1) the C fragment of score tile j is the A fragment
// of keys 8j..8j+7.
template <int D, int NS>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4], const float (&p)[NS][4],
                                   const float* Vs, int g, int t) {
  constexpr int kStride = Cfg<D>::kVStride;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(p[j][0], a_hi[0], a_lo[0]);
    split_tf32(p[j][2], a_hi[1], a_lo[1]);
    split_tf32(p[j][1], a_hi[2], a_lo[2]);
    split_tf32(p[j][3], a_hi[3], a_lo[3]);
    const float* v0 = Vs + (j * 8 + 2 * t) * kStride + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t b_hi[2], b_lo[2];
      split_tf32(v0[n * 8], b_hi[0], b_lo[0]);
      split_tf32(v0[kStride + n * 8], b_hi[1], b_lo[1]);
      mma_3xtf32(acc[n], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// the blocks of this block's cluster (1 without a cluster launch)
__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}
// the cluster barrier in two halves: arrive (relaxed: orders nothing, or
// release: this thread's writes, the remote ones too, before the others
// pass) and wait (acquire); every thread of the cluster takes part
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rows of a group each block of a cluster of `splits` merges
__device__ __forceinline__ int owned_rows(int splits) { return (kGroup + splits - 1) / splits; }

// The rows this block owns, merged from the partials the `splits` live
// splits of the cluster stored into its inbox (entry (split, owned row): acc
// [D], m, l, kEntry<D> floats apart) with span_chunk_merge_kernel's
// arithmetic, in split order (a split that saw no key would add nothing):
// first one thread a row computes the row's weights exp2(m_s - max) (-1 for
// a split that saw none of the row's keys and stored no acc) and 1 / l into
// `weights`, then each piece of a row takes them from there.
template <int D>
__device__ __forceinline__ void merge_inbox(const float* inbox, float* weights,
                                            float* __restrict__ out, long long bh, int rows_c,
                                            int grp, int splits, int rank) {
  constexpr int kPieces = D / 4;
  constexpr int kW = kClusterMax + 1;  // a row's weights, then 1 / l
  const int own = owned_rows(splits);
  const int first = grp * kGroup + rank * own;  // the block's first owned row (chunk index)
  const int rows = min(own, min(kGroup, rows_c - grp * kGroup) - rank * own);
  // (the split loops unroll to kClusterMax, so each pass's loads go out
  // together)
  for (int r = threadIdx.x; r < rows; r += kWarps * 32) {
    float ms[kClusterMax], ls[kClusterMax];
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s) {
      if (s < splits) {
        const float* e = inbox + (s * own + r) * kEntry<D>;
        ms[s] = e[D];
        ls[s] = e[D + 1];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s)
      if (s < splits && ls[s] > 0.f) mx = fmaxf(mx, ms[s]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s) {
      if (s < splits) {
        float w = -1.f;
        if (ls[s] > 0.f) {
          w = exp2f(ms[s] - mx);
          l = fmaf(ls[s], w, l);
        }
        weights[r * kW + s] = w;
      }
    }
    weights[r * kW + kClusterMax] = l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * kPieces; i += kWarps * 32) {
    const int r = i / kPieces, piece = i % kPieces;
    float ws[kClusterMax];
    float4 as[kClusterMax];
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s) {
      if (s < splits) {
        ws[s] = weights[r * kW + s];
        as[s] = reinterpret_cast<const float4*>(inbox + (s * own + r) * kEntry<D>)[piece];
      }
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kClusterMax; ++s) {
      if (s < splits && ws[s] >= 0.f) {  // as[s] is unused where the split stored no acc
        const float w = ws[s];
        const float4 a = as[s];
        acc = make_float4(fmaf(a.x, w, acc.x), fmaf(a.y, w, acc.y), fmaf(a.z, w, acc.z),
                          fmaf(a.w, w, acc.w));
      }
    }
    const float inv = weights[r * kW + kClusterMax];
    reinterpret_cast<float4*>(out + (bh * rows_c + first + r) * D)[piece] =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
}

// One split kernel's block, (slot x group, head, split) = blockIdx, over the
// keys `src` loads (ArenaTiles or PagedTiles, bound to the block's slot and
// head)
template <int D, class Src>
__device__ __forceinline__ void chunk_block(const float* __restrict__ q, Src& src,
                                            const int* __restrict__ pos,
                                            float* __restrict__ out,
                                            float* __restrict__ part_acc,
                                            float* __restrict__ part_ml, int rows_c,
                                            int groups, int span, int chunk, float q_scale) {
  using C = Cfg<D>;
  constexpr int NS = kStep / 8;  // score n-tiles of a step
  constexpr int DT = D / 8;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);

  const int b = blockIdx.x / groups;
  const int grp = groups - 1 - static_cast<int>(blockIdx.x % groups);  // deeper groups first
  const int h = blockIdx.y, split = blockIdx.z;
  const int heads = gridDim.y, splits = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warp w holds rows slice w % kRowWarps and takes keys half w / kRowWarps
  // of every tile
  const int slice = warp % kRowWarps, half = warp / kRowWarps;
  // a thread holds rows g and g + 8 of its warp's 16, and columns 2t and
  // 2t + 1 of every n-tile
  const int g = lane >> 2, t = lane & 3;
  const long long bh = static_cast<long long>(b) * heads + h;
  const int begin = split * chunk;
  // with 2 to kClusterMax splits launched as one cluster a (group, head),
  // the partials merge in the cluster
  const bool in_cluster = splits > 1 && cluster_blocks() == static_cast<unsigned>(splits);

  // each row's visible keys (0 for none, clamped to the span); over the
  // warp's live rows the deepest and the shallowest; and, one row a lane,
  // the deepest over the group's rows, in every warp (no barrier). The
  // first tile's block ids are read alongside.
  const int* prow = pos + static_cast<long long>(b) * rows_c;
  const auto visible = [&](int c) {
    const int p = src.ok ? prow[c] : -1;
    return p < 0 ? 0 : min(p, span - 1) + 1;
  };
  const int r0 = grp * kGroup + slice * 16;
  int n_vis[2], deep = 0, shallow = INT_MAX, group_deep = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = r0 + g + 8 * r;
    int n = 0;
    if (c < rows_c) {
      n = visible(c);
      shallow = min(shallow, n);
    }
    n_vis[r] = n;
    deep = max(deep, n);
    const int cg_row = grp * kGroup + lane + 32 * r;
    if (cg_row < rows_c) group_deep = max(group_deep, visible(cg_row));
  }
  src.lookahead(begin, min(begin + chunk, span));
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {  // lanes of one t hold the warp's 16 rows
    deep = max(deep, __shfl_xor_sync(0xffffffffu, deep, o));
    shallow = min(shallow, __shfl_xor_sync(0xffffffffu, shallow, o));
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    group_deep = max(group_deep, __shfl_xor_sync(0xffffffffu, group_deep, o));
  const int end = min(begin + chunk, group_deep);  // the block reads keys [begin, end)
  const int n_tiles = end > begin ? (end - begin + kTile - 1) / kTile : 0;
  // In a cluster, the splits that see a key of the group (at least split
  // 0) are live; the others leave now, before their first cluster barrier,
  // which waits only for the threads that have not exited: their SMs take
  // the next clusters, and they own no rows. One live split writes the
  // output itself (the merge of one partial is exact: exp2(0) = 1, + 0);
  // with more, a live split arrives now and waits before its first store
  // into another block, so that every live block has started.
  int live = splits;
  if (in_cluster) {
    live = max(1, min(splits, (group_deep + chunk - 1) / chunk));
    if (split >= live) return;
  }
  const bool merge_in_cluster = in_cluster && live > 1;
  if (merge_in_cluster) cluster_arrive_relaxed();

  // q fragments, scaled for the exp2 softmax; rows past C are zeros. In
  // shared memory the first half's warp writes its slice's rows, and the
  // loop's first barrier publishes them to the second's.
  QFrag<D> qf;
  float* Qw = ring + Src::kFpStages * C::kStage + slice * 16 * C::kKStride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = r0 + g + 8 * r;
    const float4* qr = reinterpret_cast<const float4*>(q + (bh * rows_c + c) * D + 4 * t);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < rows_c) {
        x = __ldg(qr + kc * 4);
        x = make_float4(x.x * q_scale, x.y * q_scale, x.z * q_scale, x.w * q_scale);
      }
      if constexpr (C::kQShared) {
        if (half == 0)
          *reinterpret_cast<float4*>(Qw + (g + 8 * r) * C::kKStride + kc * 16 + 4 * t) = x;
      } else {
        qf[kc][r] = x;
      }
    }
  }
  src.stage(begin, end, n_tiles);
  // the first tile's copies (issuing them ahead of Q's fetch was slower)
  if (n_tiles > 0) src.template load<D, true>(ring, 0, begin, end);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();  // tile i landed ...
    __syncthreads();      // ... for every thread; tile i - 1's stages are free
    if (i + 1 < n_tiles) src.template load<D, false>(ring, i + 1, begin + (i + 1) * kTile, end);
    cp_async_commit();
    if constexpr (Src::kDequant) {
      src.template dequant<D>(ring, i, begin + i * kTile, end);  // under tile i + 1's copies
      __syncthreads();
    }

    const int k0 = begin + i * kTile + half * kStep;
    if (k0 >= deep) continue;  // no row of the warp sees these keys (warp-uniform)
    const float* Ks = ring + (i % Src::kFpStages) * C::kStage + half * kStep * C::kKStride;
    const float* Vs = ring + (i % Src::kFpStages) * C::kStage + kTile * C::kKStride +
                      half * kStep * C::kVStride;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    scores<D, NS>(s, qf, Qw, Ks, g, t);

    // mask only a step that crosses a live row's visible count
    const bool edge = k0 + kStep > shallow;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (edge && k0 + n * 8 + 2 * t + (e & 1) >= n_vis[e >> 1]) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
    bool dead[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      // a row masked so far keeps p = 0, so l stays 0 and it outputs zeros
      dead[r] = m_new[r] <= 0.5f * kNegInf;
      alpha[r] = exp2f(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = dead[r] ? 0.f : exp2f(s[n][e] - m_new[r]);
        s[n][e] = p;
        row_sum[r] += p;
      }
    // l is this thread's share of the row sum; the quad adds them at the end
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_sum[r];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    pv<D, NS>(acc, s, Vs, g, t);
  }
  cp_async_wait_all();  // no copy outlives the block
  __syncthreads();      // every warp is done with the ring

  // the second half's state folds into the first's, thread by thread (the
  // two hold the same fragment positions), through the ring
  float* state = ring + (slice * 32 + lane) * C::kState;
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      state[r] = m[r];
      state[2 + r] = l[r];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) state[4 + 4 * n + e] = acc[n][e];
  }
  __syncthreads();
  if (merge_in_cluster) cluster_wait();
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = state[r];
      const float mt = fmaxf(m[r], m1);
      const float a0 = exp2f(m[r] - mt), a1 = exp2f(m1 - mt);
      l[r] = l[r] * a0 + state[2 + r] * a1;
      m[r] = mt;
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          acc[n][e] = acc[n][e] * a0 + state[4 + 4 * n + e] * a1;
    }

    // each row's result: the output itself with one split (a visible key
    // makes l >= 1), else the partial: stored into the inbox of the
    // cluster's block that owns the row, or into the workspace for the
    // merge kernel
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int c = r0 + g + 8 * r;
      if (c >= rows_c) continue;
      float* prow_acc;
      float* prow_ml;
      if (live == 1) {  // one split, or one live split of a cluster
        const float inv = sum > 0.f ? 1.f / sum : 0.f;
        float* orow = out + (bh * rows_c + c) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < DT; ++n)
          *reinterpret_cast<float2*>(orow + n * 8) =
              make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
        continue;
      } else if (merge_in_cluster) {
        const int row = slice * 16 + g + 8 * r, own = owned_rows(live);  // in the group
        float* inbox = reinterpret_cast<float*>(smem_raw + Src::kInbox);
        prow_acc = cg::this_cluster().map_shared_rank(inbox, row / own) +
                   (split * own + row % own) * kEntry<D>;
        prow_ml = prow_acc + D;
      } else {
        const long long part = (bh * splits + split) * rows_c + c;
        prow_acc = part_acc + part * D;
        prow_ml = part_ml + 2 * part;
      }
      if (sum > 0.f) {  // an empty partial stores no acc; the merge skips it
#pragma unroll
        for (int n = 0; n < DT; ++n)
          *reinterpret_cast<float2*>(prow_acc + n * 8 + 2 * t) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
      if (t == 0) {
        prow_ml[0] = sum > 0.f ? m[r] : kNegInf;
        prow_ml[1] = sum;
      }
    }
  }
  if (merge_in_cluster) {
    cluster_arrive();  // every partial stored, in every block's inbox ...
    cluster_wait();    // ... before any block merges its rows
    // the ring is free: its start takes the rows' weights
    merge_inbox<D>(reinterpret_cast<const float*>(smem_raw + Src::kInbox), ring, out, bh, rows_c,
                   grp, live, split);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32, 1)
span_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ pos,
                  const long long* __restrict__ slot_map, float* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml, int rows_c,
                  int groups, int span, int chunk, int num_slots, long long k_slot,
                  long long k_pos, long long k_head, long long v_slot, long long v_pos,
                  long long v_head, float q_scale) {
  const int b = blockIdx.x / groups, h = blockIdx.y;
  long long slot = slot_map == nullptr ? b : slot_map[b];
  const bool slot_ok = slot >= 0 && slot < num_slots;
  if (!slot_ok) slot = 0;
  ArenaTiles src{k + slot * k_slot + h * k_head, v + slot * v_slot + h * v_head, k_pos, v_pos,
                 slot_ok};
  chunk_block<D>(q, src, pos, out, part_acc, part_ml, rows_c, groups, span, chunk, q_scale);
}

// the paged pool [num_blocks + 1, block_size, heads, stored] (fp32, or int8
// codes), the scale planes [num_blocks + 1, block_size, heads] (quantized
// only), tables [batch, table_len]: row b of q reads table row b; dynamic
// shared memory PagedTiles<D, Q>::kBytes
template <int D, int Q>
__global__ void __launch_bounds__(kWarps * 32, 1)
paged_span_chunk_kernel(const float* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ tables,
                        const int* __restrict__ pos, float* __restrict__ out,
                        float* __restrict__ part_acc, float* __restrict__ part_ml, int rows_c,
                        int groups, int table_len, int block_size, int num_blocks, int chunk,
                        float q_scale) {
  using Src = PagedTiles<D, Q>;
  __shared__ int s_table[kTable];
  const int b = blockIdx.x / groups, h = blockIdx.y, heads = gridDim.y;
  Src src;
  src.kp = static_cast<const unsigned char*>(k) + h * Src::kRowBytes;
  src.vp = static_cast<const unsigned char*>(v) + h * Src::kRowBytes;
  src.ks = k_scale == nullptr ? nullptr : k_scale + h;
  src.vs = v_scale == nullptr ? nullptr : v_scale + h;
  src.table = tables + static_cast<long long>(b) * table_len;
  src.s_table = s_table;
  src.block_size = block_size;
  src.num_blocks = num_blocks;
  src.heads = heads;
  src.win0 = 0;
  src.ok = true;
  chunk_block<D>(q, src, pos, out, part_acc, part_ml, rows_c, groups, table_len * block_size,
                 chunk, q_scale);
}

// out[bh, c] <- the lse merge of the row's `splits` partials, in split
// order (m in log2 units); D / 4 lanes a row
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
span_chunk_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                        float* __restrict__ out, long long rows, int rows_c, int splits) {
  constexpr int kLanesPerRow = D / 4;
  constexpr int kRowsPerBlock = kMergeThreads / kLanesPerRow;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int piece = threadIdx.x % kLanesPerRow;
  if (row >= rows) return;
  const long long bh = row / rows_c, c = row % rows_c;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) {
    const long long part = (bh * splits + s) * rows_c + c;
    if (part_ml[2 * part + 1] > 0.f) mx = fmaxf(mx, part_ml[2 * part]);
  }
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const long long part = (bh * splits + s) * rows_c + c;
    const float ls = part_ml[2 * part + 1];
    if (ls > 0.f) {  // an empty split wrote no acc
      const float e = exp2f(part_ml[2 * part] - mx);
      const float4 a = reinterpret_cast<const float4*>(part_acc + part * D)[piece];
      l = fmaf(ls, e, l);
      acc = make_float4(fmaf(a.x, e, acc.x), fmaf(a.y, e, acc.y), fmaf(a.z, e, acc.z),
                        fmaf(a.w, e, acc.w));
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  reinterpret_cast<float4*>(out + row * D)[piece] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const int* pos,
                   const long long* slot_map, float* out, float* workspace, int batch,
                   int heads, int rows_c, int span, int splits, int chunk, int num_slots,
                   long long k_slot, long long k_pos, long long k_head, long long v_slot,
                   long long v_pos, long long v_head, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * heads * rows_c;
  const int groups = (rows_c + kGroup - 1) / kGroup;
  // the workspace: acc [B·H, splits, C, D], then (m, l) [B·H, splits, C, 2]
  float* part_acc = workspace;
  float* part_ml = workspace == nullptr ? nullptr : workspace + rows * splits * D;
  // the shared-memory limit is a property of the kernel on each device
  static unsigned attribute_set = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 32 || !(attribute_set >> device & 1u)) {
    err = cudaFuncSetAttribute(span_chunk_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kBytes);
    if (err != cudaSuccess) return err;
    if (device < 32) attribute_set |= 1u << device;
  }
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(batch) * groups),
                  static_cast<unsigned>(heads), static_cast<unsigned>(splits));
  span_chunk_kernel<D><<<grid, kWarps * 32, Cfg<D>::kBytes, stream>>>(
      q, k, v, pos, slot_map, out, part_acc, part_ml, rows_c, groups, span, chunk, num_slots,
      k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  constexpr int kRowsPerBlock = kMergeThreads / (D / 4);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  span_chunk_merge_kernel<D><<<blocks, kMergeThreads, 0, stream>>>(part_acc, part_ml, out,
                                                                   rows, rows_c, splits);
  return cudaGetLastError();
}

// merge-kernel launches of the paged chunk since the library loaded (past
// kClusterMax splits only)
unsigned long long paged_merges = 0;

template <int D, int Q>
cudaError_t launch_paged(const float* q, const void* k, const void* v, const float* k_scale,
                         const float* v_scale, const int* tables, const int* pos, float* out,
                         float* workspace, int batch, int heads, int rows_c, int table_len,
                         int block_size, int num_blocks, int splits, int chunk, float scale,
                         cudaStream_t stream) {
  constexpr int kBytes = PagedTiles<D, Q>::kBytes;
  const long long rows = static_cast<long long>(batch) * heads * rows_c;
  const int groups = (rows_c + kGroup - 1) / kGroup;
  float* part_acc = workspace;
  float* part_ml = workspace == nullptr ? nullptr : workspace + rows * splits * D;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(batch) * groups),
                  static_cast<unsigned>(heads), static_cast<unsigned>(splits));
  const float q_scale = scale * kLog2e;
  if (splits > 1 && splits <= kClusterMax) {
    // the splits of one (group, head) in a cluster, which merges them
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kWarps * 32);
    config.dynamicSmemBytes = kBytes;
    config.stream = stream;
    cudaLaunchAttribute attribute;
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = 1;
    attribute.val.clusterDim.y = 1;
    attribute.val.clusterDim.z = static_cast<unsigned>(splits);
    config.attrs = &attribute;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &config, paged_span_chunk_kernel<D, Q>, q, k, v, k_scale, v_scale, tables, pos, out,
        static_cast<float*>(nullptr), static_cast<float*>(nullptr), rows_c, groups, table_len,
        block_size, num_blocks, chunk, q_scale);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
  paged_span_chunk_kernel<D, Q><<<grid, kWarps * 32, kBytes, stream>>>(
      q, k, v, k_scale, v_scale, tables, pos, out, part_acc, part_ml, rows_c, groups, table_len,
      block_size, num_blocks, chunk, q_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  constexpr int kRowsPerBlock = kMergeThreads / (D / 4);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  span_chunk_merge_kernel<D><<<blocks, kMergeThreads, 0, stream>>>(part_acc, part_ml, out,
                                                                   rows, rows_c, splits);
  ++paged_merges;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_paged_dtype(int kv_dtype, const float* q, const void* k, const void* v,
                               const float* k_scale, const float* v_scale, const int* tables,
                               const int* pos, float* out, float* workspace, int batch,
                               int heads, int rows_c, int table_len, int block_size,
                               int num_blocks, int splits, int chunk, float scale,
                               cudaStream_t stream) {
  switch (kv_dtype) {
    case kFp:
      return launch_paged<D, kFp>(q, k, v, k_scale, v_scale, tables, pos, out, workspace,
                                  batch, heads, rows_c, table_len, block_size, num_blocks,
                                  splits, chunk, scale, stream);
    case kInt8:
      return launch_paged<D, kInt8>(q, k, v, k_scale, v_scale, tables, pos, out, workspace,
                                    batch, heads, rows_c, table_len, block_size, num_blocks,
                                    splits, chunk, scale, stream);
    case kInt4:
      return launch_paged<D, kInt4>(q, k, v, k_scale, v_scale, tables, pos, out, workspace,
                                    batch, heads, rows_c, table_len, block_size, num_blocks,
                                    splits, chunk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// every stored type's paged kernel at head dim D may take its stages'
// dynamic shared memory (over the default 48 KB) on the current device
template <int D, int Q>
cudaError_t allow_paged_stages() {
  return cudaFuncSetAttribute(paged_span_chunk_kernel<D, Q>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              PagedTiles<D, Q>::kBytes);
}

template <int D>
cudaError_t allow_paged_stages_all() {
  cudaError_t err = allow_paged_stages<D, kFp>();
  if (err == cudaSuccess) err = allow_paged_stages<D, kInt8>();
  if (err == cudaSuccess) err = allow_paged_stages<D, kInt4>();
  return err;
}

}  // namespace

// q, out: [batch, heads, rows_c, head_dim] float32, contiguous; k, v:
// [num_slots, span, heads, head_dim] float32 views with element strides
// (slot, pos, head) and unit stride on head_dim, every stride a multiple of
// 4 and every base pointer 16-byte aligned; pos: [batch, rows_c] int32 on
// the device; slot_map: [batch] int64 arena slots of q's rows, or null for
// row b = slot b (then batch <= num_slots). splits blocks of chunk key
// positions each cover the span (splits * chunk >= span), chunk a multiple
// of 64 (whole tiles); with splits > 1, workspace holds batch * heads *
// splits * rows_c * (head_dim + 2) floats, 16-byte aligned, else it may be
// null. Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int elephas_span_chunk(const void* q, const void* k, const void* v, const void* pos,
                                  const void* slot_map, void* out, void* workspace, int batch,
                                  int heads, int rows_c, int head_dim, int span, int splits,
                                  int chunk, int num_slots, long long k_slot, long long k_pos,
                                  long long k_head, long long v_slot, long long v_pos,
                                  long long v_head, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || rows_c < 1 || span < 1 ||
      splits < 1 || splits > 65535 || chunk < 1 || chunk % kTile != 0 || num_slots < 1 ||
      static_cast<long long>(splits) * chunk < span ||
      (slot_map == nullptr && batch > num_slots) || (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* pf = static_cast<const int*>(pos);
  const auto* sm = static_cast<const long long*>(slot_map);
  auto* of = static_cast<float*>(out);
  auto* ws = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                        num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 32:
      return launch<32>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                        num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 64:
      return launch<64>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                        num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    case 128:
      return launch<128>(qf, kf, vf, pf, sm, of, ws, batch, heads, rows_c, span, splits, chunk,
                         num_slots, k_slot, k_pos, k_head, v_slot, v_pos, v_head, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// q, out: [batch, heads, rows_c, head_dim] float32, contiguous; k, v: the
// paged pool [num_blocks + 1, block_size, heads, stored] contiguous, float32
// for kv_dtype 0 (fp), int8 codes for 1 (int8, stored = head_dim) and 2
// (int4 packed two a byte, stored = head_dim / 2), 16-byte aligned; k_scale,
// v_scale: [num_blocks + 1, block_size, heads] float32 contiguous (null for
// fp); tables: [batch, table_len] int32 contiguous, ids in [0, num_blocks]
// (num_blocks the sentinel, read as the sink block); pos: [batch, rows_c]
// int32. The span is table_len * block_size; splits and chunk as for
// elephas_span_chunk. Splits 2 to 8 are merged in a thread-block cluster and
// take no workspace (it may be null); past 8, workspace holds batch * heads *
// splits * rows_c * (head_dim + 2) floats, 16-byte aligned, and a merge
// kernel follows. elephas_paged_span_chunk_init must have run on the device.
extern "C" int elephas_paged_span_chunk(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* tables, const void* pos, void* out,
                                        void* workspace, int batch, int heads, int rows_c,
                                        int head_dim, int kv_dtype, int block_size,
                                        int table_len, int num_blocks, int splits, int chunk,
                                        float scale, void* stream) {
  const long long span = static_cast<long long>(table_len) * block_size;
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || rows_c < 1 ||
      block_size < 1 || table_len < 1 || span > INT_MAX || num_blocks < 1 || splits < 1 ||
      splits > 65535 || chunk < 1 || chunk % kTile != 0 ||
      static_cast<long long>(splits) * chunk < span ||
      (splits > kClusterMax && workspace == nullptr) || kv_dtype < kFp || kv_dtype > kInt4 ||
      (kv_dtype != kFp && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* ksc = static_cast<const float*>(k_scale);
  const auto* vsc = static_cast<const float*>(v_scale);
  const auto* tab = static_cast<const int*>(tables);
  const auto* pf = static_cast<const int*>(pos);
  auto* of = static_cast<float*>(out);
  auto* ws = static_cast<float*>(workspace);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_paged_dtype<16>(kv_dtype, qf, k, v, ksc, vsc, tab, pf, of, ws, batch, heads,
                                    rows_c, table_len, block_size, num_blocks, splits, chunk,
                                    scale, st);
    case 32:
      return launch_paged_dtype<32>(kv_dtype, qf, k, v, ksc, vsc, tab, pf, of, ws, batch, heads,
                                    rows_c, table_len, block_size, num_blocks, splits, chunk,
                                    scale, st);
    case 64:
      return launch_paged_dtype<64>(kv_dtype, qf, k, v, ksc, vsc, tab, pf, of, ws, batch, heads,
                                    rows_c, table_len, block_size, num_blocks, splits, chunk,
                                    scale, st);
    case 128:
      return launch_paged_dtype<128>(kv_dtype, qf, k, v, ksc, vsc, tab, pf, of, ws, batch,
                                     heads, rows_c, table_len, block_size, num_blocks, splits,
                                     chunk, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Lets every paged chunk instantiation take its stages' shared memory on the
// current device. Call once a device before the first
// elephas_paged_span_chunk there, outside any CUDA-graph capture; a launch
// without it fails.
extern "C" int elephas_paged_span_chunk_init() {
  cudaError_t err = allow_paged_stages_all<16>();
  if (err == cudaSuccess) err = allow_paged_stages_all<32>();
  if (err == cudaSuccess) err = allow_paged_stages_all<64>();
  if (err == cudaSuccess) err = allow_paged_stages_all<128>();
  return err;
}

// merge-kernel launches elephas_paged_span_chunk has made (only past 8
// splits)
extern "C" unsigned long long elephas_paged_span_chunk_merge_launches() { return paged_merges; }

extern "C" const char* elephas_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Packet-step experiment bodies: the per-lane and per-packet steps of the
// three kernels of packet_step.cu.  Shared by the CUDA kernels and a host
// build (packet_step_host.cpp) that the CPU tests compile with g++: under
// nvcc the functions are __device__, under g++ plain inline (SHIMMER_HD of
// traverse_body.cuh, whose slab test, watertight triangle test and stack
// helpers they reuse).
//
// They compute what the reference's packet-step experiments compute
// (experiments/exp_scaling.py, exp_packet_step.py, exp_packet_step2.py,
// exp_fetch_honest.py, exp_loop_overhead.py, exp_step_attrib.py,
// exp_ablate_step.py), in the same float32 operation order, so that with
// no FMA contraction (nvcc -fmad=false, g++ -ffp-contract=off) the kernels,
// this host build and the plain torch versions (ops/packet_step.py) agree
// bit for bit.
//
// A packet is kLanes = 128 rays, one per thread; everything that depends
// only on the step (the node index r, the stack, meta words) is uniform
// across a packet and every thread computes it.
#pragma once

#include <string.h>

#include "traverse_body.cuh"

// Functions the launching host code calls too (the split chase's grid).
#if defined(__CUDACC__)
#define SHIMMER_HOST_HD __host__ __device__ __forceinline__
#else
#define SHIMMER_HOST_HD inline
#endif

namespace shimmer {
namespace packet {

constexpr int kLanes = 128;      // P: rays of a packet
constexpr int kWarp = 32;
constexpr int kPacketWarps = kLanes / kWarp;
constexpr int kNodeWidth = 128;  // floats (or packed words) of a table row
constexpr int kBoxFloats = 48;   // [lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]

// ---------------------------------------------------------------------------
// Kernel A, packet_slab_chase (kernel-table rows 10-14): one packet, a
// chain of `steps` visits from row 0; at each visit the packet slab-tests
// node r's 8 boxes, adds each lane's hit count to acc, and moves to
// r = nxt[r].  The bodies:
enum : int {
  kBodySlab = 0,        // rows 10, 12, 13 (A-D), k6 of row 14
  kBodySlabStack = 1,   // row 11: the same, plus stack[i % 64] = r
  kBodyEmpty = 2,       // row 13 "empty": the chase alone, acc stays 0
  kBodySlabFixed = 3,   // k5: r = (i * 37) % R, no chase
  kBodyIntSum = 4,      // k1: s += i, out = float(s)
  kBodyChase = 5,       // k2: the chase alone, out = float(r)
  kBodyAcc = 6,         // k3: acc += rays[0]
  kBodyAccScaled = 7,   // k4: acc += rays[0] * float(i)
  kNumBodies = 8,
};
constexpr int kSideStack = 64;   // row 11's stack of visited rows
constexpr int kFixedStride = 37;

// The next row of a chase: nxt[r], clamped into the table (the reference
// reads nxt unchecked; the clamp keeps a bad table inside memory and is
// the identity on every valid one).
SHIMMER_HD int chase_next(const int* nxt, int r, int n_rows) {
  return clamp_row(SHIMMER_LDG(nxt + r), n_rows);
}

// Element e (< kBoxFloats) of node r's boxes, from the row table (R, 128)
// or the transposed table (128, R), where element e of node r sits at
// e * R + r.
template <bool kTransposed>
SHIMMER_HD float box_element(const float* table, int n_rows, int r, int e) {
  return kTransposed ? SHIMMER_LDG(table + (size_t)e * n_rows + r)
                     : SHIMMER_LDG(table + (size_t)r * kNodeWidth + e);
}

// One lane's hits against the node's 8 boxes: (tn <= tf) & (tf > 0), with
// the reference's `slab` (exp_scaling.py:17-29) on a ray (o, i), i given.
SHIMMER_HD int slab_hit_count(const float v[kBoxFloats], float ox, float oy,
                              float oz, float ix, float iy, float iz) {
  int hits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float t0x = (v[k] - ox) * ix;
    const float t1x = (v[24 + k] - ox) * ix;
    const float t0y = (v[8 + k] - oy) * iy;
    const float t1y = (v[32 + k] - oy) * iy;
    const float t0z = (v[16 + k] - oz) * iz;
    const float t1z = (v[40 + k] - oz) * iz;
    const float tn =
        fmax_(fmax_(fmin_(t0x, t1x), fmin_(t0y, t1y)), fmin_(t0z, t1z));
    const float tf =
        fmin_(fmin_(fmax_(t0x, t1x), fmax_(t0y, t1y)), fmax_(t0z, t1z));
    hits += (tn <= tf && tf > 0.0f) ? 1 : 0;
  }
  return hits;
}

SHIMMER_HD float slab_hits(const float v[kBoxFloats], float ox, float oy,
                           float oz, float ix, float iy, float iz) {
  return static_cast<float>(slab_hit_count(v, ox, oy, oz, ix, iy, iz));
}

// One lane of kernel A, every body step by step: rays is the packet's (8,
// kLanes) block (o in rows 0-2, the inverse direction in rows 3-5).
// `side_stack` (kSideStack ints) receives row 11's stores and the empty
// body's last row.  On the card only int_sum, acc and acc_scaled run this
// loop; the slab and chain bodies run split (below), and the host build
// keeps their per-lane form as what the split form must equal.
template <int kBody, bool kTransposed>
SHIMMER_HD float slab_chase_lane(const float* table, int n_rows,
                                 const int* nxt, const float* rays, int lane,
                                 int steps, volatile int* side_stack) {
  const float ox = SHIMMER_LDG(rays + 0 * kLanes + lane);
  const float oy = SHIMMER_LDG(rays + 1 * kLanes + lane);
  const float oz = SHIMMER_LDG(rays + 2 * kLanes + lane);
  const float ix = SHIMMER_LDG(rays + 3 * kLanes + lane);
  const float iy = SHIMMER_LDG(rays + 4 * kLanes + lane);
  const float iz = SHIMMER_LDG(rays + 5 * kLanes + lane);
  float acc = 0.0f;
  unsigned sum = 0u;  // k1's int32 sum, wrapping as the reference's does
  int r = 0;
  for (int i = 0; i < steps; ++i) {
    if (kBody == kBodyIntSum) {
      sum += static_cast<unsigned>(i);
    } else if (kBody == kBodyAcc) {
      acc = acc + ox;
    } else if (kBody == kBodyAccScaled) {
      acc = acc + ox * static_cast<float>(i);
    } else if (kBody == kBodyEmpty || kBody == kBodyChase) {
      r = chase_next(nxt, r, n_rows);
    } else {
      if (kBody == kBodySlabFixed) {
        r = static_cast<int>(static_cast<long long>(i) * kFixedStride % n_rows);
      }
      float v[kBoxFloats];
      for (int e = 0; e < kBoxFloats; ++e) {
        v[e] = box_element<kTransposed>(table, n_rows, r, e);
      }
      acc = acc + slab_hits(v, ox, oy, oz, ix, iy, iz);
      if (kBody == kBodySlabStack) side_stack[i % kSideStack] = r;
      if (kBody != kBodySlabFixed) r = chase_next(nxt, r, n_rows);
    }
  }
  // The empty body's chase has no output: a volatile store of its last row
  // keeps the compiler from dropping the chase.
  if (kBody == kBodyEmpty) side_stack[0] = r;
  if (kBody == kBodyIntSum) return static_cast<float>(static_cast<int>(sum));
  if (kBody == kBodyChase) return static_cast<float>(r);
  return acc;
}

// ---------------------------------------------------------------------------
// Kernel A split, for the slab bodies (slab, slab_stack, slab_fixed) and
// the chain bodies (empty, chase).  The function of a slab body is
//   out[lane] = sum over i < steps of hits(node r_i, ray lane),
// r_0 = 0 and r_{i+1} = nxt[r_i] (slab_fixed: r_i = 37 i mod R), and the
// chain of r never depends on a slab result.  So the work splits in two
// passes: a chain walk (one thread) that counts its visits of each row,
// then a slab pass spread over blocks that tests each visited row once
// per lane and adds count * hits, as integers (slab_fixed, which walks no
// chain, tests its rows step by step, each once).  A step's count is an
// integer <= 8, so while 8 * steps <= 2^24 the float32 running sum of the
// per-lane body (slab_chase_lane) is exact in any order, and the integer
// total converts to the same float: kChaseMaxSteps keeps it there.
constexpr int kChaseMaxSteps = 1 << 21;
constexpr int kSlabBatch = 32;   // items whose boxes a block stages at once
constexpr int kSlabGrid = 1056;  // target chunks of the slab pass (8 per SM)
constexpr int kMaxChunk = 256;   // items of a chunk, at most

SHIMMER_HOST_HD bool is_split_body(int body) {
  return body == kBodySlab || body == kBodySlabStack ||
         body == kBodySlabFixed || body == kBodyEmpty || body == kBodyChase;
}

// Whether the walk of a body counts its visits (the slab bodies that walk).
SHIMMER_HOST_HD bool counts_visits(int body) {
  return body == kBodySlab || body == kBodySlabStack;
}

// The slab pass's items, at most: the distinct rows a walk can count, or
// slab_fixed's steps.
SHIMMER_HOST_HD int slab_items(int body, int n_rows, int steps) {
  return body == kBodySlabFixed || steps < n_rows ? steps : n_rows;
}

// Items of one slab-pass chunk: a multiple of kSlabBatch near items /
// kSlabGrid, within [kSlabBatch, kMaxChunk].
SHIMMER_HOST_HD int slab_chunk(int items) {
  int c = (items + kSlabGrid - 1) / kSlabGrid;
  c = (c + kSlabBatch - 1) / kSlabBatch * kSlabBatch;
  return c < kSlabBatch ? kSlabBatch : (c > kMaxChunk ? kMaxChunk : c);
}

SHIMMER_HOST_HD int slab_blocks(int items) {
  return (items + slab_chunk(items) - 1) / slab_chunk(items);
}

// Item k of the slab pass: the row and its visit count, from the walk's
// list, or slab_fixed's step k (row 37 k mod R, visited once).
template <int kBody>
SHIMMER_HD int item_row(const int* rows, int k, int n_rows) {
  return kBody == kBodySlabFixed
             ? static_cast<int>(static_cast<long long>(k) * kFixedStride %
                                n_rows)
             : rows[k];
}

template <int kBody>
SHIMMER_HD int item_count(const int* counts, int k) {
  return kBody == kBodySlabFixed ? 1 : counts[k];
}

// nxt staged for the walk: entry r holds clamp_row(nxt[r]) times
// sizeof(int), the byte offset of the next entry, so a step of the walk is
// one load whose result is the next load's offset.
SHIMMER_HD void stage_chain(const int* nxt, int n_rows, int* staged, int first,
                            int stride) {
  for (int r = first; r < n_rows; r += stride) {
    staged[r] = clamp_row(SHIMMER_LDG(nxt + r), n_rows) *
                static_cast<int>(sizeof(int));
  }
}

// One more visit of row r.  On the device a shared-memory atomic whose
// result is not read, so the walk does not wait for it.
SHIMMER_HD void count_visit(int* visits, int r) {
#if defined(__CUDA_ARCH__)
  atomicAdd(visits + r, 1);
#else
  visits[r] += 1;
#endif
}

// The chain walk of a split body from r = 0 over `steps` visits, reading
// the staged offsets or nxt itself: counts each visit of a row in visits
// for the bodies that count (counts_visits), makes row 11's stack store
// for slab_stack and the empty body's store of its last row; returns the
// row after the last visit.  Each step issues the load of the next row
// before its own stores, so they wait on nothing the chain needs.
template <int kBody, bool kStaged>
SHIMMER_HD int chase_walk(const int* nxt, const int* staged, int n_rows,
                          int steps, int* visits, volatile int* side_stack) {
  constexpr bool kCount = kBody == kBodySlab || kBody == kBodySlabStack;
  constexpr int kWord = static_cast<int>(sizeof(int));
  int r = 0;
  int off = 0;
  for (int i = 0; i < steps; ++i) {
    const int cur = kStaged ? off / kWord : r;
    if (kStaged) {
      off = *reinterpret_cast<const int*>(
          reinterpret_cast<const char*>(staged) + off);
    } else {
      r = chase_next(nxt, r, n_rows);
    }
    if (kCount) count_visit(visits, cur);
    if (kBody == kBodySlabStack) side_stack[i % kSideStack] = cur;
  }
  if (kStaged) r = off / kWord;
  if (kBody == kBodyEmpty) side_stack[0] = r;
  return r;
}

// A lane's sum of count * hits over items [first, last), the boxes read
// from the table (the host build's form of a chunk; the kernel stages them
// in shared memory).
template <int kBody, bool kTransposed>
SHIMMER_HD int items_hits(const float* table, int n_rows, const int* rows,
                          const int* counts, const float* rays, int lane,
                          int first, int last) {
  int sum = 0;
  for (int k = first; k < last; ++k) {
    const int r = item_row<kBody>(rows, k, n_rows);
    float v[kBoxFloats];
    for (int e = 0; e < kBoxFloats; ++e) {
      v[e] = box_element<kTransposed>(table, n_rows, r, e);
    }
    sum += item_count<kBody>(counts, k) *
           slab_hit_count(v, rays[0 * kLanes + lane], rays[1 * kLanes + lane],
                          rays[2 * kLanes + lane], rays[3 * kLanes + lane],
                          rays[4 * kLanes + lane], rays[5 * kLanes + lane]);
  }
  return sum;
}

// ---------------------------------------------------------------------------
// Kernel B, step_attrib (row 15, exp_step_attrib.py::kern): the v1 packet
// step body over the BVH8 rows with pieces switched off.  Its outputs are
// meaningless by design; what matters is that each variant does the work
// the reference's does.
enum : int {
  kAttribFull = 0,
  kAttribNoRoll = 1,    // the node fetched is r & ~7 (its tile, unrotated)
  kAttribNoLeaf = 2,
  kAttribNoInt = 3,     // bits = 3, no slab test
  kAttribNoBits = 4,    // slab test, but bits = 3: no cross-lane reduction
  kAttribNoScalar = 5,  // r = (i * (k + 3)) % R, cnt = r & 3: no stack, meta
  kNumAttrib = 6,
};
constexpr int kAttribRayRows = 16;
constexpr int kAttribOutRows = 8;
// Packets of a program (the block is packets * kLanes threads) and stack
// slots of a packet, at most.
constexpr int kAttribMaxPackets = 4;
constexpr int kAttribMaxStack = 128;
constexpr int kAttribConstBits = 3;
constexpr float kAttribTInit = 1e30f;
// Row columns of a node's fields (the reference's tiles8 fields c,
// shimmer_tpu/ops/bvh8.py:265-302): field c of slot j is rows8[r, 8c + j],
// except field 6 of an internal row, which is its slot-valid flag
// rows8[r, 88 + j].
constexpr int kColField6Leaf = 48;

// A lane's ray from its packet's (16, kLanes) block: origin rows 0-2,
// direction 3-5, the any-hit flag row 7 (> 0), the slab inverse rows
// 8-10, the shear rows 11-13, the permutation code row 14 (< 0.5: x is
// the max axis; < 1.5: y; else z) and the dz_ok flag row 15 (> 0).
SHIMMER_HD Ray attrib_ray(const float* rays16, int lane, bool& want_any) {
  Ray ray;
  ray.ox = SHIMMER_LDG(rays16 + 0 * kLanes + lane);
  ray.oy = SHIMMER_LDG(rays16 + 1 * kLanes + lane);
  ray.oz = SHIMMER_LDG(rays16 + 2 * kLanes + lane);
  ray.dx = SHIMMER_LDG(rays16 + 3 * kLanes + lane);
  ray.dy = SHIMMER_LDG(rays16 + 4 * kLanes + lane);
  ray.dz = SHIMMER_LDG(rays16 + 5 * kLanes + lane);
  want_any = SHIMMER_LDG(rays16 + 7 * kLanes + lane) > 0.0f;
  ray.ix = SHIMMER_LDG(rays16 + 8 * kLanes + lane);
  ray.iy = SHIMMER_LDG(rays16 + 9 * kLanes + lane);
  ray.iz = SHIMMER_LDG(rays16 + 10 * kLanes + lane);
  ray.sx = SHIMMER_LDG(rays16 + 11 * kLanes + lane);
  ray.sy = SHIMMER_LDG(rays16 + 12 * kLanes + lane);
  ray.sz = SHIMMER_LDG(rays16 + 13 * kLanes + lane);
  const float pc = SHIMMER_LDG(rays16 + 14 * kLanes + lane);
  ray.kz = pc < 0.5f ? 0 : (pc >= 0.5f && pc < 1.5f ? 1 : 2);
  ray.dz_ok = SHIMMER_LDG(rays16 + 15 * kLanes + lane) > 0.0f;
  return ray;
}

// jnp's % on int32: the remainder takes the divisor's sign.
SHIMMER_HD int floor_mod(int a, int b) {
  const int q = a % b;
  return (q != 0 && ((q < 0) != (b < 0))) ? q + b : q;
}

// The packet's pop (exp_step_attrib.py:151-162): reads stack[0] (the
// stack pointer's word) and stack[sp]; `written` is what the pop leaves at
// stack[sp].  The caller stores it.
struct AttribPop {
  int r;
  int sp;
  int written;
};

SHIMMER_HD AttribPop attrib_pop(const int* stack, int stack_size, int i,
                                int n_rows) {
  AttribPop p;
  const int sp0 = floor_mod(stack[0], stack_size);
  p.sp = sp0 > 0 ? sp0 : 0;
  const int e = stack[p.sp];
  const int bits_e = e & 255;
  const int lsb = bits_e & (-bits_e);
  const int rest = static_cast<int>(static_cast<unsigned>(e) -
                                    static_cast<unsigned>(lsb));
  p.written = rest == 0 ? (e | 1) : rest;
  const long long r = static_cast<long long>(e >> 8) + lowest_bit_index(lsb) + i;
  p.r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : static_cast<int>(r));
  return p;
}

// The push after a visit of a row with meta word m (:172-174): the slot
// above the popped one gets (child_base << 8) | bits when bits != 0.
SHIMMER_HD int attrib_push_slot(int sp, int stack_size) {
  const int s = sp + 1;
  return s < 0 ? 0 : (s > stack_size - 1 ? stack_size - 1 : s);
}

SHIMMER_HD int attrib_push_word(int m, int bits) {
  return static_cast<int>((static_cast<unsigned>(m >> 4) << 8) |
                          static_cast<unsigned>(bits));
}

// Field 6 of slot j of a node row: the valid flag of an internal row, the
// p2x coordinate of a leaf row.
SHIMMER_HD float attrib_field6(const float* row, bool internal, int j) {
  return SHIMMER_LDG(row + (internal ? kColValid : kColField6Leaf) + j);
}

// The lane's internal step (:78-96): slab test of the node's 8 boxes with
// the 1.0001 slack against (0, t_best), masked by field 6 and the lane's
// active flag; returns the lane's hit bits (slot j at bit j).
SHIMMER_HD int attrib_internal_mask(const float* row, bool internal,
                                    const Ray& ray, float t_best,
                                    float active) {
  int mask = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float tn;
    const bool hit = slab_hit(SHIMMER_LDG(row + j), SHIMMER_LDG(row + 8 + j),
                              SHIMMER_LDG(row + 16 + j),
                              SHIMMER_LDG(row + 24 + j),
                              SHIMMER_LDG(row + 32 + j),
                              SHIMMER_LDG(row + 40 + j), ray, t_best, tn);
    if (hit && attrib_field6(row, internal, j) > 0.0f && active > 0.0f) {
      mask |= 1 << j;
    }
  }
  return mask;
}

// The lane's leaf step (:98-137): the watertight test of the node's slots
// below cnt (fields 0-8 as p0, p1, p2; field 9 the id), the lowest slot
// among the closest winning; an any-hit lane goes inactive on a hit.
SHIMMER_HD void attrib_leaf(const float* row, bool internal, int cnt,
                            const Ray& ray, bool want_any, float& t_best,
                            float& tri, float& active) {
  float t_leaf = INFINITY;
  int k_leaf = -1;
  if (active > 0.0f) {
    for (int k = 0; k < 8 && k < cnt; ++k) {
      float t;
      if (watertight_hit(
              SHIMMER_LDG(row + k), SHIMMER_LDG(row + 8 + k),
              SHIMMER_LDG(row + 16 + k), SHIMMER_LDG(row + 24 + k),
              SHIMMER_LDG(row + 32 + k), SHIMMER_LDG(row + 40 + k),
              attrib_field6(row, internal, k), SHIMMER_LDG(row + 56 + k),
              SHIMMER_LDG(row + 64 + k), ray, t_best, t) &&
          t < t_leaf) {
        t_leaf = t;
        k_leaf = k;
      }
    }
  }
  if (t_leaf < t_best) {
    t_best = t_leaf;
    tri = SHIMMER_LDG(row + kColIds + k_leaf);
    if (want_any) active = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Kernel C, step_ablate (row 16, exp_ablate_step.py::kern): one packet
// over a chain r = meta[r] from r = 1, each variant adding one ingredient
// of the traversal step.  Each program computes the same (8, kLanes) block.
enum : int {
  kAblateScalar = 0,   // v0: the chain alone, acc += 1
  kAblateFetch32 = 1,  // v1: + the exact float32 row, acc += row[0:8]
  kAblateFetchBf = 2,  // v2: + the bf16 hi|lo row and a slab test
  kAblateBits = 3,     // v3: v2 with the lanes' OR of hits fed to the chain
  kAblateCond = 4,     // v4: v3 or a leaf-ish branch, on r & 1
  kNumAblate = 5,
};
constexpr float kAblateScaleX = 1.7f;
constexpr float kAblateScaleY = 0.9f;

SHIMMER_HD float ablate_ox(int lane) {
  return static_cast<float>(lane) * 0.01f + 0.5f;
}

SHIMMER_HD float bits_to_float(unsigned u) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof(f));
  return f;
#endif
}

// A packed word's float: its bf16 hi (upper 16 bits) plus its bf16 lo
// (lower 16 bits), added in float32.
SHIMMER_HD float hilo_value(int word) {
  const unsigned u = static_cast<unsigned>(word);
  return bits_to_float(u & 0xFFFF0000u) + bits_to_float(u << 16);
}

// The slab of v2-v4 (:59-67) on a packed row: acc[j] += tn_j; returns the
// lane's hit bits (tn <= tf * 1.0001 and field 48 + j > 0).
SHIMMER_HD int ablate_slab(const int* wrow, float ox, float acc[8]) {
  int mask = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t0 = (hilo_value(SHIMMER_LDG(wrow + j)) - ox) * kAblateScaleX;
    const float t1 =
        (hilo_value(SHIMMER_LDG(wrow + 24 + j)) - ox) * kAblateScaleX;
    const float t0y =
        (hilo_value(SHIMMER_LDG(wrow + 8 + j)) - ox) * kAblateScaleY;
    const float t1y =
        (hilo_value(SHIMMER_LDG(wrow + 32 + j)) - ox) * kAblateScaleY;
    const float tn = fmax_(fmin_(t0, t1), fmin_(t0y, t1y));
    const float tf = fmin_(fmax_(t0, t1), fmax_(t0y, t1y));
    if (tn <= tf * 1.0001f && hilo_value(SHIMMER_LDG(wrow + 48 + j)) > 0.0f) {
      mask |= 1 << j;
    }
    acc[j] = acc[j] + tn;
  }
  return mask;
}

// v4's leaf-ish branch (:102-106): acc[j] += row[j] * row[8 + j]; its bits
// are sum over the (8, kLanes) block of where(row[j] * 0 > 1, 2^j, 0),
// plus 1 (1 for every finite or infinite row).
SHIMMER_HD int ablate_leaf(const float* row, float acc[8]) {
  int bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = SHIMMER_LDG(row + j);
    acc[j] = acc[j] + a * SHIMMER_LDG(row + 8 + j);
    if (a * 0.0f > 1.0f) bits += 1 << j;
  }
  return static_cast<int>(static_cast<unsigned>(bits) * kLanes + 1u);
}

}  // namespace packet
}  // namespace shimmer

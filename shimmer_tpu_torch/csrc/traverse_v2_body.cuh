// Per-ray body of the v2 traversal: near-first ordered internal pops and a
// postponed-leaf backlog.  Shared by the CUDA kernel (traverse.cu) and
// the host build (traverse_host.cpp) the CPU tests compile with g++.
//
// It computes what shimmer_tpu/ops/pallas/traverse.py::_traverse_kernel_v2
// computes, with the same outputs as the v1 body (traverse_body.cuh): the
// closest hit (t, tri) with tri = -1 on a miss, an early exit at the first
// accepted hit for an any-hit ray, and the number of node visits.  What is
// carried over from the reference is what v2 computes, not its packet
// machinery (no shared packet stack, interleaved chains, packet groups or
// the tiles8 child-leaf column c11):
//
// * Internal stack of ordered entries: e0 = child_base << 4 | n_remaining,
//   e1 = the 3-bit slots of the node's internal children in ascending
//   entry distance (this ray's own slab tn; ties to the lower slot), so a
//   pop takes the nearest remaining child first.
// * Leaf backlog of `child_base << 8 | leaf bits` entries, popped
//   lowest-bit first, at most kLeafStack entries.  While the backlog holds
//   kLeafStack - 2 or more entries the internal pop pauses (the reference's
//   backpressure, traverse.py:697), which bounds it.
// * Each loop step retires one leaf visit and one internal visit, so a
//   warp's threads stay in the same phase of the loop: Aila and Laine's
//   "postponed leaves" (2009).  A child is a leaf when its meta word has a
//   nonzero count (meta[child_base + j] & 15); rows8 carries no c11 column.
//
// Leaves are watertight and the lowest slot wins among equal t in a leaf,
// as in the reference, whose v2 reads neither SHIMMER_LEAF_MT nor
// SHIMMER_WINID_MIN.
//
// On the H100 the body is bound by its chain of dependent row reads (from
// L2 for the 39 MB bench table, often from HBM for the 152 MB 1.3M-triangle
// one) and by divergence between a warp's rays, not by arithmetic.  The
// postponed-leaf loop answers the divergence: every iteration runs the same
// two visits on every thread.  The price is two more per-thread stacks
// (local memory, 640 bytes a thread) and the child meta reads.
#pragma once

#include "traverse_body.cuh"

namespace shimmer {

constexpr int kLeafStack = 32;

SHIMMER_HD RayResult traverse_ray_v2(const float* __restrict__ rows,
                                     const int* __restrict__ meta, int n_rows,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, float t_max,
                                     bool any_hit, uint8_t* touched) {
  RayResult res;
  res.t = INFINITY;
  res.tri = -1;
  res.steps = 0;
  if (!(t_max > 0.0f)) return res;
  const Ray ray = make_ray(ox, oy, oz, dx, dy, dz);

  int istack0[kMaxStack];
  int istack1[kMaxStack];
  int lstack[kLeafStack];
  int sp = 0;
  int lsp = 0;
  // The root row may itself be a leaf (scenes of at most 8 triangles).
  touch_meta(touched, n_rows, 0);
  if ((SHIMMER_LDG(meta) & 15) > 0) {
    lstack[lsp++] = 1;
  } else {
    istack0[sp] = 1;  // child_base 0, one child
    istack1[sp] = 0;  // slot 0
    ++sp;
  }
  float t_best = t_max;
  int tri_best = -1;
  int steps = 0;

  while (sp > 0 || lsp > 0) {
    const bool paused = lsp >= kLeafStack - 2;

    // --- one leaf visit from the backlog ---
    if (lsp > 0) {
      const int e = lstack[lsp - 1];
      const int bits = e & 255;
      const int lsb = bits & (-bits);
      const int rest = e - lsb;
      if ((rest & 255) == 0) {
        --lsp;
      } else {
        lstack[lsp - 1] = rest;
      }
      const int r = clamp_row((e >> 8) + lowest_bit_index(lsb), n_rows);
      ++steps;
      touch_row(touched, n_rows, r);
      const int cnt = SHIMMER_LDG(meta + r) & 15;
      if (leaf_test8<kLeafWatertight, kWinnerSlot>(rows + (size_t)r * kRowWidth,
                                               cnt, ray, t_best, tri_best) &&
          any_hit) {
        break;
      }
    }

    // --- one internal visit, nearest remaining child first ---
    if (sp > 0 && !paused) {
      const int e0 = istack0[sp - 1];
      const int e1 = istack1[sp - 1];
      if ((e0 & 15) == 1) {
        --sp;
      } else {
        istack0[sp - 1] = e0 - 1;
        istack1[sp - 1] = e1 >> 3;
      }
      const int r = clamp_row((e0 >> 4) + (e1 & 7), n_rows);
      ++steps;
      touch_row(touched, n_rows, r);
      const int base = SHIMMER_LDG(meta + r) >> 4;
      float tn[8];
      const int hits =
          slab_test8(rows + (size_t)r * kRowWidth, ray, t_best, tn);
      if (hits != 0) {
        int leaf_bits = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (!((hits >> k) & 1)) continue;
          const int c = clamp_row(base + k, n_rows);
          touch_meta(touched, n_rows, c);
          if ((SHIMMER_LDG(meta + c) & 15) > 0) leaf_bits |= 1 << k;
        }
        const int int_bits = hits & ~leaf_bits;
        int order = 0;
        int n_int = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (!((int_bits >> k) & 1)) continue;
          int rank = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (((int_bits >> j) & 1) &&
                (tn[j] < tn[k] || (tn[j] == tn[k] && j < k))) {
              ++rank;
            }
          }
          order |= k << (3 * rank);
          ++n_int;
        }
        if (leaf_bits != 0) {
          lstack[lsp++] = (base << 8) | leaf_bits;
        }
        if (n_int != 0 && sp < kMaxStack) {
          istack0[sp] = (base << 4) | n_int;
          istack1[sp] = order;
          ++sp;
        }
      }
    }
  }
  res.t = tri_best >= 0 ? t_best : INFINITY;
  res.tri = tri_best;
  res.steps = steps;
  return res;
}

}  // namespace shimmer

// Per-ray body of the v2 traversal: near-first ordered internal pops and a
// postponed-leaf backlog.  Shared by the CUDA kernel (traverse.cu) and
// the host build (traverse_host.cpp) the CPU tests compile with g++.
//
// It computes what shimmer_tpu/ops/pallas/traverse.py::_traverse_kernel_v2
// computes, with the same outputs as the v1 body (traverse_body.cuh): the
// closest hit (t, tri) with tri = -1 on a miss, an early exit at the first
// accepted hit for an any-hit ray, and the number of node visits.  What is
// carried over from the reference is what v2 computes, not its packet
// machinery (no shared packet stack, interleaved chains or packet groups):
//
// * Internal stack of ordered entries (V2Entry): child_base << 4 |
//   n_remaining, and the 3-bit slots of the node's internal children in
//   ascending entry distance (this ray's own slab tn; ties to the lower
//   slot), so a pop takes the nearest remaining child first.
// * Leaf backlog of `child_base << 8 | leaf bits` entries, popped
//   lowest-bit first, at most kLeafStack entries.  While the backlog holds
//   kLeafStack - 2 or more entries the internal pop pauses (the reference's
//   backpressure, traverse.py:697), which bounds it.
// * Each loop step retires one leaf visit and one internal visit, so a
//   warp's threads stay in the same phase of the loop: Aila and Laine's
//   "postponed leaves" (2009).
// * A hit child is a leaf when its bit is set in the row's child-leaf mask,
//   one int32 per row (the reference's tiles8 column c11, pack_tiles8 in
//   shimmer_tpu/ops/bvh8.py; the port builds it in torch from meta,
//   ops/traverse.py::child_leaf_mask), so a visit reads no child meta word.
//
// Leaves are watertight and the lowest slot wins among equal t in a leaf,
// as in the reference, whose v2 reads neither SHIMMER_LEAF_MT nor
// SHIMMER_WINID_MIN.
//
// On the H100 the body is bound by its chain of dependent row reads (from
// L2 for the 39 MB bench table, often from HBM for the 152 MB 1.3M-triangle
// one) and by divergence between a warp's rays, not by arithmetic.  The
// postponed-leaf loop answers the divergence: every iteration runs the same
// two visits on every thread.  Redesigned for Hopper (each step timed in
// PERF.md): rows are read with v1's 16-byte loads (slab_test8_vec,
// leaf_test8_vec) and the child-leaf bits in one word.  Dropping popped
// entries beyond t_best, as v1 does, measured slower here (the backlog
// postpones the leaf hits that tighten t_best, so almost nothing is
// dropped) and is not done.
#pragma once

#include "traverse_body.cuh"

namespace shimmer {

constexpr int kLeafStack = 32;

// One internal stack entry: the pending internal children of a row.
struct V2Entry {
  int head;   // child_base << 4 | number of pending slots
  int slots;  // the pending slots, 3 bits each, nearest in the low bits
};

// The stack bounds.  Internal stack: an entry is pushed at the visit of an
// internal node at level l and holds internal children at level l + 1; it
// stays until its last child is taken.  Invariant: the entries hold rows
// of strictly increasing levels.  It holds at the start (one entry, the
// root at level 0); each pop takes its row from the top entry, so the row
// visited lies at the top entry's level L, and the entry its visit pushes
// holds level L + 1, above the top entry if it remains and above the one
// below it (level < L) if not.  Every entry holds internal rows, so the
// stack holds at most (deepest internal level + 1) entries; the BVH8 build
// sets stack_depth = deepest internal level + 2, which the wrapper holds to
// kMaxStack - 8, so kMaxStack entries never overflow and the push needs no
// guard.
// Leaf backlog: a loop step makes at most one leaf visit, which never adds
// an entry, and at most one internal visit, which adds at most one; it
// makes the internal visit only while the backlog held fewer than
// kLeafStack - 2 entries at the step's start.  So a step that starts below
// kLeafStack - 2 ends at most at kLeafStack - 2, and one that starts at or
// above it does not grow: the backlog never holds more than kLeafStack - 2
// entries.
// V2Ray is a state machine (start, then step until it returns false), so
// that the host build can read both depths between steps.
struct V2Ray {
  Ray ray;
  float t_best;
  int tri_best;
  int steps;
  int sp;   // internal entries
  int lsp;  // backlog entries
  bool any_hit;

  // Sets up one ray and pushes the root; false for a dead lane (t_max <=
  // 0, -inf or NaN), which takes no step.
  SHIMMER_HD bool start(float ox, float oy, float oz, float dx, float dy,
                        float dz, float t_max, bool any_hit_,
                        const int* __restrict__ meta, int n_rows,
                        V2Entry* istack, int* lstack, uint8_t* touched) {
    t_best = t_max;
    tri_best = -1;
    steps = 0;
    sp = 0;
    lsp = 0;
    any_hit = any_hit_;
    if (!(t_max > 0.0f)) return false;
    ray = make_ray(ox, oy, oz, dx, dy, dz);
    // The root row may itself be a leaf (scenes of at most 8 triangles).
    touch_meta(touched, n_rows, 0);
    if ((SHIMMER_LDG(meta) & 15) > 0) {
      lstack[lsp++] = 1;
    } else {
      istack[sp++] = V2Entry{1, 0};  // child_base 0, one child, slot 0
    }
    return true;
  }

  // One loop step: a leaf visit from the backlog, then an internal visit
  // unless the backlog holds kLeafStack - 2 entries or more.  False once
  // the ray is done (both stacks empty, or an any-hit ray found a hit).
  // istack holds kMaxStack entries, lstack kLeafStack.
  SHIMMER_HD bool step(const float* __restrict__ rows,
                       const int* __restrict__ meta,
                       const int* __restrict__ child_leaf, int n_rows,
                       V2Entry* istack, int* lstack, uint8_t* touched) {
    const bool paused = lsp >= kLeafStack - 2;
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
      if (leaf_test8_vec<kLeafWatertight, kWinnerSlot>(
              rows + (size_t)r * kRowWidth, cnt, ray, t_best, tri_best) &&
          any_hit) {
        return false;
      }
    }
    if (sp > 0 && !paused) {
      V2Entry& top = istack[sp - 1];
      const int r = clamp_row((top.head >> 4) + (top.slots & 7), n_rows);
      if ((top.head & 15) == 1) {
        --sp;
      } else {
        top.head -= 1;
        top.slots >>= 3;
      }
      ++steps;
      touch_row(touched, n_rows, r);
      const int base = SHIMMER_LDG(meta + r) >> 4;
      float tn[8];
      const int hits =
          slab_test8_vec(rows + (size_t)r * kRowWidth, ray, t_best, tn);
      if (hits != 0) {
        const int leaf_bits = hits & SHIMMER_LDG(child_leaf + r);
        int n_int;
        float tn1;  // unused: v2 drops no entry
        const int order = near_order(hits & ~leaf_bits, tn, n_int, tn1);
        if (leaf_bits != 0) lstack[lsp++] = (base << 8) | leaf_bits;
        if (n_int != 0) istack[sp++] = V2Entry{(base << 4) | n_int, order};
      }
    }
    return sp > 0 || lsp > 0;
  }

  SHIMMER_HD RayResult result() const {
    RayResult res;
    res.t = tri_best >= 0 ? t_best : INFINITY;
    res.tri = tri_best;
    res.steps = steps;
    return res;
  }
};

}  // namespace shimmer

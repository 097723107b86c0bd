// Test-only host build of the packet-step kernels' bodies
// (packet_step_body.cuh): the packet slab chase (per lane, and the split
// form the card runs for the slab and chain bodies), the step attribution
// and its chain in closed form, and the step ablation as the card runs it
// (its next table, its walk, and its sums).
//
// The CPU tests compile this file with g++ (-ffp-contract=off) and call it
// through ctypes, so the kernels' own per-lane and per-packet steps are
// checked against the plain torch versions (ops/packet_step.py) on a
// machine without a GPU.  No entry point of the port loads it.  Arguments
// as packet_step.cu's entry points, less the stream and the scratch; the lanes of a packet
// run one after another where the kernels run them side by side, and the
// packet's OR of hit bits is taken over all of them.  Each returns 0, or
// -1 for arguments the kernels do not take.

#include <vector>

#include "packet_step_body.cuh"

using namespace shimmer;
using namespace shimmer::packet;

namespace {

template <int kBody, bool kTransposed>
void chase_all(const float* table, int n_rows, const int* nxt,
               const float* rays, int steps, float* out) {
  int side_stack[kSideStack] = {0};
  for (int lane = 0; lane < kLanes; ++lane) {
    out[lane] = slab_chase_lane<kBody, kTransposed>(table, n_rows, nxt, rays,
                                                    lane, steps, side_stack);
  }
}

template <int kBody>
void chase_layout(bool transposed, const float* table, int n_rows,
                  const int* nxt, const float* rays, int steps, float* out) {
  if (transposed) {
    chase_all<kBody, true>(table, n_rows, nxt, rays, steps, out);
  } else {
    chase_all<kBody, false>(table, n_rows, nxt, rays, steps, out);
  }
}

// The split form of a slab or chain body, as the kernels compute it: the
// walk (from nxt staged as byte offsets, or from nxt) counting its visits
// of each row, the visited rows listed, then each slab-pass chunk of items
// summed per lane as count * hits in integers, and the total written as
// float.
template <int kBody, bool kTransposed>
void chase_split(const float* table, int n_rows, const int* nxt,
                 const float* rays, int steps, bool staged, float* out) {
  int side_stack[kSideStack] = {0};
  std::vector<int> visits(n_rows, 0), stage(n_rows);
  if (staged) stage_chain(nxt, n_rows, stage.data(), 0, 1);
  const int last =
      staged ? chase_walk<kBody, true>(nxt, stage.data(), n_rows, steps, visits.data(),
                                       side_stack)
             : chase_walk<kBody, false>(nxt, stage.data(), n_rows, steps, visits.data(),
                                        side_stack);
  if (kBody == kBodyEmpty || kBody == kBodyChase) {
    for (int lane = 0; lane < kLanes; ++lane) {
      out[lane] = kBody == kBodyChase ? static_cast<float>(last) : 0.0f;
    }
    return;
  }
  std::vector<int> rows, counts;
  for (int r = 0; r < n_rows; ++r) {
    if (visits[r] > 0) {
      rows.push_back(r);
      counts.push_back(visits[r]);
    }
  }
  const int items = kBody == kBodySlabFixed ? steps : static_cast<int>(rows.size());
  const int chunk = slab_chunk(slab_items(kBody, n_rows, steps));
  for (int lane = 0; lane < kLanes; ++lane) {
    int acc = 0;
    for (int first = 0; first < items; first += chunk) {
      const int end = first + chunk < items ? first + chunk : items;
      acc += items_hits<kBody, kTransposed>(table, n_rows, rows.data(), counts.data(), rays,
                                            lane, first, end);
    }
    out[lane] = static_cast<float>(acc);
  }
}

template <int kBody>
void split_layout(bool transposed, const float* table, int n_rows,
                  const int* nxt, const float* rays, int steps, bool staged,
                  float* out) {
  if (transposed) {
    chase_split<kBody, true>(table, n_rows, nxt, rays, steps, staged, out);
  } else {
    chase_split<kBody, false>(table, n_rows, nxt, rays, steps, staged, out);
  }
}

}  // namespace

// The split form of kernel A (slab, slab_stack, slab_fixed, empty, chase);
// staged: the walk reads nxt staged as byte offsets.  Any R: the kernel's
// limit on R (the visit counts in shared memory) is the wrapper's.
extern "C" int shimmer_packet_slab_chase_split_host(int body, int transposed,
                                                    const float* table,
                                                    int n_rows, const int* nxt,
                                                    const float* rays,
                                                    int steps, int staged,
                                                    float* out) {
  if (n_rows <= 0 || steps < 0 || steps > kChaseMaxSteps) return -1;
  const bool t = transposed != 0;
  const bool sg = staged != 0;
  switch (body) {
    case kBodySlab: split_layout<kBodySlab>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodySlabStack: split_layout<kBodySlabStack>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodyEmpty: split_layout<kBodyEmpty>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodySlabFixed: split_layout<kBodySlabFixed>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    case kBodyChase: split_layout<kBodyChase>(t, table, n_rows, nxt, rays, steps, sg, out); break;
    default: return -1;
  }
  return 0;
}

extern "C" int shimmer_packet_slab_chase_host(int body, int transposed,
                                              const float* table, int n_rows,
                                              const int* nxt,
                                              const float* rays, int steps,
                                              float* out) {
  if (n_rows <= 0 || steps < 0) return -1;
  const bool t = transposed != 0;
  switch (body) {
    case kBodySlab: chase_layout<kBodySlab>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodySlabStack: chase_layout<kBodySlabStack>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyEmpty: chase_layout<kBodyEmpty>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodySlabFixed: chase_layout<kBodySlabFixed>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyIntSum: chase_layout<kBodyIntSum>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyChase: chase_layout<kBodyChase>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyAcc: chase_layout<kBodyAcc>(t, table, n_rows, nxt, rays, steps, out); break;
    case kBodyAccScaled: chase_layout<kBodyAccScaled>(t, table, n_rows, nxt, rays, steps, out); break;
    default: return -1;
  }
  return 0;
}

namespace {

template <int kVariant>
void attrib_packets(const float* rows, const int* meta, int n_rows,
                    const float* rays, int programs, int packets, int steps,
                    int stack_size, int* stack, float* out) {
  std::vector<AttribVisit> visits(steps > 0 ? steps : 1);
  std::vector<int> lanes_or(steps > 0 ? steps : 1);
  // Each block's record: its last pushing step + 1 (0: none) and the word.
  std::vector<int> last_step(static_cast<size_t>(programs) * packets, 0);
  std::vector<int> last_word(static_cast<size_t>(programs) * packets, 0);
  // The blocks share nothing, so they run here from the last to the first.
  for (int p = programs * packets - 1; p >= 0; --p) {
    const int g = p / packets;
    const int k = p - g * packets;
    const int e0 = stack[k * stack_size + 1];
    for (int i = 0; i < steps; ++i) {
      visits[i] = attrib_visit_at(kVariant, meta, n_rows, e0, k, g, steps, i);
      lanes_or[i] = 0;
    }
    float* o = out + (size_t)p * kAttribOutRows * kLanes;
    for (int l = 0; l < kLanes; ++l) {
      bool want_any;
      const Ray ray = attrib_ray(rays + (size_t)p * kAttribRayRows * kLanes, l, want_any);
      float t_best = kAttribTInit, tri = -1.0f, active = 1.0f;
      for (int i = 0; i < steps; ++i) {
        lanes_or[i] |= attrib_lane_step<kVariant>(rows, visits[i], ray, want_any, t_best,
                                                  tri, active);
      }
      o[l] = t_best;
      o[kLanes + l] = tri;
    }
    for (int c = 2 * kLanes; c < kAttribOutRows * kLanes; ++c) o[c] = 0.0f;
    for (int i = steps - 1; i >= 0; --i) {
      const int b = attrib_step_bits(kVariant, lanes_or[i]);
      if (b != 0) {
        last_step[p] = i + 1;
        last_word[p] = attrib_push_word(visits[i].m, b);
        break;
      }
    }
  }
  for (int k = 0; k < packets; ++k) {
    int chosen = -1;
    for (int g = programs - 1; g >= 0 && chosen < 0; --g) {
      if (last_step[g * packets + k] > 0) chosen = g;
    }
    attrib_finish(kVariant, stack + k * stack_size, programs, steps, chosen >= 0,
                  chosen >= 0 ? last_word[chosen * packets + k] : 0);
  }
}

}  // namespace

// Row 15 as the card computes it (packet_step.cu, step_attrib_kernel and
// the finish): each (program, packet) block on its own, its visits from
// slot 1's starting word in closed form, the OR of the lanes' hit bits per
// step taken after the steps, and the last push in grid order chosen from
// the blocks' records.
extern "C" int shimmer_step_attrib_packet_host(int variant, const float* rows,
                                               const int* meta, int n_rows,
                                               const float* rays, int programs,
                                               int packets, int steps, int stack_size,
                                               int* stack, float* out) {
  if (!attrib_args_ok(variant, n_rows, programs, packets, steps, stack_size)) return -1;
  switch (variant) {
#define SHIMMER_ATTRIB_CASE(V)                                                          \
  case V:                                                                               \
    attrib_packets<V>(rows, meta, n_rows, rays, programs, packets, steps, stack_size,   \
                      stack, out);                                                      \
    break;
    SHIMMER_ATTRIB_CASE(kAttribFull)
    SHIMMER_ATTRIB_CASE(kAttribNoRoll)
    SHIMMER_ATTRIB_CASE(kAttribNoLeaf)
    SHIMMER_ATTRIB_CASE(kAttribNoInt)
    SHIMMER_ATTRIB_CASE(kAttribNoBits)
    SHIMMER_ATTRIB_CASE(kAttribNoScalar)
#undef SHIMMER_ATTRIB_CASE
  }
  return 0;
}

// Row 15's chain alone, as step_attrib_chain_kernel computes it: visits
// (programs * packets, steps, 2), the (r, meta[r]) of each step.
extern "C" int shimmer_step_attrib_chain_host(int variant, const int* meta, int n_rows,
                                              int programs, int packets, int steps,
                                              int stack_size, const int* stack,
                                              int* visits) {
  if (!attrib_args_ok(variant, n_rows, programs, packets, steps, stack_size)) return -1;
  for (int p = 0; p < programs * packets; ++p) {
    const int g = p / packets;
    const int k = p - g * packets;
    for (int i = 0; i < steps; ++i) {
      const AttribVisit v =
          attrib_visit_at(variant, meta, n_rows, stack[k * stack_size + 1], k, g, steps, i);
      visits[2 * ((size_t)p * steps + i)] = v.r;
      visits[2 * ((size_t)p * steps + i) + 1] = v.m;
    }
  }
  return 0;
}

// The closed form of slot 1 against the pops themselves: for each word,
// a three-slot stack [1, word, 0] popped n_max times by attrib_pop, slot
// 1 held against attrib_slot1_after at every n in [0, n_max].  Returns
// the number of (word, n) that differ.
extern "C" long long shimmer_attrib_slot1_mismatches(const int* words, int count,
                                                     int n_max) {
  long long bad = 0;
  for (int w = 0; w < count; ++w) {
    int st[kAttribMinStack] = {1, words[w], 0};
    for (int n = 0; n <= n_max; ++n) {
      if (attrib_slot1_after(words[w], n) != st[1]) ++bad;
      const AttribPop pop = attrib_pop(st, kAttribMinStack, n, 1);
      st[pop.sp] = pop.written;
    }
  }
  return bad;
}

// Row 16's arguments as the card takes them (any R on the host).
static bool ablate_args_ok(int variant, int n_rows, int programs, int steps) {
  return variant >= 0 && variant < kNumAblate && n_rows >= 2 && (n_rows & (n_rows - 1)) == 0 &&
         programs >= 0 && steps >= 0;
}

// Row 16's next table as the card's next pass (v3, v4) or its staging
// (v0-v2) computes it: next (R,) int32.
extern "C" int shimmer_ablate_next_host(int variant, const int* meta, const float* tab,
                                        const int* tab_i, int n_rows, int* next) {
  if (!ablate_args_ok(variant, n_rows, 0, 0)) return -1;
  for (int r = 0; r < n_rows; ++r) {
    const int bits = ablate_needs_bits(variant) ? ablate_row_bits(variant, tab, tab_i, r) : 0;
    next[r] = ablate_next(meta, variant, r, bits, n_rows);
  }
  return 0;
}

// Row 16's walk over a next table (R,) int32 of rows in [0, R), R <=
// 65535: seq (min(steps, R),) int32 the visited rows, walk (4,) int32
// (length, mu, lambda, last).
extern "C" int shimmer_ablate_walk_host(const int* next_rows, int n_rows, int steps, int* seq,
                                        int* walk) {
  if (n_rows < 2 || n_rows >= kAblateUnseen || steps < 0) return -1;
  std::vector<unsigned> entries(n_rows);
  std::vector<unsigned short> order(steps < n_rows ? steps : n_rows);
  for (int r = 0; r < n_rows; ++r) entries[r] = ablate_entry(next_rows[r]);
  const AblateWalk w = ablate_walk(entries.data(), order.data(), steps);
  for (int k = 0; k < w.length; ++k) seq[k] = order[k];
  walk[0] = w.length;
  walk[1] = w.mu;
  walk[2] = w.lambda;
  walk[3] = w.last;
  return 0;
}

// Row 16 as the card computes it (packet_step.cu, the next pass and the
// walk and sums): the next table, the walk, then per block of
// kAblateChainLanes accumulators the visited rows' terms held in a table
// when at most term_rows rows were visited (term_rows < 0: as many as the
// card's shared memory holds, ablate_term_rows), else computed in place,
// added in step order, copied to every program.
extern "C" int shimmer_step_ablate_host(int variant, const int* meta,
                                        const float* tab, const int* tab_i,
                                        int n_rows, int programs, int steps, int term_rows,
                                        float* out) {
  if (!ablate_args_ok(variant, n_rows, programs, steps) || n_rows > kAblateMaxRows) return -1;
  std::vector<int> next_rows(n_rows), order(steps < n_rows ? steps : n_rows), walk(4);
  shimmer_ablate_next_host(variant, meta, tab, tab_i, n_rows, next_rows.data());
  shimmer_ablate_walk_host(next_rows.data(), n_rows, steps, order.data(), walk.data());
  const AblateWalk w{walk[0], walk[1], walk[2], walk[3]};
  std::vector<unsigned short> seq(order.begin(), order.end());
  if (term_rows < 0) term_rows = ablate_term_rows(variant, n_rows, steps);
  const int per_step = ablate_terms_per_step(variant);
  const bool held = w.length <= term_rows;
  std::vector<float> terms(static_cast<size_t>(held ? w.length : 0) * 2 * kAblateChainLanes);
  for (int b = 0; b < 8 * kLanes / kAblateChainLanes; ++b) {
    const int j = b / (kLanes / kAblateChainLanes);
    const int lane0 = (b % (kLanes / kAblateChainLanes)) * kAblateChainLanes;
    if (per_step > 0 && held) {
      for (int d = 0; d < w.length; ++d) {
        for (int l = 0; l < kAblateChainLanes; ++l) {
          float v[2];
          ablate_terms(variant, tab, tab_i, seq[d], j, ablate_ox(lane0 + l), v);
          for (int i = 0; i < per_step; ++i) {
            terms[(d * per_step + i) * kAblateChainLanes + l] = v[i];
          }
        }
      }
    }
    for (int l = 0; l < kAblateChainLanes; ++l) {
      const float acc =
          held ? ablate_sum(variant, w, steps,
                            AblateHeldTerms{terms.data(), per_step, l})
               : ablate_sum(variant, w, steps,
                            AblateRowTerms{variant, tab, tab_i, seq.data(), j,
                                           ablate_ox(lane0 + l)});
      for (int g = 0; g < programs; ++g) {
        out[((size_t)g * 8 + j) * kLanes + lane0 + l] = acc + static_cast<float>(w.last);
      }
    }
  }
  return 0;
}

// v0's sum in closed form against float32 adds of 1.0 from 0, at every
// step count up to n_max: the number of counts where they differ.
extern "C" long long shimmer_ablate_ones_mismatches(int n_max) {
  const AblateWalk w{0, 0, 0, 0};
  struct None {
    float operator()(int, int) const { return 0.0f; }
  };
  long long bad = 0;
  float acc = 0.0f;
  for (int k = 0; k <= n_max; ++k) {
    if (ablate_sum(kAblateScalar, w, k, None{}) != acc) ++bad;
    acc = acc + 1.0f;
  }
  return bad;
}

extern "C" int shimmer_step_ablate_max_rows() { return kAblateMaxRows; }

extern "C" int shimmer_step_attrib_max_packets() { return kAttribMaxPackets; }

extern "C" int shimmer_step_attrib_max_stack() { return kAttribMaxStack; }

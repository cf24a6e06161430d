// K5 and K6: the model checker's frontier step and liveness check.
//
// K5 replaces manatee_tpu/state/mc_array.py::build_step -> _step_one
// (:1212-1236) with what it calls: enabled_mask (:768), the action
// kernels (:671-743), eval_kernel (:846), _write_viol (:1036) and
// safety_mask (:806).  It expands every frontier state over the whole
// action alphabet:
//
//   states int32 (B, SIZE), knobs int32 (9,)
//   -> children int32 (B, S, SIZE), violation bits int32 (B, S),
//      enabled bool (B, S)
//
// K6 replaces build_liveness -> liveness_kernel (:1068-1175,
// :1239-1245): catch-up, the fair schedule run to fixpoint (at most 30
// rounds), then the convergence predicates -> int32 (B,) bits.
//
// SIZE / S are 127 / 27 for P = 3 peers and 176 / 34 for P = 4; the
// kernels are templates on P with the Layout offsets and the slot table
// as compile-time constants (instantiated for 3 and 4).
//
// Bound on an H100 SXM: both are integer control flow over a few hundred
// bytes a state, with no arithmetic to speak of.  K5 reads B*SIZE*4
// bytes and writes B*S*(SIZE+2)*4 (the children dominate: 24 KB a state
// at P = 4), so bytes bound it; K6 reads B*SIZE*4 and writes B*4, and is
// held far above that by its serial per-row work (up to 30 rounds of P
// evaluations, each a chain of dependent shared-memory reads).
//
// Design (these are exact int32 results, one differing element is a
// wrong answer):
// * K5: one thread per (row, slot), R = kStepRows rows a block.  The
//   block stages its R parents in
//   shared memory and fills its R x S children there from them, both
//   with coalesced sweeps; each slot's thread then applies its slot to
//   its own child in shared memory (a switch on the slot kind) and
//   computes safety_mask on it, and writes viol and enabled.  A disabled
//   slot leaves the PARENT as its child and writes 0 as its viol
//   (:1221-1222).  The block's children are one contiguous range of the
//   output, stored in one coalesced sweep of 16-byte stores.  The slot's
//   kind and argument are computed from its index (slot_of), not read
//   from a table in local memory.  The children take R * S * PITCH
//   ints (~24 KB a row at P = 4, ~13 KB at P = 3), so the block of two
//   rows at P = 4 (49,616 bytes) opts in to over 48 KB of dynamic shared
//   memory.  R = 2: of 1 to 8 rows a block, timed on an H100, 2 to 4
//   were the fastest at chunk 1024 and at 65,536 rows (PERF.md).
// * K6: kLiveRowsPerWarp rows a warp, kLiveWarps warps a block (both
//   compile-time constants, chosen from a sweep of six shapes on the
//   card; PERF.md).  A row's work is serial: within a round, peer i's
//   alive-and-reachable bit is read after peers < i were synced and
//   evaluated (:1097-1105), so nothing evaluates a row's peers in
//   parallel.  The parallelism is across rows and in a row's full-width
//   work.  The block stages its rows in shared memory by one coalesced
//   sweep, two buffers a row (the state and the one an evaluation
//   writes) at the odd pitch SIZE | 1, rather than two 176-int arrays in
//   each thread's local memory.  The 32 / kLiveRowsPerWarp lanes of a
//   row deliver (view_sync) together and copy the state into the other
//   buffer before each evaluation (eval_peer needs its output to hold a
//   copy of its input); the row's first lane runs K5's eval_peer and
//   predicates, and the buffers swap: one copy an evaluation, spread
//   over the lanes.  A vmapped lax.while_loop freezes a row once its own
//   condition is false, so a row stops at `done` or after 30 rounds; a
//   warp runs while any of its rows does (the probe's rows run 1 to 3
//   rounds, so rows sharing a warp lose little to each other).
// * Every state-block write goes through pack_sb, the canonical form
//   (NONE-padded tails, promote fields zeroed when absent): the dedup
//   compares raw bytes.  A NONE (-1) index is clipped to 0 before it
//   reads an array (_at, _member_at), as the reference clips it.
//
// Plain C entry points, built by nvcc alone and loaded with ctypes
// (manatee_tpu_torch/kernels/mc_step.py).

#include <cuda_runtime.h>

namespace {

constexpr int NONE = -1;

// role_note codes, pg-target role codes, promote-request role codes
constexpr int R_NONE = 0, R_PRIM = 1, R_SYNC = 2, R_ASYNC = 3, R_DEPOSED = 4;
constexpr int T_NONE = 0, T_PRIM = 1, T_SYNC = 2, T_ASYNC = 3;
constexpr int PR_SYNC = 0, PR_ASYNC = 1;

// knobs array layout (mc_array.py KNOBS)
constexpr int K_MAX_KILLS = 0, K_MAX_REJOINS = 1, K_PROMOTE = 2,
              K_FREEZE = 3, K_PARTITION = 4, K_MUT_XLOG = 5,
              K_MUT_FREEZE = 6, K_MUT_GENBUMP = 7, K_MUT_DEPOSED = 8;
constexpr int KNOBS = 9;

// violation bits: 1 << the category's index in canon.CATEGORIES
constexpr int B_GEN_BACKWARDS = 1 << 0;
constexpr int B_IW_BACKWARDS = 1 << 1;
constexpr int B_NEWPRIM_SAMEGEN = 1 << 3;
constexpr int B_PRIM_NOT_PREV_SYNC = 1 << 4;
constexpr int B_BUMP_NOCHANGE = 1 << 5;
constexpr int B_SYNC_NOBUMP = 1 << 6;
constexpr int B_FROZEN_WRITE = 1 << 7;
constexpr int B_XLOG_BEHIND = 1 << 8;
constexpr int B_SPLIT_BRAIN = 1 << 9;
constexpr int B_NO_FIXPOINT = 1 << 10;
constexpr int B_DEAD_PRIMARY_NOT_REPLACED = 1 << 12;
constexpr int B_NO_SYNC_APPOINTED = 1 << 13;
constexpr int B_ROLE_MISMATCH = 1 << 14;
constexpr int B_CHAIN = 1 << 15;

constexpr int MAX_ROUNDS = 30;
constexpr int kStepRows = 2;        // K5: rows (x S threads) a block
constexpr int kKnobWords = 16;      // K5: shared words of the knobs
constexpr int kLiveRowsPerWarp = 2; // K6: rows a warp (32 / it lanes a row)
constexpr int kLiveWarps = 2;       // K6: warps a block

// The int32 encoding's offsets (mc_array.py Layout).
template <int P>
struct Lay {
  // state block (relative offsets)
  static constexpr int SB_GEN = 0, SB_IW = 1, SB_PRIM = 2, SB_SYNC = 3,
                       SB_ASY = 4, SB_ASY_N = 4 + P, SB_DEP = 5 + P,
                       SB_DEP_N = 5 + 2 * P, SB_FROZEN = 6 + 2 * P,
                       SB_P_HAS = 7 + 2 * P, SB_P_ROLE = 8 + 2 * P,
                       SB_P_ID = 9 + 2 * P, SB_P_IDX = 10 + 2 * P,
                       SB_P_GEN = 11 + 2 * P, SB_P_EXP = 12 + 2 * P,
                       SB_SIZE = 13 + 2 * P;
  // globals
  static constexpr int G_KILLS = 0, G_REJOINS = 1, G_ACT = 2,
                       G_ACT_N = 2 + P, G_SB = 3 + P,
                       GLOB = 3 + P + SB_SIZE;
  // per-peer block
  static constexpr int PB_ALIVE = 0, PB_PART = 1, PB_X = 2, PB_VERCUR = 3,
                       PB_EVALED = 4, PB_NOTE = 5, PB_T_HAS = 6,
                       PB_T_ROLE = 7, PB_T_UP = 8, PB_T_DOWN = 9,
                       PB_T_DEP = 10, PB_VACT = 11, PB_VACT_N = 11 + P,
                       PB_VSB = 12 + P, PB_SIZE = 12 + P + SB_SIZE;
  static constexpr int SIZE = GLOB + P * PB_SIZE;
  static constexpr int S = 7 * P + 6;   // len(slot_table(P))
  static __device__ constexpr int pbase(int i) { return GLOB + i * PB_SIZE; }
};

static_assert(Lay<3>::SIZE == 127 && Lay<3>::S == 27, "P = 3 layout");
static_assert(Lay<4>::SIZE == 176 && Lay<4>::S == 34, "P = 4 layout");

// slot kinds, and the slot table in slot_table(P)'s order
enum Kind {
  EVAL, REFRESH, CATCHUP, KILL, REJOIN, PARTITION, HEAL, PROMOTE_SYNC,
  PROMOTE_EXPIRED, PROMOTE_ASYNC, FREEZE, UNFREEZE
};

template <int P>
struct SlotTable {
  int kind[Lay<P>::S];
  int arg[Lay<P>::S];
  __host__ __device__ constexpr SlotTable() : kind(), arg() {
    int s = 0;
    for (int i = 0; i < P; ++i) {
      kind[s] = EVAL; arg[s++] = i;
      kind[s] = REFRESH; arg[s++] = i;
      kind[s] = CATCHUP; arg[s++] = i;
    }
    for (int i = 0; i < P; ++i) { kind[s] = KILL; arg[s++] = i; }
    for (int i = 0; i < P; ++i) { kind[s] = REJOIN; arg[s++] = i; }
    for (int i = 0; i < P; ++i) {
      kind[s] = PARTITION; arg[s++] = i;
      kind[s] = HEAL; arg[s++] = i;
    }
    kind[s] = PROMOTE_SYNC; arg[s++] = 0;
    kind[s] = PROMOTE_EXPIRED; arg[s++] = 0;
    kind[s] = PROMOTE_ASYNC; arg[s++] = 0;
    kind[s] = PROMOTE_ASYNC; arg[s++] = 1;
    kind[s] = FREEZE; arg[s++] = 0;
    kind[s] = UNFREEZE; arg[s++] = 0;
  }
};

// Slot s's kind and argument, computed: K5 reads them by the thread's slot,
// and a SlotTable indexed so would live in each thread's local memory.
template <int P>
__host__ __device__ constexpr void slot_of(int s, int& kind, int& arg) {
  if (s < 3 * P) {
    kind = EVAL + s % 3;
    arg = s / 3;
  } else if (s < 5 * P) {
    kind = s < 4 * P ? KILL : REJOIN;
    arg = s % P;
  } else if (s < 7 * P) {
    kind = PARTITION + (s - 5 * P) % 2;
    arg = (s - 5 * P) / 2;
  } else {
    const int t = s - 7 * P;    // promote sync, expired, async 0 and 1, ...
    kind = t < 2 ? PROMOTE_SYNC + t : t < 4 ? PROMOTE_ASYNC : FREEZE + t - 4;
    arg = t == 3 ? 1 : 0;
  }
}

template <int P>
constexpr bool slot_of_is_the_table() {
  constexpr SlotTable<P> table{};
  for (int s = 0; s < Lay<P>::S; ++s) {
    int kind = -1, arg = -1;
    slot_of<P>(s, kind, arg);
    if (kind != table.kind[s] || arg != table.arg[s]) return false;
  }
  return true;
}

static_assert(slot_of_is_the_table<3>() && slot_of_is_the_table<4>(),
              "slot_of follows slot_table(P)'s order");

// ---------------------------------------------------------------------------
// helpers on one state (an int array in shared memory, in K5 and K6)

template <int P>
struct SB {
  int gen, iw, prim, sync, asy[P], asy_n, dep[P], dep_n, frozen;
  int p_has, p_role, p_id, p_idx, p_gen, p_exp;
};

template <int P>
__device__ __forceinline__ int clip(int x) {
  return x < 0 ? 0 : (x > P - 1 ? P - 1 : x);
}

// arr[clip(idx)]: a NONE index reads entry 0 (_at)
template <int P>
__device__ __forceinline__ int at(const int* arr, int idx) {
  return arr[clip<P>(idx)];
}

// member[x] for a possibly-NONE peer index, false for NONE (_member_at)
template <int P>
__device__ __forceinline__ bool member_at(const bool* member, int x) {
  return x >= 0 && member[clip<P>(x)];
}

// peer j appears in ids[:n] (_members)
template <int P>
__device__ __forceinline__ bool in_list(const int* ids, int n, int j) {
  bool any = false;
  for (int k = 0; k < P; ++k) any |= (k < n) && ids[k] == j;
  return any;
}

// first position of peer j in ids[:n], or NONE (_index_of)
template <int P>
__device__ __forceinline__ int index_of(const int* ids, int n, int j) {
  for (int k = 0; k < P; ++k)
    if (k < n && ids[k] == j) return k;
  return NONE;
}

// stable compaction into out (kept entries in order, NONE tail); out
// must not alias vals (_compact).  Entry m is the kept value of rank m,
// found by selects: no index is computed at run time, so out can stay in
// registers.  (Selecting a run-time index the same way in at() and
// member_at() gave wrong bits from ptxas -O1 to -O3 and right ones at
// -O0 on the H100 toolchain, PERF.md: those stay indexed, in the stack.)
template <int P>
__device__ __forceinline__ int compact(const int* vals, const bool* keep,
                                       int* out) {
  int n = 0;
#pragma unroll
  for (int m = 0; m < P; ++m) {
    int r = NONE, rank = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      r = keep[k] && rank == m ? vals[k] : r;
      rank += keep[k] ? 1 : 0;
    }
    out[m] = r;
    n = rank;
  }
  return n;
}

template <int P>
__device__ void rd_sb(const int* v, int base, SB<P>& d) {
  using L = Lay<P>;
  d.gen = v[base + L::SB_GEN];
  d.iw = v[base + L::SB_IW];
  d.prim = v[base + L::SB_PRIM];
  d.sync = v[base + L::SB_SYNC];
  for (int k = 0; k < P; ++k) d.asy[k] = v[base + L::SB_ASY + k];
  d.asy_n = v[base + L::SB_ASY_N];
  for (int k = 0; k < P; ++k) d.dep[k] = v[base + L::SB_DEP + k];
  d.dep_n = v[base + L::SB_DEP_N];
  d.frozen = v[base + L::SB_FROZEN];
  d.p_has = v[base + L::SB_P_HAS];
  d.p_role = v[base + L::SB_P_ROLE];
  d.p_id = v[base + L::SB_P_ID];
  d.p_idx = v[base + L::SB_P_IDX];
  d.p_gen = v[base + L::SB_P_GEN];
  d.p_exp = v[base + L::SB_P_EXP];
}

// write a state block in its canonical form (_pack_sb / _wr_sb)
template <int P>
__device__ void pack_sb(int* v, int base, const SB<P>& d) {
  using L = Lay<P>;
  const bool has = d.p_has != 0;
  v[base + L::SB_GEN] = d.gen;
  v[base + L::SB_IW] = d.iw;
  v[base + L::SB_PRIM] = d.prim;
  v[base + L::SB_SYNC] = d.sync;
  for (int k = 0; k < P; ++k)
    v[base + L::SB_ASY + k] = k < d.asy_n ? d.asy[k] : NONE;
  v[base + L::SB_ASY_N] = d.asy_n;
  for (int k = 0; k < P; ++k)
    v[base + L::SB_DEP + k] = k < d.dep_n ? d.dep[k] : NONE;
  v[base + L::SB_DEP_N] = d.dep_n;
  v[base + L::SB_FROZEN] = d.frozen;
  v[base + L::SB_P_HAS] = d.p_has;
  v[base + L::SB_P_ROLE] = has ? d.p_role : NONE;
  v[base + L::SB_P_ID] = has ? d.p_id : NONE;
  v[base + L::SB_P_IDX] = has ? d.p_idx : NONE;
  v[base + L::SB_P_GEN] = has ? d.p_gen : 0;
  v[base + L::SB_P_EXP] = has ? d.p_exp : 0;
}

// view := store, view actives := store actives, ver_current := 1,
// evaled := 0 (_view_sync).  Lane g of a group of G lanes that share v
// copies every G-th word (K6); one thread alone takes the defaults
template <int P>
__device__ void view_sync(int* v, int i, int g = 0, int G = 1) {
  using L = Lay<P>;
  const int b = L::pbase(i);
  for (int k = g; k < L::SB_SIZE; k += G)
    v[b + L::PB_VSB + k] = v[L::G_SB + k];
  for (int k = g; k <= P; k += G) v[b + L::PB_VACT + k] = v[L::G_ACT + k];
  if (g == 0) {
    v[b + L::PB_VERCUR] = 1;
    v[b + L::PB_EVALED] = 0;
  }
}

template <int P>
__device__ void all_stale(int* v) {
  using L = Lay<P>;
  for (int i = 0; i < P; ++i) v[L::pbase(i) + L::PB_VERCUR] = 0;
}

template <int P>
__device__ void act_remove(int* v, int i) {
  using L = Lay<P>;
  int ids[P], out[P];
  bool keep[P];
  const int n = v[L::G_ACT_N];
  for (int k = 0; k < P; ++k) {
    ids[k] = v[L::G_ACT + k];
    keep[k] = k < n && ids[k] != i;
  }
  const int nn = compact<P>(ids, keep, out);
  for (int k = 0; k < P; ++k) v[L::G_ACT + k] = out[k];
  v[L::G_ACT_N] = nn;
}

template <int P>
__device__ void act_append(int* v, int i) {
  using L = Lay<P>;
  const int n = v[L::G_ACT_N];
  if (n >= 0 && n < P) v[L::G_ACT + n] = i;   // a write at P falls off
  v[L::G_ACT_N] = n + 1;
}

// alive and not partitioned
template <int P>
__device__ __forceinline__ bool anp(const int* v, int i) {
  using L = Lay<P>;
  return v[L::pbase(i) + L::PB_ALIVE] == 1 && v[L::pbase(i) + L::PB_PART] == 0;
}

// peer i's cached version and actives equal the store's
template <int P>
__device__ bool view_current(const int* v, int i) {
  using L = Lay<P>;
  const int b = L::pbase(i);
  bool cur = v[b + L::PB_VERCUR] == 1;
  for (int k = 0; k <= P; ++k) cur &= v[b + L::PB_VACT + k] == v[L::G_ACT + k];
  return cur;
}

// ---------------------------------------------------------------------------
// the action kernels: c holds a copy of the parent and is updated in place

template <int P>
__device__ void k_rejoin(int* c, int i) {
  using L = Lay<P>;
  SB<P> st;
  rd_sb<P>(c, L::G_SB, st);
  bool keep[P];
  bool in_dep = false;
  for (int k = 0; k < P; ++k) {
    in_dep |= st.dep[k] == i && k < st.dep_n;
    keep[k] = k < st.dep_n && st.dep[k] != i;
  }
  const int iw = st.iw;
  if (in_dep) {
    int dep2[P];
    st.dep_n = compact<P>(st.dep, keep, dep2);
    for (int k = 0; k < P; ++k) st.dep[k] = dep2[k];
  }
  pack_sb<P>(c, L::G_SB, st);
  if (in_dep) all_stale<P>(c);                    // reap bumps version
  c[L::G_REJOINS] += 1;
  act_append<P>(c, i);
  const int b = L::pbase(i);
  c[b + L::PB_ALIVE] = 1;
  c[b + L::PB_PART] = 0;
  c[b + L::PB_X] = iw;
  c[b + L::PB_NOTE] = R_NONE;
  c[b + L::PB_T_HAS] = 0;
  c[b + L::PB_T_ROLE] = T_NONE;
  c[b + L::PB_T_UP] = NONE;
  c[b + L::PB_T_DOWN] = NONE;
  c[b + L::PB_T_DEP] = 0;
  view_sync<P>(c, i);
}

// operator promote request (a version-bumping store edit)
template <int P>
__device__ void k_promote(int* c, int role, int idx, bool expired) {
  using L = Lay<P>;
  SB<P> st;
  rd_sb<P>(c, L::G_SB, st);
  st.p_has = 1;
  st.p_role = role;
  st.p_id = role == PR_SYNC ? st.sync : st.asy[idx];
  st.p_idx = role == PR_SYNC ? NONE : idx;
  st.p_gen = st.gen;
  st.p_exp = expired ? 1 : 0;
  pack_sb<P>(c, L::G_SB, st);
  all_stale<P>(c);
}

template <int P>
__device__ void k_freeze(int* c, bool on) {
  using L = Lay<P>;
  SB<P> st;
  rd_sb<P>(c, L::G_SB, st);
  st.frozen = on ? 1 : 0;
  pack_sb<P>(c, L::G_SB, st);
  all_stale<P>(c);
}

// validate_transition + MCStore.apply legality bits (_write_viol)
template <int P>
__device__ int write_viol(const SB<P>& o, const SB<P>& n, bool succ) {
  if (!succ) return 0;
  const bool prim_changed = n.prim != o.prim;
  const bool same_gen = n.gen == o.gen;
  int viol = 0;
  if (n.gen < o.gen) viol |= B_GEN_BACKWARDS;
  if (n.iw < o.iw) viol |= B_IW_BACKWARDS;
  if (prim_changed && same_gen) viol |= B_NEWPRIM_SAMEGEN;
  if (prim_changed && (o.sync == NONE || n.prim != o.sync))
    viol |= B_PRIM_NOT_PREV_SYNC;
  if (!prim_changed && n.gen > o.gen && o.sync != NONE && n.sync != NONE &&
      o.sync == n.sync)
    viol |= B_BUMP_NOCHANGE;
  if (!prim_changed && same_gen &&
      (((o.sync == NONE) != (n.sync == NONE)) ||
       (o.sync != NONE && n.sync != NONE && o.sync != n.sync)))
    viol |= B_SYNC_NOBUMP;
  if (o.frozen == 1) viol |= B_FROZEN_WRITE;
  return viol;
}

// One PeerStateMachine._evaluate of peer i (eval_kernel).  Reads v, writes
// out, which must hold a copy of v on entry.  Returns the violation bits
// through viol and whether the CAS write landed through wrote.
template <int P>
__device__ void eval_peer(const int* v, int* out, int i, const int* kn,
                          int& viol, bool& wrote) {
  using L = Lay<P>;
  const int b = L::pbase(i);
  const bool part = v[b + L::PB_PART] == 1;
  const bool ver_cur = v[b + L::PB_VERCUR] == 1;
  const int x_i = v[b + L::PB_X];
  SB<P> vw;                                   // the decision snapshot
  rd_sb<P>(v, b + L::PB_VSB, vw);
  const int* vact = v + b + L::PB_VACT;
  const int vact_n = v[b + L::PB_VACT_N];
  bool member[P], asy_has[P], dep_has[P];     // liveness by this view
  for (int j = 0; j < P; ++j) {
    member[j] = in_list<P>(vact, vact_n, j);
    asy_has[j] = in_list<P>(vw.asy, vw.asy_n, j);
    dep_has[j] = in_list<P>(vw.dep, vw.dep_n, j);
  }

  // role_of(view, self): primary > sync > async > deposed > None
  const int role = vw.prim == i ? R_PRIM
                   : vw.sync == i ? R_SYNC
                   : asy_has[i] ? R_ASYNC
                   : dep_has[i] ? R_DEPOSED : R_NONE;
  if (kn[K_MUT_DEPOSED] == 1 && role == R_DEPOSED) {
    // the deposed_keeps_primary mutation returns from _evaluate before
    // _react: only the eval-epoch bookkeeping advances (:1029-1033)
    out[b + L::PB_EVALED] = 1;
    viol = 0;
    wrote = false;
    return;
  }
  const bool is_prim = role == R_PRIM, is_sync = role == R_SYNC;
  const bool frozen_eff = vw.frozen == 1 && kn[K_MUT_FREEZE] != 1;

  // alive asyncs / unassigned actives, both in view order
  bool keep[P];
  int aasy[P], unass[P];
  for (int k = 0; k < P; ++k)
    keep[k] = k < vw.asy_n && member_at<P>(member, vw.asy[k]);
  const int aasy_n = compact<P>(vw.asy, keep, aasy);
  bool role_none[P];
  for (int j = 0; j < P; ++j)
    role_none[j] = !(vw.prim == j || vw.sync == j || asy_has[j] || dep_has[j]);
  for (int k = 0; k < P; ++k)
    keep[k] = k < vact_n && member_at<P>(role_none, vact[k]);
  const int unass_n = compact<P>(vact, keep, unass);

  // ---- primary duty ladder (machine._primary_duties) ----
  const bool pr_live = vw.p_has == 1 && vw.p_role == PR_ASYNC &&
                       vw.p_gen == vw.gen && vw.p_exp == 0;
  const int p_idx = vw.p_idx;
  const bool ph_valid = pr_live && p_idx >= 0 && p_idx < vw.asy_n &&
                        at<P>(vw.asy, p_idx) == vw.p_id &&
                        member_at<P>(member, vw.p_id);
  const bool ph0_go = ph_valid && p_idx == 0 && vw.sync != NONE;
  const bool ph_swap = ph_valid && p_idx > 0;
  const bool ph_act = ph0_go || ph_swap;
  const bool sync_bad = vw.sync == NONE || !member_at<P>(member, vw.sync);
  const bool normal = is_prim && !frozen_eff && !ph_act;
  const bool w_appoint = normal && sync_bad && (aasy_n > 0 || unass_n > 0);
  const bool w_prune = normal && !sync_bad && aasy_n != vw.asy_n;
  const bool w_adopt =
      normal && !sync_bad && aasy_n == vw.asy_n && unass_n > 0;
  const bool prim_w =
      (is_prim && !frozen_eff && ph_act) || w_appoint || w_prune || w_adopt;

  SB<P> pn = vw;
  const int cand = aasy_n > 0 ? aasy[0] : unass[0];
  pn.gen = vw.gen + ((ph0_go || w_appoint) ? 1 : 0);
  pn.iw = (ph0_go || w_appoint) ? x_i : vw.iw;
  pn.sync = ph0_go ? vw.asy[0] : (w_appoint ? cand : vw.sync);
  for (int k = 0; k < P; ++k) {
    int a;
    if (ph0_go) {
      // old sync -> first async, masked to asy_n
      a = k < vw.asy_n ? (k == 0 ? vw.sync : vw.asy[k]) : NONE;
    } else if (ph_swap) {
      // asy[p_idx - 1] <-> asy[p_idx], indices clipped
      const int i1 = clip<P>(p_idx - 1), i2 = clip<P>(p_idx);
      a = k == i2 ? vw.asy[i1] : (k == i1 ? vw.asy[i2] : vw.asy[k]);
    } else if (w_appoint) {
      // roll(aasy, -1) masked to aasy_n - 1, when an alive async moves up
      a = aasy_n > 0 ? (k < aasy_n - 1 ? aasy[(k + 1) % P] : NONE) : aasy[k];
    } else if (w_prune) {
      a = aasy[k];
    } else if (w_adopt) {
      a = k < vw.asy_n ? vw.asy[k] : at<P>(unass, k - vw.asy_n);
    } else {
      a = vw.asy[k];
    }
    pn.asy[k] = a;
  }
  pn.asy_n = w_appoint ? (aasy_n > 0 ? aasy_n - 1 : aasy_n)
             : w_prune ? aasy_n
             : w_adopt ? vw.asy_n + unass_n : vw.asy_n;
  pn.p_has = ph_act ? 0 : vw.p_has;

  // ---- sync duty ladder (machine._sync_duties) ----
  const bool primary_alive = member_at<P>(member, vw.prim);
  const bool promote_me = vw.p_has == 1 && vw.p_role == PR_SYNC &&
                          vw.p_id == i && vw.p_gen == vw.gen &&
                          vw.p_exp == 0;
  const bool xlog_ok = x_i >= vw.iw || kn[K_MUT_XLOG] == 1;
  const bool w_take =
      is_sync && !frozen_eff && (promote_me || !primary_alive) && xlog_ok;
  const int new_sync = aasy_n > 0 ? aasy[0] : NONE;
  SB<P> tn;
  // the seeded-bug mutation strips the takeover's gen bump
  tn.gen = vw.gen + (kn[K_MUT_GENBUMP] == 1 ? 0 : 1);
  tn.iw = x_i;
  tn.prim = vw.sync;
  tn.sync = new_sync;
  for (int k = 0; k < P; ++k)
    keep[k] = k < vw.asy_n && (new_sync == NONE || vw.asy[k] != new_sync);
  tn.asy_n = compact<P>(vw.asy, keep, tn.asy);
  for (int k = 0; k < P; ++k)                 // a full list: the last slot
    tn.dep[k] = k == clip<P>(vw.dep_n) ? vw.prim : vw.dep[k];
  tn.dep_n = vw.dep_n + 1;
  tn.frozen = 0;                              // a takeover is a fresh dict
  tn.p_has = 0;
  tn.p_role = NONE;
  tn.p_id = NONE;
  tn.p_idx = NONE;
  tn.p_gen = 0;
  tn.p_exp = 0;

  // ---- the CAS write and its outcome ----
  const bool want_write = prim_w || w_take;
  const bool succ = want_write && !part && ver_cur;
  const bool conflict = want_write && !part && !ver_cur;
  const SB<P> nsb = is_sync ? tn : pn;
  viol = write_viol<P>(vw, nsb, succ);
  if (succ) {
    pack_sb<P>(out, L::G_SB, nsb);
    for (int j = 0; j < P; ++j)
      if (j != i) out[L::pbase(j) + L::PB_VERCUR] = 0;
    // the writer's view caches the written state
    pack_sb<P>(out, b + L::PB_VSB, nsb);
  } else if (conflict) {
    // an explicit refresh_cluster_state: the view only, not the actives
    for (int k = 0; k < L::SB_SIZE; ++k)
      out[b + L::PB_VSB + k] = v[L::G_SB + k];
  }
  if (succ || conflict) out[b + L::PB_VERCUR] = 1;
  out[b + L::PB_EVALED] = conflict ? 0 : 1;
  out[b + L::PB_NOTE] = role;

  // ---- pg target (machine._react / _pg_config_for) ----
  const int aidx = index_of<P>(vw.asy, vw.asy_n, i);
  const int async_up = aidx == 0 ? (vw.sync != NONE ? vw.sync : vw.prim)
                                 : at<P>(vw.asy, aidx - 1);
  const int async_down = aidx + 1 < vw.asy_n ? at<P>(vw.asy, aidx + 1) : NONE;
  const bool take_eff = w_take && !conflict;  // success or partition-abort
  const bool is_async = role == R_ASYNC;
  out[b + L::PB_T_HAS] = 1;
  out[b + L::PB_T_ROLE] = is_prim ? T_PRIM
                          : is_sync ? (take_eff ? T_PRIM : T_SYNC)
                          : is_async ? T_ASYNC : T_NONE;
  out[b + L::PB_T_UP] = (is_prim || (is_sync && take_eff)) ? NONE
                        : is_sync ? vw.prim
                        : is_async ? async_up : NONE;
  out[b + L::PB_T_DOWN] = is_prim ? vw.sync
                          : (is_sync && take_eff) ? new_sync
                          : is_sync ? (vw.asy_n > 0 ? vw.asy[0] : NONE)
                          : is_async ? async_down : NONE;
  out[b + L::PB_T_DEP] = role == R_DEPOSED ? 1 : 0;
  wrote = succ;
}

// (slot enabled?) in World.enabled()'s terms (enabled_mask)
template <int P>
__device__ bool slot_enabled(const int* v, int kind, int arg, const int* kn) {
  using L = Lay<P>;
  const int b = L::pbase(arg);
  const bool alive = v[b + L::PB_ALIVE] == 1;
  const bool part = v[b + L::PB_PART] == 1;
  const bool can_pr = kn[K_PROMOTE] == 1 && v[L::G_SB + L::SB_P_HAS] == 0;
  switch (kind) {
    case EVAL:
      return alive;
    case REFRESH:
      return alive && !part && !view_current<P>(v, arg);
    case CATCHUP:
      return alive && !part && v[b + L::PB_X] < v[L::G_SB + L::SB_IW];
    case KILL: {
      int n_alive = 0;
      for (int j = 0; j < P; ++j) n_alive += v[L::pbase(j) + L::PB_ALIVE];
      return v[L::G_KILLS] < kn[K_MAX_KILLS] && n_alive > 1 && alive &&
             v[b + L::PB_PART] == 0;
    }
    case REJOIN:
      return v[L::G_REJOINS] < kn[K_MAX_REJOINS] && v[b + L::PB_ALIVE] == 0;
    case PARTITION:
      return kn[K_PARTITION] == 1 && alive && !part;
    case HEAL:
      return kn[K_PARTITION] == 1 && alive && part;
    case PROMOTE_SYNC:
    case PROMOTE_EXPIRED:
      return can_pr && v[L::G_SB + L::SB_SYNC] != NONE;
    case PROMOTE_ASYNC:
      return can_pr && v[L::G_SB + L::SB_ASY_N] >= arg + 1;
    case FREEZE:
      return kn[K_FREEZE] == 1 && v[L::G_SB + L::SB_FROZEN] == 0;
    case UNFREEZE:
      return kn[K_FREEZE] == 1 && v[L::G_SB + L::SB_FROZEN] == 1;
  }
  return false;
}

// apply one slot to c (a copy of the parent p); returns its action bits
template <int P>
__device__ int apply_slot(const int* p, int* c, int kind, int arg,
                          const int* kn) {
  using L = Lay<P>;
  const int b = L::pbase(arg);
  int viol = 0;
  bool wrote;
  switch (kind) {
    case EVAL:
      eval_peer<P>(p, c, arg, kn, viol, wrote);
      break;
    case REFRESH:
      view_sync<P>(c, arg);
      break;
    case CATCHUP:
      c[b + L::PB_X] = c[L::G_SB + L::SB_IW];
      break;
    case KILL:
      c[b + L::PB_ALIVE] = 0;
      c[L::G_KILLS] += 1;
      act_remove<P>(c, arg);
      break;
    case REJOIN:
      k_rejoin<P>(c, arg);
      break;
    case PARTITION:
      c[b + L::PB_PART] = 1;
      act_remove<P>(c, arg);                  // session expires
      break;
    case HEAL:
      c[b + L::PB_PART] = 0;
      act_append<P>(c, arg);                  // new session
      view_sync<P>(c, arg);
      break;
    case PROMOTE_SYNC:
      k_promote<P>(c, PR_SYNC, 0, false);
      break;
    case PROMOTE_EXPIRED:
      k_promote<P>(c, PR_SYNC, 0, true);
      break;
    case PROMOTE_ASYNC:
      k_promote<P>(c, PR_ASYNC, arg, false);
      break;
    case FREEZE:
      k_freeze<P>(c, true);
      break;
    case UNFREEZE:
      k_freeze<P>(c, false);
      break;
  }
  return viol;
}

// xlog_behind and split_brain bits of a state (safety_mask)
template <int P>
__device__ int safety(const int* v) {
  using L = Lay<P>;
  const int prim = v[L::G_SB + L::SB_PRIM];
  const int iw = v[L::G_SB + L::SB_IW];
  const int gen = v[L::G_SB + L::SB_GEN];
  int viol = 0;
  for (int j = 0; j < P; ++j) {
    const int b = L::pbase(j);
    const bool prim_t = v[b + L::PB_ALIVE] == 1 && v[b + L::PB_PART] == 0 &&
                        v[b + L::PB_T_HAS] == 1 &&
                        v[b + L::PB_T_ROLE] == T_PRIM;
    const bool named = prim == j;
    if (prim_t && named && v[b + L::PB_X] < iw) viol |= B_XLOG_BEHIND;
    if (prim_t && !named && v[b + L::PB_VSB + L::SB_GEN] >= gen &&
        v[b + L::PB_EVALED] == 1)
      viol |= B_SPLIT_BRAIN;
  }
  return viol;
}

// the convergence predicates' bits, meaningful at a fixpoint
template <int P>
__device__ int predicates(const int* v) {
  using L = Lay<P>;
  SB<P> st;
  rd_sb<P>(v, L::G_SB, st);
  bool anpv[P], in_asy[P], in_dep[P], t_has[P];
  for (int j = 0; j < P; ++j) {
    anpv[j] = anp<P>(v, j);
    in_asy[j] = in_list<P>(st.asy, st.asy_n, j);
    in_dep[j] = in_list<P>(st.dep, st.dep_n, j);
    t_has[j] = v[L::pbase(j) + L::PB_T_HAS] == 1;
  }
  const bool prim_alive = member_at<P>(anpv, st.prim);
  const bool sync_set = st.sync != NONE;
  const bool sync_alive = member_at<P>(anpv, st.sync);
  const bool not_frozen = st.frozen == 0;
  const bool dead_prim = not_frozen && !prim_alive && sync_set && sync_alive;
  bool cand_any = false;
  for (int j = 0; j < P; ++j) {
    const bool role_deposed =
        in_dep[j] && !in_asy[j] && st.prim != j && st.sync != j;
    cand_any |= anpv[j] && st.prim != j && !role_deposed;
  }
  const bool no_sync =
      not_frozen && prim_alive && (!sync_set || !sync_alive) && cand_any;

  bool mism = false;
  for (int j = 0; j < P; ++j) {
    const int want = st.prim == j ? T_PRIM
                     : st.sync == j ? T_SYNC
                     : in_asy[j] ? T_ASYNC : T_NONE;
    mism |= anpv[j] &&
            (!t_has[j] || v[L::pbase(j) + L::PB_T_ROLE] != want);
  }
  // the applied upstream / downstream of a possibly-NONE peer
  auto up_of = [&](int j) {
    return member_at<P>(t_has, j)
               ? v[L::pbase(clip<P>(j)) + L::PB_T_UP] : NONE;
  };
  auto down_of = [&](int j) {
    return member_at<P>(t_has, j)
               ? v[L::pbase(clip<P>(j)) + L::PB_T_DOWN] : NONE;
  };
  bool chain = prim_alive && sync_set && down_of(st.prim) != st.sync;
  chain |= sync_set && sync_alive && up_of(st.sync) != st.prim;
  for (int k = 0; k < P; ++k) {
    const int a_k = st.asy[k];
    const bool live = k < st.asy_n && member_at<P>(anpv, a_k);
    const int want_up = k == 0 ? st.sync : st.asy[k - 1];
    const bool applicable = live && (k > 0 || sync_set);
    chain |= applicable && up_of(a_k) != want_up;
  }
  return (dead_prim ? B_DEAD_PRIMARY_NOT_REPLACED : 0) |
         (no_sync ? B_NO_SYNC_APPOINTED : 0) |
         (mism ? B_ROLE_MISMATCH : 0) | (chain ? B_CHAIN : 0);
}

// ---------------------------------------------------------------------------
// the kernels

// K5's shared memory: the knobs (padded to kKnobWords), the block's
// parents at pitch SIZE, then its children at an odd pitch, so that the
// slots' threads of a warp, each at the same offset of its own child,
// fall in 32 different banks (176 = 16 mod 32 would put them in two).
template <int P>
struct StepSmem {
  static constexpr int PITCH = Lay<P>::SIZE | 1;
  static constexpr int BYTES =
      4 * (kKnobWords + kStepRows * Lay<P>::SIZE
           + kStepRows * Lay<P>::S * PITCH);
};

static_assert(KNOBS <= kKnobWords && StepSmem<4>::BYTES <= 232448,
              "K5's block fits an H100 SM's shared memory");

template <int P>
__global__ void __launch_bounds__(kStepRows * Lay<P>::S)
mc_step_kernel(const int* __restrict__ vs, const int* __restrict__ knobs,
               int* __restrict__ children, int* __restrict__ viols,
               unsigned char* __restrict__ enabled, int batch) {
  using L = Lay<P>;
  constexpr int S = L::S, SIZE = L::SIZE, PITCH = StepSmem<P>::PITCH;
  constexpr int nthreads = kStepRows * S;
  extern __shared__ int smem[];
  int* kn = smem;
  int* parents = smem + kKnobWords;
  int* kids = parents + kStepRows * SIZE;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kStepRows;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(kStepRows), batch - row0));
  const int n = nrows * S * SIZE;          // the block's children, in ints

  // the parents, coalesced; then every child starts as its parent
  for (int t = tid; t < nrows * SIZE; t += nthreads)
    parents[t] = vs[row0 * SIZE + t];
  if (tid < KNOBS) kn[tid] = knobs[tid];
  __syncthreads();
  for (int t = tid; t < n; t += nthreads) {
    const int c = t / SIZE, k = t % SIZE;
    kids[c * PITCH + k] = parents[(c / S) * SIZE + k];
  }
  __syncthreads();

  // the slot's own work on its child in shared memory; a disabled slot's
  // child stays the parent, its bits 0
  const int r = tid / S, s = tid % S;
  if (r < nrows) {
    const int* p = parents + r * SIZE;
    int* c = kids + tid * PITCH;
    int kind = EVAL, arg = 0;
    slot_of<P>(s, kind, arg);
    const bool en = slot_enabled<P>(p, kind, arg, kn);
    int viol = 0;
    if (en) viol = apply_slot<P>(p, c, kind, arg, kn) | safety<P>(c);
    const long long out = row0 * S + tid;
    viols[out] = viol;
    enabled[out] = en ? 1 : 0;
  }
  __syncthreads();

  // the block's children are one contiguous range of the output: one
  // coalesced sweep, the pitch's pad skipped, in 16-byte stores from the
  // range's first 16-byte boundary on
  int* dst = children + row0 * S * SIZE;
  auto kid = [&](int t) { return kids[(t / SIZE) * PITCH + t % SIZE]; };
  const int head = min(
      n, static_cast<int>(-(reinterpret_cast<unsigned long long>(dst) >> 2)
                          & 3));
  const int quads = (n - head) / 4;
  int4* dst4 = reinterpret_cast<int4*>(dst + head);
  for (int j = tid; j < quads; j += nthreads) {
    const int t = head + 4 * j;
    dst4[j] = make_int4(kid(t), kid(t + 1), kid(t + 2), kid(t + 3));
  }
  for (int t = tid; t < head; t += nthreads) dst[t] = kid(t);
  for (int t = head + 4 * quads + tid; t < n; t += nthreads) dst[t] = kid(t);
}

// K6's shared memory: the knobs, then each row's two state buffers (the
// current state and the one an evaluation writes) at the odd pitch
// SIZE | 1, so that the lanes of a warp at one offset of their own rows
// fall in different banks.
template <int P>
struct LiveSmem {
  static constexpr int PITCH = Lay<P>::SIZE | 1;
  static constexpr int ROWS = kLiveWarps * kLiveRowsPerWarp;
  static constexpr int BYTES = 4 * (kKnobWords + 2 * ROWS * PITCH);
};

static_assert(32 % kLiveRowsPerWarp == 0 && LiveSmem<4>::BYTES <= 48 * 1024,
              "K6's rows split a warp evenly, in static shared memory");

template <int P>
__global__ void __launch_bounds__(32 * kLiveWarps)
mc_liveness_kernel(const int* __restrict__ vs, const int* __restrict__ knobs,
                   int* __restrict__ bits, int batch) {
  using L = Lay<P>;
  constexpr int SIZE = L::SIZE, PITCH = LiveSmem<P>::PITCH;
  constexpr int ROWS = LiveSmem<P>::ROWS;
  constexpr int G = 32 / kLiveRowsPerWarp;   // lanes a row
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ int kn[kKnobWords];
  __shared__ int buf[2 * ROWS * PITCH];
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(ROWS), batch - row0));

  // the block's rows, one contiguous range of vs: a coalesced sweep
  for (int x = tid; x < nrows * SIZE; x += 32 * kLiveWarps)
    buf[(x / SIZE) * PITCH + x % SIZE] = vs[row0 * SIZE + x];
  if (tid < KNOBS) kn[tid] = knobs[tid];
  __syncthreads();

  // this lane's row, and its place in the row's group of G lanes: the
  // group copies, its first lane (the leader) runs the serial work
  const int r = tid / G, g = tid % G;
  const bool leader = g == 0;
  int* v = buf + r * PITCH;
  int* t = buf + (ROWS + r) * PITCH;

  // replication catches up under a fair schedule: every alive peer
  // (partitioned included) reaches the store's initWal
  if (leader && r < nrows) {
    const int iw = v[L::G_SB + L::SB_IW];
    for (int i = 0; i < P; ++i) {
      const int b = L::pbase(i);
      if (v[b + L::PB_ALIVE] == 1 && v[b + L::PB_X] < iw) v[b + L::PB_X] = iw;
    }
  }
  __syncwarp();
  int viol = 0;
  bool done = r >= nrows;               // alike in every lane of a group
  // a row stops at done or after MAX_ROUNDS, as the vmapped while_loop
  // freezes it; the warp goes on while any of its rows does
  for (int round = 0; round < MAX_ROUNDS && __any_sync(kFull, !done);
       ++round) {
    // deliver to every alive, reachable peer, the group's lanes together
    // (view_sync writes no peer's alive or partition word)
    if (!done)
      for (int i = 0; i < P; ++i)
        if (anp<P>(v, i)) view_sync<P>(v, i, g, G);
    __syncwarp();
    bool wrote_any = false;
    for (int i = 0; i < P; ++i) {
      // read after peers < i evaluated; eval_peer needs its output to
      // hold a copy of its input: the group copies v to t, the leader
      // evaluates into t, and t becomes the state (one copy an
      // evaluation, the buffers swapping)
      const bool go = !done && anp<P>(v, i);
      if (go)
        for (int k = g; k < SIZE; k += G) t[k] = v[k];
      __syncwarp();
      if (go && leader) {
        int vi;
        bool wrote;
        eval_peer<P>(v, t, i, kn, vi, wrote);
        viol |= vi;
        wrote_any |= wrote;
      }
      __syncwarp();
      if (go) {
        int* const old = v;
        v = t;
        t = old;
      }
    }
    wrote_any = __shfl_sync(kFull, wrote_any, tid & 31 & ~(G - 1));
    if (!done) {
      bool cur = true;
      for (int i = 0; i < P; ++i)
        cur &= !anp<P>(v, i) || view_current<P>(v, i);
      done = !wrote_any && cur;
    }
    __syncwarp();                       // the group read v before the
  }                                     // leader writes it again
  if (leader && r < nrows)
    bits[row0 + r] = viol | (done ? predicates<P>(v) : B_NO_FIXPOINT);
}

// K5 over kStepRows rows a block.  A kernel that takes more than 48 KB
// of dynamic shared memory must opt in on each device it runs on (K8
// launches K5 on several): a host-side call made before every such launch,
// on the current device.
template <int P>
int launch_step(const int* vs, const int* knobs, int* children, int* viols,
                unsigned char* enabled, int batch, cudaStream_t stream) {
  constexpr int smem = StepSmem<P>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_step_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(batch) + kStepRows - 1) / kStepRows);
  mc_step_kernel<P><<<blocks, kStepRows * Lay<P>::S, smem, stream>>>(
      vs, knobs, children, viols, enabled, batch);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_liveness(const int* vs, const int* knobs, int* bits, int batch,
                    cudaStream_t stream) {
  constexpr int rows = LiveSmem<P>::ROWS;
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(batch) + rows - 1) / rows);
  mc_liveness_kernel<P><<<blocks, 32 * kLiveWarps, 0, stream>>>(
      vs, knobs, bits, batch);
  return static_cast<int>(cudaGetLastError());
}

// Runs launch() with `device` current and makes the caller's device current
// again on every return path, so that a process driving several cards keeps
// its own current device across a launch.  Returns launch()'s cudaError_t,
// or the error of getting or setting the device.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const int rc = launch();
  if (prev != device && (err = cudaSetDevice(prev)) != cudaSuccess && rc == 0)
    return static_cast<int>(err);
  return rc;
}

}  // namespace

// Launches K5 on `stream` (a cudaStream_t) of `device` over `batch` >= 1
// states of `peers` (3 or 4) peers: vs (batch, SIZE) int32, knobs (9,)
// int32, children (batch, S, SIZE) int32, viols (batch, S) int32,
// enabled (batch, S) bool, all contiguous device buffers.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for another peer
// count); it does not synchronise.
extern "C" int mc_step_launch(const int* vs, const int* knobs, int* children,
                              int* viols, unsigned char* enabled, int batch,
                              int peers, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (peers == 3)
      return launch_step<3>(vs, knobs, children, viols, enabled, batch, s);
    if (peers == 4)
      return launch_step<4>(vs, knobs, children, viols, enabled, batch, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// Launches K6 likewise: vs (batch, SIZE) int32, knobs (9,) int32, bits
// (batch,) int32.
extern "C" int mc_liveness_launch(const int* vs, const int* knobs, int* bits,
                                  int batch, int peers, int device,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (peers == 3) return launch_liveness<3>(vs, knobs, bits, batch, s);
    if (peers == 4) return launch_liveness<4>(vs, knobs, bits, batch, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

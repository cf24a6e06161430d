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
// bound by its serial per-row work (up to 30 rounds of P evaluations).
//
// Design (right and simple first; these are exact int32 results, one
// differing element is a wrong answer):
// * K5: one thread per (row, slot), R rows per block.  The block stages
//   its R parents in shared memory (<= 704 bytes a row); each thread
//   copies its parent into a local array, applies its slot through a
//   switch on the slot kind, computes safety_mask on the child, and
//   writes child, viol and enabled.  A disabled slot writes the PARENT
//   as its child and 0 as its viol (:1221-1222).
// * K6: one thread per row on a local copy.  A vmapped lax.while_loop
//   freezes a row once its own condition is false, so the thread's loop
//   stops at `done` or after 30 rounds; within a round, peer i's
//   alive-and-reachable bit is read after peers < i were synced and
//   evaluated (:1097-1105).  It reuses K5's eval.
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
constexpr int kStepRows = 4;        // K5: rows per block
constexpr int kLiveThreads = 64;    // K6: rows (threads) per block

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

// ---------------------------------------------------------------------------
// helpers on one state (a local int array)

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
// must not alias vals (_compact)
template <int P>
__device__ __forceinline__ int compact(const int* vals, const bool* keep,
                                       int* out) {
  int n = 0;
  for (int k = 0; k < P; ++k)
    if (keep[k]) out[n++] = vals[k];
  for (int k = n; k < P; ++k) out[k] = NONE;
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
// evaled := 0 (_view_sync)
template <int P>
__device__ void view_sync(int* v, int i) {
  using L = Lay<P>;
  const int b = L::pbase(i);
  for (int k = 0; k < L::SB_SIZE; ++k) v[b + L::PB_VSB + k] = v[L::G_SB + k];
  for (int k = 0; k <= P; ++k) v[b + L::PB_VACT + k] = v[L::G_ACT + k];
  v[b + L::PB_VERCUR] = 1;
  v[b + L::PB_EVALED] = 0;
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
  for (int k = 0; k < P; ++k) tn.dep[k] = vw.dep[k];
  tn.dep[clip<P>(vw.dep_n)] = vw.prim;        // a full list: the last slot
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
  const SB<P>& nsb = is_sync ? tn : pn;
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

template <int P>
__global__ void __launch_bounds__(kStepRows * Lay<P>::S)
mc_step_kernel(const int* __restrict__ vs, const int* __restrict__ knobs,
               int* __restrict__ children, int* __restrict__ viols,
               unsigned char* __restrict__ enabled, int batch) {
  using L = Lay<P>;
  constexpr int S = L::S, SIZE = L::SIZE;
  constexpr SlotTable<P> table{};
  __shared__ int parents[kStepRows * SIZE];
  __shared__ int kn[KNOBS];
  const long long row0 = static_cast<long long>(blockIdx.x) * kStepRows;
  const int nrows = static_cast<int>(
      min(static_cast<long long>(kStepRows), batch - row0));
  for (int t = threadIdx.x; t < nrows * SIZE; t += blockDim.x)
    parents[t] = vs[row0 * SIZE + t];
  if (threadIdx.x < KNOBS) kn[threadIdx.x] = knobs[threadIdx.x];
  __syncthreads();
  const int r = threadIdx.x / S, s = threadIdx.x % S;
  if (r >= nrows) return;
  const int* p = parents + r * SIZE;
  int c[SIZE];
  for (int k = 0; k < SIZE; ++k) c[k] = p[k];
  const int kind = table.kind[s], arg = table.arg[s];
  const bool en = slot_enabled<P>(p, kind, arg, kn);
  int viol = 0;
  if (en) viol = apply_slot<P>(p, c, kind, arg, kn) | safety<P>(c);
  // a disabled slot's child is the parent, its bits 0
  const long long out = (row0 + r) * S + s;
  int* child = children + out * SIZE;
  for (int k = 0; k < SIZE; ++k) child[k] = c[k];
  viols[out] = viol;
  enabled[out] = en ? 1 : 0;
}

template <int P>
__global__ void __launch_bounds__(kLiveThreads)
mc_liveness_kernel(const int* __restrict__ vs, const int* __restrict__ knobs,
                   int* __restrict__ bits, int batch) {
  using L = Lay<P>;
  constexpr int SIZE = L::SIZE;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= batch) return;
  int kn[KNOBS];
  for (int k = 0; k < KNOBS; ++k) kn[k] = knobs[k];
  int v[SIZE], t[SIZE];
  for (int k = 0; k < SIZE; ++k) v[k] = vs[row * SIZE + k];

  // replication catches up under a fair schedule: every alive peer
  // (partitioned included) reaches the store's initWal
  const int iw = v[L::G_SB + L::SB_IW];
  for (int i = 0; i < P; ++i) {
    const int b = L::pbase(i);
    if (v[b + L::PB_ALIVE] == 1 && v[b + L::PB_X] < iw) v[b + L::PB_X] = iw;
  }
  int viol = 0;
  bool done = false;
  for (int r = 0; r < MAX_ROUNDS && !done; ++r) {
    for (int i = 0; i < P; ++i)
      if (anp<P>(v, i)) view_sync<P>(v, i);
    bool wrote_any = false;
    for (int i = 0; i < P; ++i) {
      if (!anp<P>(v, i)) continue;    // read after peers < i evaluated
      for (int k = 0; k < SIZE; ++k) t[k] = v[k];
      int vi;
      bool wrote;
      eval_peer<P>(v, t, i, kn, vi, wrote);
      for (int k = 0; k < SIZE; ++k) v[k] = t[k];
      viol |= vi;
      wrote_any |= wrote;
    }
    bool cur = true;
    for (int i = 0; i < P; ++i) cur &= !anp<P>(v, i) || view_current<P>(v, i);
    done = !wrote_any && cur;
  }
  bits[row] = viol | (done ? predicates<P>(v) : B_NO_FIXPOINT);
}

template <int P>
int launch_step(const int* vs, const int* knobs, int* children, int* viols,
                unsigned char* enabled, int batch, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(batch) + kStepRows - 1) / kStepRows);
  mc_step_kernel<P><<<blocks, kStepRows * Lay<P>::S, 0, stream>>>(
      vs, knobs, children, viols, enabled, batch);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_liveness(const int* vs, const int* knobs, int* bits, int batch,
                    cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(batch) + kLiveThreads - 1) / kLiveThreads);
  mc_liveness_kernel<P><<<blocks, kLiveThreads, 0, stream>>>(
      vs, knobs, bits, batch);
  return static_cast<int>(cudaGetLastError());
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (peers == 3)
    return launch_step<3>(vs, knobs, children, viols, enabled, batch, s);
  if (peers == 4)
    return launch_step<4>(vs, knobs, children, viols, enabled, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches K6 likewise: vs (batch, SIZE) int32, knobs (9,) int32, bits
// (batch,) int32.
extern "C" int mc_liveness_launch(const int* vs, const int* knobs, int* bits,
                                  int batch, int peers, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (peers == 3) return launch_liveness<3>(vs, knobs, bits, batch, s);
  if (peers == 4) return launch_liveness<4>(vs, knobs, bits, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

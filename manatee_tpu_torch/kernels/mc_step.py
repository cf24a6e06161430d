"""K5 and K6: the model checker's frontier step and liveness check — the
CUDA kernels' wrappers and their plain PyTorch versions.

``mc_step`` launches ``csrc/mc_array.cu``'s step kernel (which replaces
manatee_tpu/state/mc_array.py::build_step -> _step_one, :1212-1236,
with enabled_mask :768, the action kernels :671-743, eval_kernel :846,
_write_viol :1036 and safety_mask :806); ``mc_liveness`` launches its
liveness kernel (build_liveness -> liveness_kernel, :1068-1175,
:1239-1245).  Both take CUDA tensors only and raise on anything else.

``step_plain`` and ``liveness_plain`` compute the same functions as
natively batched ``(B, SIZE)`` int32 torch operations, peer and slot
indices static: the CPU path and the tests use them, and on the card
they are the yardstick the kernels are held to, equal element for
element.  Every state-block write goes through ``_pack_sb``'s canonical
form (NONE-padded tails, promote fields zeroed when absent): byte-level
dedup depends on it.
"""

from __future__ import annotations

import ctypes

import torch

from manatee_tpu_torch.kernels import nvcc
from manatee_tpu_torch.kernels.mlp_forward import check_inputs
from manatee_tpu_torch.state.canon import CATEGORY_BIT as _BIT
from manatee_tpu_torch.state.mc_array import (
    K_FREEZE,
    K_MAX_KILLS,
    K_MAX_REJOINS,
    K_MUT_DEPOSED,
    K_MUT_FREEZE,
    K_MUT_GENBUMP,
    K_MUT_XLOG,
    K_PARTITION,
    K_PROMOTE,
    KNOBS,
    NONE,
    PR_ASYNC,
    PR_SYNC,
    R_ASYNC,
    R_DEPOSED,
    R_NONE,
    R_PRIM,
    R_SYNC,
    T_ASYNC,
    T_NONE,
    T_PRIM,
    T_SYNC,
    Layout,
    slot_table,
)

PEERS = (3, 4)              # the peer counts the kernels are built for
MAX_ROUNDS = 30             # the fair schedule's bound (liveness_kernel)
_MAX_ROWS = 2**31 - 1        # the kernels' row count is a C int

# ---------------------------------------------------------------------------
# batched helpers: v is (B, SIZE) int32, a state block's scalars are (B,)
# and its lists (B, P)


def _w(cond, a, b):
    """torch.where with int32 results and python-int branches allowed."""
    return torch.where(cond, torch.as_tensor(a, dtype=torch.int32,
                                             device=cond.device),
                       torch.as_tensor(b, dtype=torch.int32,
                                       device=cond.device))


def _mask_tail(arr, n):
    pos = torch.arange(arr.shape[1], device=arr.device)
    return _w(pos[None, :] < n[:, None], arr, NONE)


def _compact(vals, keep):
    """Stable compaction: kept entries first in their order, NONE tail;
    returns (vals', n)."""
    P = vals.shape[1]
    pos = torch.arange(P, device=vals.device)
    order = torch.argsort(torch.where(keep, pos, P + pos), dim=1)
    n = keep.sum(1, dtype=torch.int32)
    out = _w(pos[None, :] < n[:, None], torch.gather(vals, 1, order), NONE)
    return out, n


def _members(ids, n):
    """(B, P) bool: peer j appears in ids[:n]."""
    P = ids.shape[1]
    pos = torch.arange(P, device=ids.device)
    valid = pos[None, :] < n[:, None]
    return ((ids[:, None, :] == pos[None, :, None])
            & valid[:, None, :]).any(2)


def _index_of(ids, n, j):
    """Position of peer j in ids[:n] (first match), or NONE."""
    pos = torch.arange(ids.shape[1], device=ids.device)
    eq = (ids == j) & (pos[None, :] < n[:, None])
    return _w(eq.any(1), eq.to(torch.int32).argmax(1).to(torch.int32), NONE)


def _at(arr, idx):
    """arr[b, clip(idx[b])] — a NONE index reads entry 0."""
    P = arr.shape[1]
    i = idx.clamp(0, P - 1).long()
    if i.dim() == 1:
        return torch.gather(arr, 1, i[:, None])[:, 0]
    return torch.gather(arr, 1, i)


def _member_at(member, x):
    """member[b, x[b]] for a possibly-NONE peer index, false for NONE."""
    return (x >= 0) & _at(member, x)


_SB_FIELDS = ("gen", "iw", "prim", "sync", "asy", "asy_n", "dep", "dep_n",
              "frozen", "p_has", "p_role", "p_id", "p_idx", "p_gen",
              "p_exp")


def _rd_sb(L, v, base):
    P = L.P
    return {
        "gen": v[:, base + L.SB_GEN], "iw": v[:, base + L.SB_IW],
        "prim": v[:, base + L.SB_PRIM], "sync": v[:, base + L.SB_SYNC],
        "asy": v[:, base + L.SB_ASY:base + L.SB_ASY + P],
        "asy_n": v[:, base + L.SB_ASY_N],
        "dep": v[:, base + L.SB_DEP:base + L.SB_DEP + P],
        "dep_n": v[:, base + L.SB_DEP_N],
        "frozen": v[:, base + L.SB_FROZEN],
        "p_has": v[:, base + L.SB_P_HAS], "p_role": v[:, base + L.SB_P_ROLE],
        "p_id": v[:, base + L.SB_P_ID], "p_idx": v[:, base + L.SB_P_IDX],
        "p_gen": v[:, base + L.SB_P_GEN], "p_exp": v[:, base + L.SB_P_EXP],
    }


def _pack_sb(L, d):
    """A state block in its canonical form, (B, SB_SIZE) int32."""
    has = d["p_has"] != 0
    one = lambda x: x.to(torch.int32)[:, None]  # noqa: E731
    return torch.cat([
        one(d["gen"]), one(d["iw"]), one(d["prim"]), one(d["sync"]),
        _mask_tail(d["asy"], d["asy_n"]), one(d["asy_n"]),
        _mask_tail(d["dep"], d["dep_n"]), one(d["dep_n"]),
        one(d["frozen"]), one(d["p_has"]),
        one(_w(has, d["p_role"], NONE)), one(_w(has, d["p_id"], NONE)),
        one(_w(has, d["p_idx"], NONE)), one(_w(has, d["p_gen"], 0)),
        one(_w(has, d["p_exp"], 0)),
    ], dim=1)


def _wr_sb(L, v, base, d):
    v[:, base:base + L.SB_SIZE] = _pack_sb(L, d)


def _peer(L, v, i, off):
    return v[:, L.pbase(i) + off]


def _sact(L, v):
    return v[:, L.G_ACT:L.G_ACT + L.P], v[:, L.G_ACT_N]


def _vact(L, v, i):
    b = L.pbase(i)
    return v[:, b + L.PB_VACT:b + L.PB_VACT + L.P], v[:, b + L.PB_VACT_N]


def _view_sync(L, v, i):
    """In place: view := store, view actives := store actives,
    ver_current := 1, evaled := 0."""
    b = L.pbase(i)
    v[:, b + L.PB_VSB:b + L.PB_VSB + L.SB_SIZE] = \
        v[:, L.G_SB:L.G_SB + L.SB_SIZE]
    v[:, b + L.PB_VACT:b + L.PB_VACT + L.P + 1] = \
        v[:, L.G_ACT:L.G_ACT + L.P + 1]
    v[:, b + L.PB_VERCUR] = 1
    v[:, b + L.PB_EVALED] = 0


def _all_stale(L, v, rows=None):
    """In place: every peer's cached version goes stale (on *rows*, a
    (B,) bool, or everywhere)."""
    for i in range(L.P):
        c = L.pbase(i) + L.PB_VERCUR
        v[:, c] = 0 if rows is None else _w(rows, 0, v[:, c])


def _act_remove(L, v, i):
    ids, n = _sact(L, v)
    pos = torch.arange(L.P, device=v.device)
    out, nn = _compact(ids, (pos[None, :] < n[:, None]) & (ids != i))
    v[:, L.G_ACT:L.G_ACT + L.P] = out
    v[:, L.G_ACT_N] = nn


def _act_append(L, v, i):
    ids, n = _sact(L, v)
    pos = torch.arange(L.P, device=v.device)
    # a write at n == P falls off the end, as JAX's .at[n].set drops it
    v[:, L.G_ACT:L.G_ACT + L.P] = _w(pos[None, :] == n[:, None], i, ids)
    v[:, L.G_ACT_N] = n + 1


# -- the action kernels: each returns a new (B, SIZE) tensor --------------


def _k_refresh(L, v, i):
    v = v.clone()
    _view_sync(L, v, i)
    return v


def _k_catchup(L, v, i):
    v = v.clone()
    v[:, L.pbase(i) + L.PB_X] = v[:, L.G_SB + L.SB_IW]
    return v


def _k_kill(L, v, i):
    v = v.clone()
    v[:, L.pbase(i) + L.PB_ALIVE] = 0
    v[:, L.G_KILLS] += 1
    _act_remove(L, v, i)
    return v


def _k_rejoin(L, v, i):
    """The crashed peer returns rebuilt: operator reap of its deposed
    entry (a version-bumping store edit) and a fresh machine at the
    current initWal."""
    st = _rd_sb(L, v, L.G_SB)
    pos = torch.arange(L.P, device=v.device)
    live = pos[None, :] < st["dep_n"][:, None]
    in_dep = ((st["dep"] == i) & live).any(1)
    dep2, dep2_n = _compact(st["dep"], live & (st["dep"] != i))
    st2 = dict(st)
    st2["dep"] = _w(in_dep[:, None], dep2, st["dep"])
    st2["dep_n"] = _w(in_dep, dep2_n, st["dep_n"])
    iw = st["iw"].clone()
    v = v.clone()
    _wr_sb(L, v, L.G_SB, st2)
    _all_stale(L, v, in_dep)                        # reap bumps version
    v[:, L.G_REJOINS] += 1
    _act_append(L, v, i)
    b = L.pbase(i)
    v[:, b + L.PB_ALIVE] = 1
    v[:, b + L.PB_PART] = 0
    v[:, b + L.PB_X] = iw
    v[:, b + L.PB_NOTE] = R_NONE
    v[:, b + L.PB_T_HAS:b + L.PB_T_DEP + 1] = torch.tensor(
        [0, T_NONE, NONE, NONE, 0], dtype=torch.int32, device=v.device)
    _view_sync(L, v, i)
    return v


def _k_partition(L, v, i):
    v = v.clone()
    v[:, L.pbase(i) + L.PB_PART] = 1
    _act_remove(L, v, i)                            # session expires
    return v


def _k_heal(L, v, i):
    v = v.clone()
    v[:, L.pbase(i) + L.PB_PART] = 0
    _act_append(L, v, i)                            # new session
    _view_sync(L, v, i)
    return v


def _k_promote(L, v, role, idx, expired):
    """Operator promote request (a version-bumping store edit)."""
    st = _rd_sb(L, v, L.G_SB)
    st2 = dict(st)
    B = v.shape[0]
    full = lambda x: torch.full((B,), x, dtype=torch.int32,  # noqa: E731
                                device=v.device)
    st2["p_has"] = full(1)
    st2["p_role"] = full(role)
    st2["p_id"] = st["sync"] if role == PR_SYNC else st["asy"][:, idx]
    st2["p_idx"] = full(NONE if role == PR_SYNC else idx)
    st2["p_gen"] = st["gen"]
    st2["p_exp"] = full(1 if expired else 0)
    v = v.clone()
    _wr_sb(L, v, L.G_SB, st2)
    _all_stale(L, v)
    return v


def _k_freeze(L, v, on):
    st = _rd_sb(L, v, L.G_SB)
    st2 = dict(st)
    st2["frozen"] = torch.full_like(st["frozen"], 1 if on else 0)
    v = v.clone()
    _wr_sb(L, v, L.G_SB, st2)
    _all_stale(L, v)
    return v


# -- enabled slots, safety --------------------------------------------------


def enabled_plain(L, v, kn):
    """(B, S) bool in slot order, mirroring World.enabled()."""
    st = _rd_sb(L, v, L.G_SB)
    sact, sact_n = _sact(L, v)
    alive = [_peer(L, v, i, L.PB_ALIVE) == 1 for i in range(L.P)]
    part = [_peer(L, v, i, L.PB_PART) == 1 for i in range(L.P)]
    n_alive = sum(_peer(L, v, i, L.PB_ALIVE) for i in range(L.P))
    bits = []
    for i in range(L.P):
        vact, vact_n = _vact(L, v, i)
        cur = ((_peer(L, v, i, L.PB_VERCUR) == 1)
               & (vact == sact).all(1) & (vact_n == sact_n))
        bits += [alive[i], alive[i] & ~part[i] & ~cur,
                 alive[i] & ~part[i] & (_peer(L, v, i, L.PB_X) < st["iw"])]
    for i in range(L.P):
        bits.append((v[:, L.G_KILLS] < kn[K_MAX_KILLS]) & (n_alive > 1)
                    & alive[i] & (_peer(L, v, i, L.PB_PART) == 0))
    for i in range(L.P):
        bits.append((v[:, L.G_REJOINS] < kn[K_MAX_REJOINS])
                    & (_peer(L, v, i, L.PB_ALIVE) == 0))
    allow = kn[K_PARTITION] == 1
    for i in range(L.P):
        bits += [allow & alive[i] & ~part[i], allow & alive[i] & part[i]]
    can_pr = (kn[K_PROMOTE] == 1) & (st["p_has"] == 0)
    has_sync = st["sync"] != NONE
    bits += [can_pr & has_sync, can_pr & has_sync,
             can_pr & (st["asy_n"] >= 1), can_pr & (st["asy_n"] >= 2)]
    allow_f = kn[K_FREEZE] == 1
    bits += [allow_f & (st["frozen"] == 0), allow_f & (st["frozen"] == 1)]
    return torch.stack(bits, dim=1)


def safety_plain(L, v):
    """(B,) int32: the xlog_behind and split_brain bits of a state."""
    st = _rd_sb(L, v, L.G_SB)
    viol = torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
    for j in range(L.P):
        prim_t = ((_peer(L, v, j, L.PB_ALIVE) == 1)
                  & (_peer(L, v, j, L.PB_PART) == 0)
                  & (_peer(L, v, j, L.PB_T_HAS) == 1)
                  & (_peer(L, v, j, L.PB_T_ROLE) == T_PRIM))
        named = st["prim"] == j
        xlog_bad = prim_t & named & (_peer(L, v, j, L.PB_X) < st["iw"])
        view_gen = v[:, L.pbase(j) + L.PB_VSB + L.SB_GEN]
        split = (prim_t & ~named & (view_gen >= st["gen"])
                 & (_peer(L, v, j, L.PB_EVALED) == 1))
        viol = viol | _w(xlog_bad, _BIT["xlog_behind"], 0) \
            | _w(split, _BIT["split_brain"], 0)
    return viol


# -- peer evaluation ----------------------------------------------------------


def _write_viol(old, new, succ):
    """validate_transition + MCStore.apply legality bits of a successful
    CAS write by a peer."""
    gen_back = new["gen"] < old["gen"]
    iw_back = new["iw"] < old["iw"]
    prim_changed = new["prim"] != old["prim"]
    same_gen = new["gen"] == old["gen"]
    npsg = prim_changed & same_gen
    pnps = prim_changed & ((old["sync"] == NONE)
                           | (new["prim"] != old["sync"]))
    bump_nc = (~prim_changed & (new["gen"] > old["gen"])
               & (old["sync"] != NONE) & (new["sync"] != NONE)
               & (old["sync"] == new["sync"]))
    sync_nb = (~prim_changed & same_gen
               & (((old["sync"] == NONE) != (new["sync"] == NONE))
                  | ((old["sync"] != NONE) & (new["sync"] != NONE)
                     & (old["sync"] != new["sync"]))))
    frozen_w = old["frozen"] == 1
    viol = torch.zeros_like(succ, dtype=torch.int32)
    for cond, name in ((gen_back, "gen_backwards"),
                       (iw_back, "iw_backwards"),
                       (npsg, "newprim_samegen"),
                       (pnps, "prim_not_prev_sync"),
                       (bump_nc, "bump_nochange"),
                       (sync_nb, "sync_nobump"),
                       (frozen_w, "frozen_write")):
        viol = viol | _w(succ & cond, _BIT[name], 0)
    return viol


def eval_plain(L, v, i, kn):
    """One PeerStateMachine._evaluate of peer *i* (static) on every row:
    role notification, pg-target selection, the primary/sync duty
    ladder, the CAS write and its outcome, the write-legality bits.
    Returns (v', violation bits, wrote)."""
    P, b = L.P, L.pbase(i)
    pos = torch.arange(P, device=v.device, dtype=torch.int32)
    part = _peer(L, v, i, L.PB_PART) == 1
    ver_cur = _peer(L, v, i, L.PB_VERCUR) == 1
    x_i = _peer(L, v, i, L.PB_X)
    vw = _rd_sb(L, v, b + L.PB_VSB)           # the decision snapshot
    vact, vact_n = _vact(L, v, i)
    member = _members(vact, vact_n)           # liveness by this view
    asy, asy_n = vw["asy"], vw["asy_n"]
    asy_live = pos[None, :] < asy_n[:, None]

    # role_of(view, self): primary > sync > async > deposed > None
    asy_has = _members(asy, asy_n)
    dep_has = _members(vw["dep"], vw["dep_n"])
    role = _w(vw["prim"] == i, R_PRIM,
              _w(vw["sync"] == i, R_SYNC,
                 _w(asy_has[:, i], R_ASYNC,
                    _w(dep_has[:, i], R_DEPOSED, R_NONE))))
    is_prim, is_sync = role == R_PRIM, role == R_SYNC
    frozen_eff = (vw["frozen"] == 1) & (kn[K_MUT_FREEZE] != 1)

    # alive asyncs / unassigned actives, both in view order
    aasy, aasy_n = _compact(asy, asy_live & _member_at(member, asy))
    role_none = ~((vw["prim"][:, None] == pos) | (vw["sync"][:, None] == pos)
                  | asy_has | dep_has)
    unass, unass_n = _compact(
        vact, (pos[None, :] < vact_n[:, None]) & _member_at(role_none, vact))

    # ---- primary duty ladder (machine._primary_duties) ----
    pr_live = ((vw["p_has"] == 1) & (vw["p_role"] == PR_ASYNC)
               & (vw["p_gen"] == vw["gen"]) & (vw["p_exp"] == 0))
    p_idx = vw["p_idx"]
    ph_valid = (pr_live & (p_idx >= 0) & (p_idx < asy_n)
                & (_at(asy, p_idx) == vw["p_id"])
                & _member_at(member, vw["p_id"]))
    ph0_go = ph_valid & (p_idx == 0) & (vw["sync"] != NONE)
    ph_swap = ph_valid & (p_idx > 0)
    ph_act = ph0_go | ph_swap
    sync_bad = (vw["sync"] == NONE) | ~_member_at(member, vw["sync"])
    normal = is_prim & ~frozen_eff & ~ph_act
    w_appoint = normal & sync_bad & ((aasy_n > 0) | (unass_n > 0))
    w_prune = normal & ~sync_bad & (aasy_n != asy_n)
    w_adopt = normal & ~sync_bad & (aasy_n == asy_n) & (unass_n > 0)
    prim_w = (is_prim & ~frozen_eff & ph_act) | w_appoint | w_prune \
        | w_adopt

    # the candidate sync and each branch's async list
    cand = _w(aasy_n > 0, aasy[:, 0], unass[:, 0])
    app_asy = _w((aasy_n > 0)[:, None],
                 _mask_tail(torch.roll(aasy, -1, dims=1), aasy_n - 1), aasy)
    app_n = _w(aasy_n > 0, aasy_n - 1, aasy_n)
    ph0_asy = _mask_tail(torch.cat([vw["sync"][:, None], asy[:, 1:]], 1),
                         asy_n)
    i1 = (p_idx - 1).clamp(0, P - 1).long()[:, None]
    i2 = p_idx.clamp(0, P - 1).long()[:, None]
    swp = asy.clone()
    swp.scatter_(1, i1, torch.gather(asy, 1, i2))
    swp.scatter_(1, i2, torch.gather(asy, 1, i1))
    adopt_asy = _w(asy_live, asy, _at(unass, pos[None, :] - asy_n[:, None]))

    col = lambda m: m[:, None]  # noqa: E731
    prim_new = dict(vw)
    prim_new["gen"] = vw["gen"] + (ph0_go | w_appoint).to(torch.int32)
    prim_new["iw"] = _w(ph0_go | w_appoint, x_i, vw["iw"])
    prim_new["sync"] = _w(ph0_go, asy[:, 0], _w(w_appoint, cand, vw["sync"]))
    prim_new["asy"] = _w(col(ph0_go), ph0_asy,
                         _w(col(ph_swap), swp,
                            _w(col(w_appoint), app_asy,
                               _w(col(w_prune), aasy,
                                  _w(col(w_adopt), adopt_asy, asy)))))
    prim_new["asy_n"] = _w(w_appoint, app_n,
                           _w(w_prune, aasy_n,
                              _w(w_adopt, asy_n + unass_n, asy_n)))
    prim_new["p_has"] = _w(ph_act, 0, vw["p_has"])

    # ---- sync duty ladder (machine._sync_duties) ----
    primary_alive = _member_at(member, vw["prim"])
    promote_me = ((vw["p_has"] == 1) & (vw["p_role"] == PR_SYNC)
                  & (vw["p_id"] == i) & (vw["p_gen"] == vw["gen"])
                  & (vw["p_exp"] == 0))
    xlog_ok = (x_i >= vw["iw"]) | (kn[K_MUT_XLOG] == 1)
    w_take = (is_sync & ~frozen_eff & (promote_me | ~primary_alive)
              & xlog_ok)
    new_sync = _w(aasy_n > 0, aasy[:, 0], NONE)
    tasy, tasy_n = _compact(asy, asy_live & ((new_sync == NONE)[:, None]
                                             | (asy != new_sync[:, None])))
    dep_full = vw["dep"].clone()
    dep_full.scatter_(1, vw["dep_n"].clamp(0, P - 1).long()[:, None],
                      vw["prim"][:, None])
    zero = torch.zeros_like(vw["gen"])
    take_new = {
        # the seeded-bug mutation strips the takeover's gen bump
        "gen": vw["gen"] + (0 if kn[K_MUT_GENBUMP] == 1 else 1),
        "iw": x_i, "prim": vw["sync"], "sync": new_sync,
        "asy": tasy, "asy_n": tasy_n,
        "dep": dep_full, "dep_n": vw["dep_n"] + 1,
        "frozen": zero,                       # a takeover is a fresh dict
        "p_has": zero, "p_role": zero + NONE, "p_id": zero + NONE,
        "p_idx": zero + NONE, "p_gen": zero, "p_exp": zero,
    }

    # ---- the CAS write and its outcome ----
    want_write = prim_w | w_take
    succ = want_write & ~part & ver_cur
    conflict = want_write & ~part & ~ver_cur
    new_sb = {k: _w(col(is_sync) if take_new[k].dim() == 2 else is_sync,
                    take_new[k], prim_new[k]) for k in _SB_FIELDS}
    viol = _write_viol(vw, new_sb, succ)

    packed = _pack_sb(L, new_sb)
    store = v[:, L.G_SB:L.G_SB + L.SB_SIZE]
    out = v.clone()
    out[:, L.G_SB:L.G_SB + L.SB_SIZE] = _w(col(succ), packed, store)
    for j in range(P):
        if j != i:
            c = L.pbase(j) + L.PB_VERCUR
            out[:, c] = _w(succ, 0, v[:, c])
    out[:, b + L.PB_VERCUR] = _w(succ | conflict, 1, v[:, b + L.PB_VERCUR])
    # writer's view: success caches the written state; a conflict does an
    # explicit refresh_cluster_state (view only, not the actives)
    view = v[:, b + L.PB_VSB:b + L.PB_VSB + L.SB_SIZE]
    out[:, b + L.PB_VSB:b + L.PB_VSB + L.SB_SIZE] = _w(
        col(succ), packed, _w(col(conflict), store, view))
    out[:, b + L.PB_EVALED] = _w(conflict, 0, 1)
    out[:, b + L.PB_NOTE] = role

    # ---- pg target (machine._react / _pg_config_for) ----
    aidx = _index_of(asy, asy_n, i)
    async_up = _w(aidx == 0, _w(vw["sync"] != NONE, vw["sync"], vw["prim"]),
                  _at(asy, aidx - 1))
    async_down = _w(aidx + 1 < asy_n, _at(asy, aidx + 1), NONE)
    take_eff = w_take & ~conflict          # success or partition-abort
    is_async = role == R_ASYNC
    t_role = _w(is_prim, T_PRIM,
                _w(is_sync, _w(take_eff, T_PRIM, T_SYNC),
                   _w(is_async, T_ASYNC, T_NONE)))
    t_up = _w(is_prim | (is_sync & take_eff), NONE,
              _w(is_sync, vw["prim"], _w(is_async, async_up, NONE)))
    t_down = _w(is_prim, vw["sync"],
                _w(is_sync & take_eff, new_sync,
                   _w(is_sync, _w(asy_n > 0, asy[:, 0], NONE),
                      _w(is_async, async_down, NONE))))
    t_dep = _w(role == R_DEPOSED, 1, 0)
    out[:, b + L.PB_T_HAS] = 1
    out[:, b + L.PB_T_ROLE] = t_role
    out[:, b + L.PB_T_UP] = t_up
    out[:, b + L.PB_T_DOWN] = t_down
    out[:, b + L.PB_T_DEP] = t_dep

    # the deposed_keeps_primary mutation returns from _evaluate before
    # _react: only the explorer's eval-epoch bookkeeping advances
    if kn[K_MUT_DEPOSED] == 1:
        mut_dep = role == R_DEPOSED
        noop = v.clone()
        noop[:, b + L.PB_EVALED] = 1
        return (_w(col(mut_dep), noop, out), _w(mut_dep, 0, viol),
                succ & ~mut_dep)
    return out, viol, succ


# -- one frontier step --------------------------------------------------------


def _apply_slot(L, v, slot, kn):
    kind = slot[0]
    if kind == "eval":
        v2, viol, _ = eval_plain(L, v, slot[1], kn)
        return v2, viol
    z = torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
    if kind == "refresh":
        return _k_refresh(L, v, slot[1]), z
    if kind == "catchup":
        return _k_catchup(L, v, slot[1]), z
    if kind == "kill":
        return _k_kill(L, v, slot[1]), z
    if kind == "rejoin":
        return _k_rejoin(L, v, slot[1]), z
    if kind == "partition":
        return _k_partition(L, v, slot[1]), z
    if kind == "heal":
        return _k_heal(L, v, slot[1]), z
    if kind == "promote_sync":
        return _k_promote(L, v, PR_SYNC, 0, False), z
    if kind == "promote_expired":
        return _k_promote(L, v, PR_SYNC, 0, True), z
    if kind == "promote_async":
        return _k_promote(L, v, PR_ASYNC, slot[1], False), z
    if kind == "freeze":
        return _k_freeze(L, v, True), z
    if kind == "unfreeze":
        return _k_freeze(L, v, False), z
    raise ValueError("unknown slot %r" % (kind,))


def _knob_list(knobs) -> list[int]:
    kn = [int(x) for x in torch.as_tensor(knobs).tolist()]
    if len(kn) != KNOBS:
        raise ValueError("knobs must have %d entries, not %d"
                         % (KNOBS, len(kn)))
    return kn


def _peers_of(vs: torch.Tensor, P: int) -> Layout:
    L = Layout(P)
    if vs.dim() != 2 or vs.shape[1] != L.SIZE or vs.dtype != torch.int32:
        raise ValueError("states must be (B, %d) int32 for P = %d, not %s %s"
                         % (L.SIZE, P, tuple(vs.shape), vs.dtype))
    return L


def step_plain(vs: torch.Tensor, knobs, P: int):
    """(B, SIZE) int32 states -> children (B, S, SIZE) int32, violation
    bits (B, S) int32, enabled (B, S) bool.  A disabled slot's child is
    its parent and its violation bits are 0."""
    L = _peers_of(vs, P)
    kn = _knob_list(knobs)
    en = enabled_plain(L, vs, kn)
    table = slot_table(P)
    children = torch.empty((vs.shape[0], len(table), L.SIZE),
                           dtype=torch.int32, device=vs.device)
    viols = torch.empty((vs.shape[0], len(table)), dtype=torch.int32,
                        device=vs.device)
    for s, slot in enumerate(table):
        v2, viol = _apply_slot(L, vs, slot, kn)
        viol = viol | safety_plain(L, v2)
        children[:, s] = _w(en[:, s, None], v2, vs)
        viols[:, s] = _w(en[:, s], viol, 0)
    return children, viols, en


# -- liveness (World.check_liveness) ----------------------------------------


def _anp(L, v, i):
    return ((_peer(L, v, i, L.PB_ALIVE) == 1)
            & (_peer(L, v, i, L.PB_PART) == 0))


def _views_current(L, v):
    sact, sact_n = _sact(L, v)
    ok = torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
    for i in range(L.P):
        vact, vact_n = _vact(L, v, i)
        cur = ((_peer(L, v, i, L.PB_VERCUR) == 1)
               & (vact == sact).all(1) & (vact_n == sact_n))
        ok = ok & (~_anp(L, v, i) | cur)
    return ok


def _round(L, v, kn):
    """One round of the fair schedule on every row of v (in place):
    deliver to every alive, reachable peer, then evaluate each in
    order.  Returns (violation bits, done)."""
    for i in range(L.P):
        go = _anp(L, v, i)
        synced = v.clone()
        _view_sync(L, synced, i)
        v[:] = _w(go[:, None], synced, v)
    viol = torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
    wrote_any = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
    for i in range(L.P):
        go = _anp(L, v, i)        # read after peers < i were evaluated
        v2, viol_i, wrote = eval_plain(L, v, i, kn)
        v[:] = _w(go[:, None], v2, v)
        viol = viol | _w(go, viol_i, 0)
        wrote_any = wrote_any | (go & wrote)
    return viol, ~wrote_any & _views_current(L, v)


def _predicates(L, v):
    """The convergence predicates' bits, meaningful at a fixpoint."""
    st = _rd_sb(L, v, L.G_SB)
    pos = torch.arange(L.P, device=v.device, dtype=torch.int32)
    anp = torch.stack([_anp(L, v, i) for i in range(L.P)], dim=1)
    in_asy = _members(st["asy"], st["asy_n"])
    in_dep = _members(st["dep"], st["dep_n"])
    prim, sync = st["prim"], st["sync"]
    role_deposed = (in_dep & ~in_asy & (prim[:, None] != pos)
                    & (sync[:, None] != pos))
    prim_alive = _member_at(anp, prim)
    sync_set = sync != NONE
    sync_alive = _member_at(anp, sync)
    not_frozen = st["frozen"] == 0
    dead_prim = not_frozen & ~prim_alive & sync_set & sync_alive
    cand_any = (anp & (pos != prim[:, None]) & ~role_deposed).any(1)
    no_sync = (not_frozen & prim_alive & (~sync_set | ~sync_alive)
               & cand_any)

    peer_col = lambda off: torch.stack(  # noqa: E731
        [_peer(L, v, j, off) for j in range(L.P)], dim=1)
    t_has = peer_col(L.PB_T_HAS) == 1
    t_role, t_up, t_down = (peer_col(L.PB_T_ROLE), peer_col(L.PB_T_UP),
                            peer_col(L.PB_T_DOWN))
    want = _w(prim[:, None] == pos, T_PRIM,
              _w(sync[:, None] == pos, T_SYNC, _w(in_asy, T_ASYNC, T_NONE)))
    mism = (anp & (~t_has | (t_role != want))).any(1)

    def up_of(j):
        return _w(_member_at(t_has, j), _at(t_up, j), NONE)

    def down_of(j):
        return _w(_member_at(t_has, j), _at(t_down, j), NONE)

    chain = prim_alive & sync_set & (down_of(prim) != sync)
    chain = chain | (sync_set & sync_alive & (up_of(sync) != prim))
    for k in range(L.P):
        a_k = st["asy"][:, k]
        live = (k < st["asy_n"]) & _member_at(anp, a_k)
        want_up = sync if k == 0 else st["asy"][:, k - 1]
        applicable = live & sync_set if k == 0 else live
        chain = chain | (applicable & (up_of(a_k) != want_up))

    return (_w(dead_prim, _BIT["dead_primary_not_replaced"], 0)
            | _w(no_sync, _BIT["no_sync_appointed"], 0)
            | _w(mism, _BIT["role_mismatch"], 0)
            | _w(chain, _BIT["chain"], 0))


def _settle(L, vs: torch.Tensor, kn):
    """Catch-up, then the fair schedule to fixpoint on a copy of vs:
    (states, violation bits, done, rounds run), a row each.

    The reference vmaps a lax.while_loop: a row stops iterating once its
    own schedule is done (or after 30 rounds) while the others go on.
    Here each round runs on the rows still going, and only those are
    updated."""
    v = vs.clone()
    iw = v[:, L.G_SB + L.SB_IW]
    for i in range(L.P):                # catch-up of every alive peer
        c = L.pbase(i) + L.PB_X
        v[:, c] = _w((v[:, L.pbase(i) + L.PB_ALIVE] == 1) & (v[:, c] < iw),
                     iw, v[:, c])
    viol = torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
    done = torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)
    rounds = torch.zeros(v.shape[0], dtype=torch.int64, device=v.device)
    for _ in range(MAX_ROUNDS):
        going = (~done).nonzero()[:, 0]
        if going.numel() == 0:
            break
        sub = v[going]
        viol_r, done_r = _round(L, sub, kn)
        v[going] = sub
        viol[going] = viol[going] | viol_r
        done[going] = done_r
        rounds[going] += 1
    return v, viol, done, rounds


def liveness_plain(vs: torch.Tensor, knobs, P: int) -> torch.Tensor:
    """(B, SIZE) int32 states -> (B,) int32 liveness violation bits (and
    any write-legality bits the settle evaluations tripped)."""
    L = _peers_of(vs, P)
    v, viol, done, _rounds = _settle(L, vs, _knob_list(knobs))
    viol = viol | _w(done, 0, _BIT["no_fixpoint"])
    return viol | _w(done, _predicates(L, v), 0)


def rounds_plain(vs: torch.Tensor, knobs, P: int) -> torch.Tensor:
    """(B,) int64: the rounds of the fair schedule each row of the
    liveness check runs (``MAX_ROUNDS`` where it finds no fixpoint)."""
    return _settle(_peers_of(vs, P), vs, _knob_list(knobs))[3]


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers


def _library() -> ctypes.CDLL:
    lib = nvcc.load("mc_array")
    if lib.mc_step_launch.argtypes is None:
        # pointers and the stream as c_void_p, or ctypes cuts them to
        # 32-bit ints
        lib.mc_step_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.mc_step_launch.restype = ctypes.c_int
        lib.mc_liveness_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.mc_liveness_launch.restype = ctypes.c_int
        lib.mc_error_string.argtypes = [ctypes.c_int]
        lib.mc_error_string.restype = ctypes.c_char_p
    return lib


def _check(kernel: str, vs, knobs, P: int) -> tuple[Layout, torch.device]:
    if P not in PEERS:
        raise ValueError("%s is built for P in %s, not %d"
                         % (kernel, PEERS, P))
    L = Layout(P)
    batch = vs.shape[0] if vs.dim() == 2 else -1
    if not 0 <= batch <= _MAX_ROWS:
        raise ValueError("states must have shape (B, %d) with B <= %d, not %s"
                         % (L.SIZE, _MAX_ROWS, tuple(vs.shape)))
    device = check_inputs(kernel, [
        ("states", vs, (batch, L.SIZE), torch.int32),
        ("knobs", knobs, (KNOBS,), torch.int32)])
    return L, device


def _raise_on(lib, err: int, kernel: str) -> None:
    if err:
        raise RuntimeError("%s kernel launch failed: %s (%d)"
                           % (kernel, lib.mc_error_string(err).decode(), err))


def mc_step(vs: torch.Tensor, knobs: torch.Tensor, P: int):
    """Launch K5 on the current stream: (B, SIZE) int32 states and (9,)
    int32 knobs, contiguous, on one card -> children (B, S, SIZE) int32,
    violation bits (B, S) int32, enabled (B, S) bool.  Does not
    synchronise; adds one to ``mc_step.launches`` per launch."""
    L, device = _check("mc_step", vs, knobs, P)
    B, S = vs.shape[0], len(slot_table(P))
    children = torch.empty((B, S, L.SIZE), dtype=torch.int32, device=device)
    viols = torch.empty((B, S), dtype=torch.int32, device=device)
    en = torch.empty((B, S), dtype=torch.bool, device=device)
    if B == 0:
        return children, viols, en
    lib = _library()
    _raise_on(lib, lib.mc_step_launch(
        vs.data_ptr(), knobs.data_ptr(), children.data_ptr(),
        viols.data_ptr(), en.data_ptr(), B, P, device.index,
        torch.cuda.current_stream(device).cuda_stream), "mc_step")
    mc_step.launches += 1
    return children, viols, en


def mc_liveness(vs: torch.Tensor, knobs: torch.Tensor, P: int):
    """Launch K6 on the current stream: (B, SIZE) int32 states and (9,)
    int32 knobs on one card -> (B,) int32 liveness bits.  Does not
    synchronise; adds one to ``mc_liveness.launches`` per launch."""
    _L, device = _check("mc_liveness", vs, knobs, P)
    B = vs.shape[0]
    bits = torch.empty((B,), dtype=torch.int32, device=device)
    if B == 0:
        return bits
    lib = _library()
    _raise_on(lib, lib.mc_liveness_launch(
        vs.data_ptr(), knobs.data_ptr(), bits.data_ptr(), B, P,
        device.index, torch.cuda.current_stream(device).cuda_stream),
        "mc_liveness")
    mc_liveness.launches += 1
    return bits


mc_step.launches = 0
mc_liveness.launches = 0


def step(vs: torch.Tensor, knobs: torch.Tensor, P: int):
    """K5 on a CUDA tensor, the plain version on a CPU tensor."""
    if vs.device.type == "cpu":
        return step_plain(vs, knobs, P)
    return mc_step(vs, knobs, P)


def liveness(vs: torch.Tensor, knobs: torch.Tensor, P: int):
    """K6 on a CUDA tensor, the plain version on a CPU tensor."""
    if vs.device.type == "cpu":
        return liveness_plain(vs, knobs, P)
    return mc_liveness(vs, knobs, P)

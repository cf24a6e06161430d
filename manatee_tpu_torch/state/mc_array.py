"""The model checker's array engine: the whole BFS frontier expanded at
once, on the card by the hand kernels K5-K7.

The port of manatee_tpu/state/mc_array.py.  Its host half (the int32
encoding of a checker world, the knobs, the slot table, the mutation
patches) is numpy and a copy of the reference's; the device half runs on
the card as three CUDA C++ kernels, and on the CPU as their plain torch
versions (natively batched ``(B, SIZE)`` int32 operations):

* K5 ``kernels.mc_step.mc_step``: every frontier state expanded over the
  whole action alphabet — children, violation bits, enabled mask;
* K6 ``kernels.mc_step.mc_liveness``: catch-up, the fair schedule to
  fixpoint (at most 30 rounds), the convergence predicates;
* K7 ``kernels.mc_dedup.mc_dedup``: 32-bit row hash, one stable sort
  (valid rows first), full-row neighbour compare.

With several devices (a list, or ``device=None`` on a machine with more
than one card) each chunk is split over them (K8, ``_engine``): K5 and
K6 run on each device's block of rows, the results are gathered on the
first device in row order, and K7 runs once over the gathered batch.

The encoding is bijective with the semantic-state quotient shared with
the Python oracle (canon.py), so deduplicating on raw vector bytes is
deduplicating on the canonical digest, and ``differential`` holds the two
engines to exact agreement on the reachable states and every verdict.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from manatee_tpu_torch.device import resolve_all
from manatee_tpu_torch.state import canon
from manatee_tpu_torch.state.modelcheck import (
    CONFIGS,
    FUTURE_EXPIRY,
    PAST_EXPIRY,
    MCConfig,
    MCResult,
    _fast_sleep,
    _replay,
)

# ---------------------------------------------------------------------------
# role / field codes

NONE = -1

# role_note / role_of codes
R_NONE, R_PRIM, R_SYNC, R_ASYNC, R_DEPOSED = 0, 1, 2, 3, 4
_NOTE_STR = {R_NONE: None, R_PRIM: "primary", R_SYNC: "sync",
             R_ASYNC: "async", R_DEPOSED: "deposed"}

# pg-target role codes
T_NONE, T_PRIM, T_SYNC, T_ASYNC = 0, 1, 2, 3
_T_STR = {T_NONE: "none", T_PRIM: "primary", T_SYNC: "sync",
          T_ASYNC: "async"}

# promote-request role codes
PR_SYNC, PR_ASYNC = 0, 1

# the freeze payload the explorer's freeze action writes (modelcheck.py)
FREEZE_DICT = {"date": "2026-01-01T00:00:00Z", "reason": "modelcheck"}

_BIT = canon.CATEGORY_BIT


class EncodingError(Exception):
    """A world outside the fixed-shape encoding's domain — by
    construction unreachable from the explorer's configs; raised loudly
    rather than silently mis-encoded."""


# ---------------------------------------------------------------------------
# layout


class Layout:
    """Offsets of the fixed-shape int32 encoding for P peers.

    state block (SB, one for the durable store + one per-peer view):
      gen, initWal, primary, sync, async[P]+n, deposed[P]+n, frozen,
      promote{has, role, id, asyncIndex, gen, expired}
    globals: kills, rejoins, store actives[P]+n, store SB
    per peer: alive, part, xlog, ver_current, evaled, role_note,
      target{has, role, up, down, deposed}, view actives[P]+n, view SB
    """

    def __init__(self, P: int):
        self.P = P
        # -- state block (relative offsets) --
        self.SB_GEN = 0
        self.SB_IW = 1
        self.SB_PRIM = 2
        self.SB_SYNC = 3
        self.SB_ASY = 4
        self.SB_ASY_N = 4 + P
        self.SB_DEP = 5 + P
        self.SB_DEP_N = 5 + 2 * P
        self.SB_FROZEN = 6 + 2 * P
        self.SB_P_HAS = 7 + 2 * P
        self.SB_P_ROLE = 8 + 2 * P
        self.SB_P_ID = 9 + 2 * P
        self.SB_P_IDX = 10 + 2 * P
        self.SB_P_GEN = 11 + 2 * P
        self.SB_P_EXP = 12 + 2 * P
        self.SB_SIZE = 13 + 2 * P
        # -- globals --
        self.G_KILLS = 0
        self.G_REJOINS = 1
        self.G_ACT = 2
        self.G_ACT_N = 2 + P
        self.G_SB = 3 + P
        self.GLOB = 3 + P + self.SB_SIZE
        # -- per-peer block --
        self.PB_ALIVE = 0
        self.PB_PART = 1
        self.PB_X = 2
        self.PB_VERCUR = 3
        self.PB_EVALED = 4
        self.PB_NOTE = 5
        self.PB_T_HAS = 6
        self.PB_T_ROLE = 7
        self.PB_T_UP = 8
        self.PB_T_DOWN = 9
        self.PB_T_DEP = 10
        self.PB_VACT = 11
        self.PB_VACT_N = 11 + P
        self.PB_VSB = 12 + P
        self.PB_SIZE = 12 + P + self.SB_SIZE
        self.SIZE = self.GLOB + P * self.PB_SIZE

    def pbase(self, i: int) -> int:
        return self.GLOB + i * self.PB_SIZE


# ---------------------------------------------------------------------------
# identity helpers (must match MCPeer exactly)


def _ident(name: str) -> str:
    return "%s:5432:12345" % name


def _info(name: str) -> dict:
    return {
        "id": _ident(name), "zoneId": name, "ip": name,
        "pgUrl": "tcp://postgres@%s:5432/postgres" % name,
        "backupUrl": "http://%s:12345" % name,
    }


def _lsn_int(lsn: str) -> int:
    hi, lo = lsn.strip().split("/")
    if int(hi, 16) != 0:
        raise EncodingError("lsn high word nonzero: %r" % lsn)
    return int(lo, 16)


def _lsn_str(v: int) -> str:
    return "0/%07X" % v


_STATE_KEYS = {"generation", "initWal", "primary", "sync", "async",
               "deposed", "freeze", "promote", "trace", "span", "hlc"}
_PROMOTE_KEYS = {"id", "role", "asyncIndex", "generation", "expireTime"}


# ---------------------------------------------------------------------------
# encode


def _idx_of_info(info, idx_map, what: str) -> int:
    if info is None:
        return NONE
    if not isinstance(info, dict) or "id" not in info:
        raise EncodingError("%s is not a PeerInfo: %r" % (what, info))
    if info["id"] not in idx_map:
        raise EncodingError("%s unknown peer %r" % (what, info["id"]))
    i = idx_map[info["id"]]
    return i


def _check_info(info, names, what: str) -> None:
    """The encoding regenerates PeerInfo dicts from the peer index, so
    any non-canonical info dict would silently decode differently."""
    name = names[_idx_of_info(info, {_ident(n): i for i, n
                                     in enumerate(names)}, what)]
    if info != _info(name):
        raise EncodingError("%s non-canonical PeerInfo: %r" % (what, info))


def _encode_sb(st: dict, names, out, base: int) -> None:
    idx_map = {_ident(n): i for i, n in enumerate(names)}
    P = len(names)
    if st is None:
        raise EncodingError("state block is None (pre-bootstrap world)")
    extra = set(st) - _STATE_KEYS
    if extra:
        raise EncodingError("unsupported state keys: %r" % extra)
    for k in ("generation", "initWal", "primary", "sync", "async",
              "deposed"):
        if k not in st:
            raise EncodingError("state missing %r" % k)
    out[base + 0] = st["generation"]
    out[base + 1] = _lsn_int(st["initWal"])
    _check_info(st["primary"], names, "primary")
    out[base + 2] = idx_map[st["primary"]["id"]]
    if st["sync"] is not None:
        _check_info(st["sync"], names, "sync")
        out[base + 3] = idx_map[st["sync"]["id"]]
    else:
        out[base + 3] = NONE
    L = Layout(P)
    asy = st["async"] or []
    dep = st["deposed"] or []
    if len(asy) > P or len(dep) > P:
        raise EncodingError("async/deposed list longer than P")
    for k, a in enumerate(asy):
        _check_info(a, names, "async[%d]" % k)
        out[base + L.SB_ASY + k] = idx_map[a["id"]]
    for k in range(len(asy), P):
        out[base + L.SB_ASY + k] = NONE
    out[base + L.SB_ASY_N] = len(asy)
    for k, d in enumerate(dep):
        _check_info(d, names, "deposed[%d]" % k)
        out[base + L.SB_DEP + k] = idx_map[d["id"]]
    for k in range(len(dep), P):
        out[base + L.SB_DEP + k] = NONE
    out[base + L.SB_DEP_N] = len(dep)
    if "freeze" in st:
        if st["freeze"] != FREEZE_DICT:
            raise EncodingError("non-canonical freeze: %r" % st["freeze"])
        out[base + L.SB_FROZEN] = 1
    else:
        out[base + L.SB_FROZEN] = 0
    pr = st.get("promote")
    if "promote" in st:
        if pr is None or set(pr) - _PROMOTE_KEYS:
            raise EncodingError("non-canonical promote: %r" % pr)
        out[base + L.SB_P_HAS] = 1
        if pr["role"] == "sync":
            out[base + L.SB_P_ROLE] = PR_SYNC
        elif pr["role"] == "async":
            out[base + L.SB_P_ROLE] = PR_ASYNC
        else:
            raise EncodingError("promote role %r" % pr["role"])
        if pr["id"] not in idx_map:
            raise EncodingError("promote id %r" % pr["id"])
        out[base + L.SB_P_ID] = idx_map[pr["id"]]
        out[base + L.SB_P_IDX] = pr.get("asyncIndex", NONE)
        out[base + L.SB_P_GEN] = pr["generation"]
        if pr["expireTime"] == FUTURE_EXPIRY:
            out[base + L.SB_P_EXP] = 0
        elif pr["expireTime"] == PAST_EXPIRY:
            out[base + L.SB_P_EXP] = 1
        else:
            raise EncodingError("promote expiry %r" % pr["expireTime"])
    else:
        out[base + L.SB_P_HAS] = 0
        out[base + L.SB_P_ROLE] = NONE
        out[base + L.SB_P_ID] = NONE
        out[base + L.SB_P_IDX] = NONE
        out[base + L.SB_P_GEN] = 0
        out[base + L.SB_P_EXP] = 0


def _decode_sb(vec, names, base: int) -> dict:
    P = len(names)
    L = Layout(P)
    st = {
        "generation": int(vec[base + L.SB_GEN]),
        "initWal": _lsn_str(int(vec[base + L.SB_IW])),
        "primary": _info(names[int(vec[base + L.SB_PRIM])]),
        "sync": (None if vec[base + L.SB_SYNC] == NONE
                 else _info(names[int(vec[base + L.SB_SYNC])])),
        "async": [_info(names[int(vec[base + L.SB_ASY + k])])
                  for k in range(int(vec[base + L.SB_ASY_N]))],
        "deposed": [_info(names[int(vec[base + L.SB_DEP + k])])
                    for k in range(int(vec[base + L.SB_DEP_N]))],
    }
    if vec[base + L.SB_FROZEN]:
        st["freeze"] = dict(FREEZE_DICT)
    if vec[base + L.SB_P_HAS]:
        pr = {
            "id": _ident(names[int(vec[base + L.SB_P_ID])]),
            "role": ("sync" if vec[base + L.SB_P_ROLE] == PR_SYNC
                     else "async"),
            "generation": int(vec[base + L.SB_P_GEN]),
            "expireTime": (PAST_EXPIRY if vec[base + L.SB_P_EXP]
                           else FUTURE_EXPIRY),
        }
        if vec[base + L.SB_P_IDX] != NONE:
            pr["asyncIndex"] = int(vec[base + L.SB_P_IDX])
        st["promote"] = pr
    return st


def _encode_cfg(cfg, idx_map, out, pbase: int, L: Layout) -> None:
    """Encode a stripped pg-target dict into the 5 target slots."""
    b = pbase
    if cfg is None:
        out[b + L.PB_T_HAS] = 0
        out[b + L.PB_T_ROLE] = T_NONE
        out[b + L.PB_T_UP] = NONE
        out[b + L.PB_T_DOWN] = NONE
        out[b + L.PB_T_DEP] = 0
        return
    role = cfg.get("role")
    out[b + L.PB_T_HAS] = 1
    if role == "none":
        extra = set(cfg) - {"role", "deposed"}
        if extra:
            raise EncodingError("target extra keys %r" % extra)
        out[b + L.PB_T_ROLE] = T_NONE
        out[b + L.PB_T_UP] = NONE
        out[b + L.PB_T_DOWN] = NONE
        out[b + L.PB_T_DEP] = 1 if cfg.get("deposed") else 0
        if "deposed" in cfg and cfg["deposed"] is not True:
            raise EncodingError("target deposed %r" % cfg["deposed"])
        return
    if role not in ("primary", "sync", "async"):
        raise EncodingError("target role %r" % role)
    extra = set(cfg) - {"role", "upstream", "downstream"}
    if extra:
        raise EncodingError("target extra keys %r" % extra)
    if "upstream" not in cfg or "downstream" not in cfg:
        raise EncodingError("target missing upstream/downstream")
    out[b + L.PB_T_ROLE] = {"primary": T_PRIM, "sync": T_SYNC,
                            "async": T_ASYNC}[role]
    up, down = cfg["upstream"], cfg["downstream"]
    out[b + L.PB_T_UP] = (NONE if up is None else idx_map[up["id"]])
    out[b + L.PB_T_DOWN] = (NONE if down is None else idx_map[down["id"]])
    out[b + L.PB_T_DEP] = 0


def _decode_cfg(vec, names, pbase: int, L: Layout):
    b = pbase
    if not vec[b + L.PB_T_HAS]:
        return None
    role = int(vec[b + L.PB_T_ROLE])
    if role == T_NONE:
        cfg = {"role": "none"}
        if vec[b + L.PB_T_DEP]:
            cfg["deposed"] = True
        return cfg
    up = int(vec[b + L.PB_T_UP])
    down = int(vec[b + L.PB_T_DOWN])
    return {
        "role": _T_STR[role],
        "upstream": None if up == NONE else _info(names[up]),
        "downstream": None if down == NONE else _info(names[down]),
    }


def encode_world(world, config: MCConfig) -> np.ndarray:
    """Encode a (booted, settled) Python checker World.  Raises
    EncodingError on anything outside the encoding's domain — including
    a pg target/applied mismatch, which the settle discipline makes
    impossible at action boundaries (the invariant the single target
    slot relies on)."""
    names = list(config.peers)
    idx_map = {_ident(n): i for i, n in enumerate(names)}
    P = len(names)
    L = Layout(P)
    out = np.zeros(L.SIZE, dtype=np.int32)
    out[L.G_KILLS] = world.kills
    out[L.G_REJOINS] = world.rejoins
    acts = world.store.actives
    if len(acts) > P:
        raise EncodingError("store actives longer than P")
    for k, a in enumerate(acts):
        if a["id"] not in idx_map:
            raise EncodingError("unknown active %r" % a["id"])
        out[L.G_ACT + k] = idx_map[a["id"]]
    for k in range(len(acts), P):
        out[L.G_ACT + k] = NONE
    out[L.G_ACT_N] = len(acts)
    _encode_sb(world.store.state, names, out, L.G_SB)

    if set(world.peers) != set(names):
        raise EncodingError("peer set mismatch")
    for i, name in enumerate(names):
        p = world.peers[name]
        b = L.pbase(i)
        out[b + L.PB_ALIVE] = 1 if p.alive else 0
        out[b + L.PB_PART] = 1 if p.partitioned else 0
        out[b + L.PB_X] = _lsn_int(p.pg.xlog)
        out[b + L.PB_VERCUR] = (
            1 if p.zk.cluster_state_version == world.store.version else 0)
        out[b + L.PB_EVALED] = 1 if p.eval_epoch >= p.view_epoch else 0
        note = p.sm._notified_role
        for code, s in _NOTE_STR.items():
            if s == note:
                out[b + L.PB_NOTE] = code
                break
        else:
            raise EncodingError("role_note %r" % note)
        tgt = p.sm._strip_cfg(p.sm._pg_target)
        app = p.sm._strip_cfg(p.sm._pg_applied)
        if tgt != app:
            raise EncodingError(
                "pg target %r != applied %r on %s" % (tgt, app, name))
        _encode_cfg(tgt, idx_map, out, b, L)
        va = p.zk.active
        if len(va) > P:
            raise EncodingError("view actives longer than P")
        for k, a in enumerate(va):
            if a["id"] not in idx_map:
                raise EncodingError("unknown view active %r" % a["id"])
            out[b + L.PB_VACT + k] = idx_map[a["id"]]
        for k in range(len(va), P):
            out[b + L.PB_VACT + k] = NONE
        out[b + L.PB_VACT_N] = len(va)
        if p.zk.cluster_state is None:
            raise EncodingError("peer %s view is None" % name)
        _encode_sb(p.zk.cluster_state, names, out, b + L.PB_VSB)
    return out


def decode_canon(vec, config: MCConfig) -> dict:
    """Decode a state vector back into the exact canonical dict
    canon.world_canon builds for the equivalent Python world — the
    other half of the bijectivity contract."""
    names = list(config.peers)
    P = len(names)
    L = Layout(P)
    s_act = [_ident(names[int(vec[L.G_ACT + k])])
             for k in range(int(vec[L.G_ACT_N]))]
    peers = {}
    for name in sorted(names):
        i = names.index(name)
        b = L.pbase(i)
        v_act = [_ident(names[int(vec[b + L.PB_VACT + k])])
                 for k in range(int(vec[b + L.PB_VACT_N]))]
        cfg = _decode_cfg(vec, names, b, L)
        peers[name] = {
            "alive": bool(vec[b + L.PB_ALIVE]),
            "part": bool(vec[b + L.PB_PART]),
            "xlog": _lsn_str(int(vec[b + L.PB_X])),
            "ver_current": bool(vec[b + L.PB_VERCUR]),
            "actives_current": v_act == s_act,
            "evaled_current": bool(vec[b + L.PB_EVALED]),
            "view": _decode_sb(vec, names, b + L.PB_VSB),
            "view_actives": v_act,
            "target": cfg,
            "applied": cfg,
            "role_note": _NOTE_STR[int(vec[b + L.PB_NOTE])],
        }
    return {
        "state": _decode_sb(vec, names, L.G_SB),
        "actives": s_act,
        "kills": int(vec[L.G_KILLS]),
        "rejoins": int(vec[L.G_REJOINS]),
        "peers": peers,
    }


def digest_vec(vec, config: MCConfig) -> str:
    return canon.digest_of(decode_canon(vec, config))



# ---------------------------------------------------------------------------
# knobs and mutations

# knobs array layout
K_MAX_KILLS, K_MAX_REJOINS, K_PROMOTE, K_FREEZE, K_PARTITION, \
    K_MUT_XLOG, K_MUT_FREEZE, K_MUT_GENBUMP, K_MUT_DEPOSED = range(9)
KNOBS = 9


def make_knobs(config: MCConfig, mutations=None) -> np.ndarray:
    m = mutations or Mutations()
    return np.array([
        config.max_kills, config.max_rejoins,
        int(config.allow_promote), int(config.allow_freeze),
        int(config.allow_partition),
        int(m.disable_xlog_guard), int(m.ignore_freeze),
        int(m.skip_gen_bump), int(m.deposed_keeps_primary),
    ], dtype=np.int32)


@dataclass(frozen=True)
class Mutations:
    """Deliberate rule-weakenings, mirrored in both engines.

    Each flag corresponds to one monkeypatch of the Python machine (see
    mutation_patches) and one traced branch in the kernels, so the
    regression corpus can pin that BOTH engines flag the same seeded
    bug with the same category."""
    disable_xlog_guard: bool = False    # sync takeover skips the lsn gate
    ignore_freeze: bool = False         # duties act on a frozen cluster
    skip_gen_bump: bool = False         # takeover keeps the generation
    deposed_keeps_primary: bool = False  # deposed peer ignores deposition

    def any(self) -> bool:
        return (self.disable_xlog_guard or self.ignore_freeze
                or self.skip_gen_bump or self.deposed_keeps_primary)

# -- slot enumeration -------------------------------------------------------
#
# Slot order REPLICATES World.enabled()'s list order exactly.  That
# matters because the Python explorer memoizes on digest and keeps the
# FIRST-discovered trace's verdict for each state; matching discovery
# order is part of the differential contract, not just cosmetics.


def slot_table(P: int) -> list[tuple]:
    slots: list[tuple] = []
    for i in range(P):
        slots += [("eval", i), ("refresh", i), ("catchup", i)]
    slots += [("kill", i) for i in range(P)]
    slots += [("rejoin", i) for i in range(P)]
    for i in range(P):
        slots += [("partition", i), ("heal", i)]
    slots += [("promote_sync",), ("promote_expired",),
              ("promote_async", 0), ("promote_async", 1),
              ("freeze",), ("unfreeze",)]
    return slots

# ---------------------------------------------------------------------------
# mutation patches (Python-side mirror of the knob flags)


@contextlib.contextmanager
def mutation_patches(mutations=None):
    """Apply the deliberate rule-weakenings to the *Python* machine —
    the exact monkeypatches of the mutation self-tests — so the oracle
    and the array engine explore the same weakened semantics and the
    regression corpus can require both to flag the same seeded bug."""
    m = mutations or Mutations()
    from manatee_tpu_torch.state import machine as _machine
    from manatee_tpu_torch.state.types import role_of as _role_of
    saved = {}
    try:
        if m.disable_xlog_guard:
            saved["compare_lsn"] = _machine.compare_lsn
            _machine.compare_lsn = lambda a, b: 0
        if m.ignore_freeze:
            saved["frozen"] = _machine.frozen
            _machine.frozen = lambda st: False
        if m.deposed_keeps_primary:
            orig_eval = _machine.PeerStateMachine._evaluate
            saved["_evaluate"] = orig_eval

            async def bad_evaluate(self):
                st = self.zk.cluster_state
                if (st is not None
                        and _role_of(st, self.self_id) == "deposed"):
                    return    # ignore the deposition; keep old pg config
                return await orig_eval(self)

            _machine.PeerStateMachine._evaluate = bad_evaluate
        if m.skip_gen_bump:
            orig_write = _machine.PeerStateMachine._write_state
            saved["_write_state"] = orig_write

            async def bad_write(self, state, why, ver, **kw):
                if "takeover" in why and state.get("generation", 0) > 0:
                    state = dict(state)
                    state["generation"] -= 1
                return await orig_write(self, state, why, ver, **kw)

            _machine.PeerStateMachine._write_state = bad_write
        yield
    finally:
        if "compare_lsn" in saved:
            _machine.compare_lsn = saved["compare_lsn"]
        if "frozen" in saved:
            _machine.frozen = saved["frozen"]
        if "_evaluate" in saved:
            _machine.PeerStateMachine._evaluate = saved["_evaluate"]
        if "_write_state" in saved:
            _machine.PeerStateMachine._write_state = saved["_write_state"]


# ---------------------------------------------------------------------------
# the frontier explorer


def _slot_action(config: MCConfig, slot: tuple) -> tuple:
    """Map a slot-table entry back to the Python explorer's action
    tuple (for counterexample traces and the differential replay)."""
    kind = slot[0]
    if kind in ("eval", "refresh", "catchup", "kill", "rejoin",
                "partition", "heal"):
        return (kind, config.peers[slot[1]])
    if kind == "promote_async":
        return (kind, slot[1])
    return (kind,)


def _boot(config: MCConfig, m: "Mutations"):
    """The root world, booted through the port's machine under the same
    mutations: the root state and its boot-time violations come from
    the oracle."""
    from manatee_tpu_torch.state import machine as _machine
    patched, _machine._sleep = _machine._sleep, _fast_sleep
    try:
        loop = asyncio.new_event_loop()
        try:
            with mutation_patches(m):
                return loop.run_until_complete(_replay(config, ()))
        finally:
            loop.close()
    finally:
        _machine._sleep = patched


def _gather(outs: list, dst: torch.device):
    """Shard results concatenated on *dst* in shard order (the
    reference's linear order, which the dedup's minimum-linear-index
    survivor depends on); a single shard's result as it is."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(dst) for o in outs])
    return tuple(torch.cat([o[j].to(dst) for o in outs])
                 for j in range(len(outs[0])))


def shard_map(fn, P: int, chunk: int, devices):
    """``fn(vs, knobs, P)`` (K5 or K6, or a plain version) over the
    devices: the (chunk, SIZE) rows split into ``len(devices)``
    contiguous equal blocks, block i run on ``devices[i]`` with
    ``knobs[i]``, the results gathered on ``devices[0]``.  The port of
    the reference's ``shard_map`` over its ``data`` axis: placement
    only, no arithmetic of its own; torch orders the copies' streams."""
    n = len(devices)
    if chunk % n:
        raise ValueError("chunk %d does not split over %d devices"
                         % (chunk, n))

    def run(vs: torch.Tensor, knobs) -> torch.Tensor | tuple:
        if vs.shape[0] != chunk or len(knobs) != n:
            raise ValueError("want %d rows and %d knob copies, not %d and %d"
                             % (chunk, n, vs.shape[0], len(knobs)))
        return _gather([fn(s.to(d), k, P) for s, d, k
                        in zip(vs.chunk(n), devices, knobs)], devices[0])

    return run


def replicate_knobs(knobs: np.ndarray, devices) -> tuple:
    """The (9,) int32 knobs once on each distinct device, one entry per
    device of *devices*: the replicated operand of the engine's step and
    liveness (a kernel takes its states and knobs on one card)."""
    copies = {d: torch.from_numpy(knobs).to(d) for d in set(devices)}
    return tuple(copies[d] for d in devices)


_ENGINES: dict = {}


def _engine(P: int, chunk: int, devices):
    """(step, live, dedup) for a peer count, a chunk size and the
    devices the chunk is split over (K8), cached per (P, chunk,
    devices) as the reference's ``_engine`` (mc_array.py:1351-1393).

    ``step(vs, knobs)`` -> children (chunk, S, SIZE), violation bits
    (chunk, S), enabled (chunk, S) and ``live(vs, knobs)`` -> (chunk,)
    liveness bits run K5 and K6 on each device's block of rows (their
    plain versions on a CPU device) and gather on ``devices[0]``; *vs*
    may lie anywhere, *knobs* is ``replicate_knobs``'s tuple.
    ``dedup(flat, valid)`` is K7 over the gathered batch on
    ``devices[0]``.  The kernels are looked up at each call, so a
    wrapper patched around them sees every launch."""
    from manatee_tpu_torch.kernels import mc_dedup, mc_step
    devices = tuple(resolve_all(devices))
    key = (P, chunk, devices)
    eng = _ENGINES.get(key)
    if eng is None:
        eng = _ENGINES[key] = (
            shard_map(lambda v, k, p: mc_step.step(v, k, p), P, chunk,
                      devices),
            shard_map(lambda v, k, p: mc_step.liveness(v, k, p), P, chunk,
                      devices),
            lambda flat, valid: mc_dedup.dedup(flat, valid))
    return eng


def explore_torch(config: MCConfig, depth: int | None = None,
                  max_nodes: int = 200_000, progress: bool = False,
                  mutations=None, collect=None, chunk: int = 256,
                  device=None) -> MCResult:
    """Level-synchronized BFS with the whole frontier expanded at once:
    by K5, K6 and K7 on the cards (``device=None``: every visible card),
    by their plain versions on ``device="cpu"``.  *device* may be a list
    (see ``device.resolve_all``): each chunk is then split over those
    devices (K8, ``_engine``) and the chunk rounded to a multiple of
    their number, as the reference rounds it to its device count.

    Mirrors ``explore_jax`` (manatee_tpu/state/mc_array.py) line for
    line: the slot table enumerates actions in ``World.enabled()``
    order, chunks are consecutive frontier slices padded with their
    first row, the dedup keeps minimum-linear-index occurrences, and the
    host seen-set admits candidates in ascending linear order — so
    states are discovered in the oracle's BFS order and first-trace
    verdicts coincide (see :func:`differential`).  Only what the host
    loop reads crosses to the host: keep, order, the kept rows and the
    violation and enabled bits.

    *collect*, when given, is called as ``collect(digest, trace,
    categories)`` per discovered state."""
    devices = resolve_all(device)
    dev = devices[0]
    depth = config.depth if depth is None else depth
    m = mutations or Mutations()
    P = len(config.peers)
    L = Layout(P)
    table = slot_table(P)
    S = len(table)
    chunk = max(1, chunk // len(devices)) * len(devices)
    step, live, dedup = _engine(P, chunk, devices)
    res = MCResult(config=config.name, engine="torch")
    t0 = time.monotonic()
    last_report = t0
    logging.getLogger("manatee.state").setLevel(logging.CRITICAL)

    root_w = _boot(config, m)
    root_vec = np.asarray(encode_world(root_w, config), np.int32)
    boot_bad = canon.classify_all(root_w.violations
                                  + root_w.store.violations)
    knobs = replicate_knobs(make_knobs(config, m), devices)

    vecs: list[np.ndarray] = [root_vec]
    index: dict[bytes, int] = {root_vec.tobytes(): 0}
    parents: list[int] = [-1]
    pslots: list[int] = [-1]

    def lv_bits(arr: np.ndarray) -> np.ndarray:
        out = []
        for off in range(0, len(arr), chunk):
            part = arr[off:off + chunk]
            if len(part) < chunk:
                part = np.concatenate(
                    [part, np.repeat(part[:1], chunk - len(part), 0)])
            out.append(live(torch.from_numpy(part), knobs).cpu().numpy())
        return np.concatenate(out)[:len(arr)]

    def trace_of(i: int) -> list:
        rev = []
        while parents[i] >= 0:
            rev.append(pslots[i])
            i = parents[i]
        return [_slot_action(config, table[s]) for s in reversed(rev)]

    root_cats = boot_bad | canon.mask_to_categories(
        int(lv_bits(root_vec[None, :])[0]))
    if collect is not None:
        collect(digest_vec(root_vec, config), (), root_cats)
    frontier: list[int] = []
    if root_cats:
        res.violations.append({"trace": [],
                               "problems": sorted(root_cats)})
    elif depth > 0:
        frontier.append(0)

    level = 0
    truncated = False
    while frontier and level < depth and not truncated:
        level += 1
        budget = max_nodes - res.nodes
        if budget <= 0:
            truncated = True
            break
        expand = frontier
        if len(expand) > budget:
            expand = expand[:budget]
            truncated = True
        new_ids: list[int] = []
        new_avi: list[int] = []
        for off in range(0, len(expand), chunk):
            part = expand[off:off + chunk]
            n_real = len(part)
            vs = np.stack([vecs[i] for i in part])
            if n_real < chunk:
                vs = np.concatenate(
                    [vs, np.repeat(vs[:1], chunk - n_real, 0)])
            ch, vi, en = step(torch.from_numpy(vs), knobs)
            flat = ch.view(chunk * S, L.SIZE)
            valid = torch.zeros(chunk * S, dtype=torch.bool, device=dev)
            valid[:n_real * S] = en[:n_real].reshape(-1)
            keep, order = dedup(flat, valid)
            kept = torch.sort(order[keep]).values
            rows = flat[kept].cpu().numpy()
            kept = kept.cpu().numpy()
            en = en.cpu().numpy()
            vi = vi.cpu().numpy()
            for lin, row in zip(kept, rows):   # ascending == BFS order
                b, s = divmod(int(lin), S)
                vb = row.tobytes()
                if vb in index:
                    continue
                nid = len(vecs)
                index[vb] = nid
                vecs.append(row)
                parents.append(part[b])
                pslots.append(s)
                new_ids.append(nid)
                new_avi.append(int(vi[b, s]))
            res.nodes += n_real
            res.transitions += int(en[:n_real].sum())
            if progress and time.monotonic() - last_report >= 2.0:
                last_report = time.monotonic()
                print("[modelcheck %s/torch] states=%d frontier=%d "
                      "depth<=%d %.0f states/s"
                      % (config.name, len(vecs), len(frontier),
                         res.depth_reached,
                         len(vecs) / (last_report - t0)),
                      file=sys.stderr, flush=True)
        if not new_ids:
            frontier = []
            break
        res.depth_reached = level
        lv = lv_bits(np.stack([vecs[i] for i in new_ids]))
        nxt: list[int] = []
        for nid, avi, lbits in zip(new_ids, new_avi, lv):
            cats = canon.mask_to_categories(avi | int(lbits))
            if collect is not None:
                collect(digest_vec(vecs[nid], config),
                        tuple(trace_of(nid)), cats)
            if cats:
                res.violations.append({"trace": trace_of(nid),
                                       "problems": sorted(cats)})
            else:
                nxt.append(nid)
        frontier = nxt
    if truncated:
        res.complete = False
    res.states = len(vecs)
    res.seconds = time.monotonic() - t0
    return res


# ---------------------------------------------------------------------------
# differential oracle


class DifferentialError(AssertionError):
    """The engines disagreed — always a bug, never tolerable noise."""

    def __init__(self, msg: str, trace=None):
        super().__init__(msg)
        self.trace = trace


def _replay_report(config: MCConfig, mutations, trace) -> str:
    """Replay the offending action sequence through the Python world,
    reporting the verdict after every prefix — the minimized trace a
    divergence report ships."""
    from manatee_tpu_torch.state import machine as _machine
    from manatee_tpu_torch.state.modelcheck import _check_world
    lines = []
    patched, _machine._sleep = _machine._sleep, _fast_sleep
    try:
        loop = asyncio.new_event_loop()
        try:
            with mutation_patches(mutations):
                for k in range(len(trace) + 1):
                    w = loop.run_until_complete(
                        _replay(config, tuple(trace[:k])))
                    bad = _check_world(loop, w)
                    cats = sorted(canon.classify_all(bad))
                    lines.append("  after %-60r %s"
                                 % (list(trace[:k]), cats or "clean"))
        finally:
            loop.close()
    finally:
        _machine._sleep = patched
    return "\n".join(lines)


def differential(config: MCConfig, depth: int | None = None,
                 max_nodes: int = 200_000, mutations=None, device=None,
                 chunk: int = 256):
    """Run the oracle and ``explore_torch`` (on *device*: the card
    unless it says otherwise) at matched depth and require exact
    agreement on the reachable semantic-state set and every violation
    verdict.

    Divergence is a hard failure (:class:`DifferentialError`): the
    offending action sequence is replayed through the Python world and
    the per-prefix verdicts attached as a minimized trace.  Returns
    ``(python_result, torch_result)`` on agreement."""
    from manatee_tpu_torch.state.modelcheck import explore
    m = mutations or Mutations()
    py: dict = {}
    tc: dict = {}

    def py_collect(d, seq, bad):
        if d not in py:
            py[d] = (seq, canon.classify_all(bad))

    def tc_collect(d, seq, cats):
        if d not in tc:
            tc[d] = (seq, cats)

    with mutation_patches(m):
        pres = explore(config, depth=depth, max_nodes=max_nodes,
                       collect=py_collect)
    tres = explore_torch(config, depth=depth, max_nodes=max_nodes,
                         mutations=m, collect=tc_collect, chunk=chunk,
                         device=device)

    def fail(msg, trace):
        raise DifferentialError(
            "%s [config=%s depth=%r mutations=%r]\nminimized trace:\n%s"
            % (msg, config.name, depth, m,
               _replay_report(config, m, trace)), trace=trace)

    for d in sorted(tc.keys() - py.keys()):
        fail("state %s reached only by the torch engine" % d, tc[d][0])
    for d in sorted(py.keys() - tc.keys()):
        fail("state %s reached only by the python engine" % d,
             py[d][0])
    for d in sorted(py):
        if py[d][1] != tc[d][1]:
            fail("verdict mismatch on %s: python=%s torch=%s"
                 % (d, sorted(py[d][1]), sorted(tc[d][1])), tc[d][0])
    if pres.complete and tres.complete:
        pc = (pres.states, pres.nodes, pres.transitions,
              pres.depth_reached)
        tcn = (tres.states, tres.nodes, tres.transitions,
               tres.depth_reached)
        if pc != tcn:
            raise DifferentialError(
                "counter mismatch on %s: python"
                "(states,nodes,transitions,depth)=%r torch=%r"
                % (config.name, pc, tcn))
    return pres, tres


# ---------------------------------------------------------------------------
# throughput probe


def main(argv=None) -> int:
    """One warm-measured sweep, JSON on stdout.  A short cold run
    (depth 2) pays the kernels' build and first launches first, so the
    timed runs measure steady-state states/sec."""
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(
        description="torch model-check engine throughput probe")
    ap.add_argument("--config", default="promote",
                    choices=sorted(CONFIGS))
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--deeper", type=int, default=0,
                    help="extra plies for a second, deeper timed sweep")
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--max-nodes", type=int, default=500_000)
    ap.add_argument("--device", default=None,
                    help="one device (default: every visible CUDA card)")
    args = ap.parse_args(argv)
    devices = resolve_all(args.device)
    dev = devices[0]
    cfg = CONFIGS[args.config]
    explore_torch(cfg, depth=min(2, args.depth), chunk=args.chunk,
                  device=devices)
    res = explore_torch(cfg, depth=args.depth, chunk=args.chunk,
                        max_nodes=args.max_nodes, device=devices)
    out = {
        "engine": "torch", "config": args.config,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "n_devices": len(devices),
        "depth": args.depth, "states": res.states,
        "nodes": res.nodes, "ok": res.ok, "complete": res.complete,
        "seconds": round(res.seconds, 3),
        "states_per_sec": round(res.states_per_sec, 1),
    }
    if args.deeper > 0:
        d2 = explore_torch(cfg, depth=args.depth + args.deeper,
                           chunk=args.chunk, max_nodes=args.max_nodes,
                           device=devices)
        out["deeper"] = {
            "depth": args.depth + args.deeper, "states": d2.states,
            "ok": d2.ok, "complete": d2.complete,
            "seconds": round(d2.seconds, 3),
            "states_per_sec": round(d2.states_per_sec, 1),
        }
    print(_json.dumps(out))
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())

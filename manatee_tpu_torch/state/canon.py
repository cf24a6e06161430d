"""Shared semantic-state canonicalization for the model-checker engines.

The port's copy of manatee_tpu/state/canon.py; CATEGORIES is the
violation bitmask layout the kernels write, element for element.

Both explorers — the Python BFS in ``modelcheck.py`` and the array
engine in ``mc_array.py`` — memoize on "the semantic state of the whole
checker world".  If the two engines computed that quotient separately
they could silently disagree about what "same state" means, and the
differential oracle would be comparing apples to oranges.  This module
is the single definition:

* :func:`sem_state` — the semantic projection of a cluster-state dict
  (the per-transition ``trace``/``span`` obs ids are quotiented out;
  hashing either would make every logically-identical state look fresh
  and defeat memoization);
* :func:`world_canon` — the full canonical dict of a checker ``World``
  (durable state, election order, kill/rejoin budgets, and every peer's
  liveness/partition/xlog/view-staleness/pg-target/role-note);
* :func:`digest_of` — the canonical hash over that dict;
* :data:`CATEGORIES` / :func:`classify` — the stable violation-verdict
  vocabulary the differential comparison matches on (the Python engine
  produces prose, the array engine produces bitmasks; both map here).
"""

from __future__ import annotations

import hashlib
import json

# obs metadata embedded in durable states by _write_state: unique per
# write, semantically irrelevant
OBS_KEYS = frozenset(("trace", "span", "hlc"))


def sem_state(state):
    """Semantic projection of a cluster state for hashing."""
    if not isinstance(state, dict) or not (OBS_KEYS & state.keys()):
        return state
    return {k: v for k, v in state.items() if k not in OBS_KEYS}


def world_canon(world) -> dict:
    """The canonical (JSON-able) semantic state of a checker World.

    Everything the explorer's behavior can depend on is here; anything
    quotiented out (absolute CAS versions beyond the currency bit,
    trace/span ids, election seq numbers beyond their order, commit-gate
    identities) is provably irrelevant to future transitions."""
    peers = {}
    for name in sorted(world.peers):
        p = world.peers[name]
        sm = p.sm
        peers[name] = {
            "alive": p.alive,
            "part": p.partitioned,
            "xlog": p.pg.xlog,
            # version staleness and actives staleness diverge (a kill
            # changes actives without bumping the state version), and
            # CAS outcomes depend on the version bit alone — hash them
            # separately
            "ver_current": (p.zk.cluster_state_version
                            == world.store.version),
            "actives_current": ([a["id"] for a in p.zk.active]
                                == [a["id"] for a in
                                    world.store.actives]),
            "evaled_current": p.eval_epoch >= p.view_epoch,
            "view": sem_state(p.zk.cluster_state),
            "view_actives": [a["id"] for a in p.zk.active],
            # strip the overlapped-takeover commit gate: an Event is
            # not JSON, and its identity is fresh per attempt
            "target": sm._strip_cfg(sm._pg_target),
            "applied": sm._strip_cfg(sm._pg_applied),
            "role_note": sm._notified_role,
        }
    return {
        "state": sem_state(world.store.state),
        "actives": [a["id"] for a in world.store.actives],
        "kills": world.kills,
        "rejoins": world.rejoins,
        "peers": peers,
    }


def digest_of(canon: dict) -> str:
    return hashlib.md5(
        json.dumps(canon, sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# violation-verdict vocabulary

# Stable category names; the array engine's violation bitmask indexes
# into this tuple, and classify() maps the Python engine's prose onto
# the same names, so verdicts can be compared exactly.
CATEGORIES = (
    "gen_backwards",            # generation decreased (validate + store)
    "iw_backwards",             # initWal decreased (data-loss signature)
    "singleton_transition",     # multi-peer -> ONWM
    "newprim_samegen",          # primary changed without a gen bump
    "prim_not_prev_sync",       # takeover installed a non-sync
    "bump_nochange",            # gen bumped, primary+sync unchanged
    "sync_nobump",              # sync changed without a gen bump
    "frozen_write",             # automatic write on a frozen cluster
    "xlog_behind",              # named primary behind the gen's initWal
    "split_brain",              # un-named peer writable with current view
    "no_fixpoint",              # fair schedule never converged
    "no_cluster",               # no durable state despite live peers
    "dead_primary_not_replaced",
    "no_sync_appointed",
    "role_mismatch",            # pg target != durable role at fixpoint
    "chain",                    # replication daisy chain broken
    "eval_crash",               # evaluation raised unexpectedly
    "settle",                   # pg task failed to settle
    "no_bootstrap",             # bootstrap never declared a cluster
)

CATEGORY_BIT = {name: 1 << i for i, name in enumerate(CATEGORIES)}

# ordered (substring, category) — first match wins
_RULES = (
    ("generation went backwards", "gen_backwards"),
    ("initWal went backwards", "iw_backwards"),
    ("unparseable initWal", "iw_backwards"),
    ("singleton transition is unsupported", "singleton_transition"),
    ("new primary but same generation", "newprim_samegen"),
    ("new primary was not previous sync", "prim_not_prev_sync"),
    ("generation bumped but primary and sync", "bump_nochange"),
    ("sync changed without generation bump", "sync_nobump"),
    ("while the cluster was frozen", "frozen_write"),
    ("behind initWal", "xlog_behind"),
    ("configured primary with a current view", "split_brain"),
    ("fair schedule never reached fixpoint", "no_fixpoint"),
    ("no cluster despite", "no_cluster"),
    ("not replaced by live sync", "dead_primary_not_replaced"),
    ("no live sync despite", "no_sync_appointed"),
    ("pg target", "role_mismatch"),
    ("downstream", "chain"),
    ("upstream", "chain"),
    ("evaluation crashed", "eval_crash"),
    ("failed to settle", "settle"),
    ("bootstrap never declared", "no_bootstrap"),
)


def classify(problem: str) -> str:
    """Map a Python-engine violation string to its stable category."""
    for needle, cat in _RULES:
        if needle in problem:
            return cat
    return "other:" + problem[:60]


def classify_all(problems) -> frozenset:
    return frozenset(classify(p) for p in problems)


def mask_to_categories(mask: int) -> frozenset:
    return frozenset(name for name, bit in CATEGORY_BIT.items()
                     if mask & bit)

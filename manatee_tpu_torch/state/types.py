"""Cluster-state schema and helpers (the port's copy of
manatee_tpu/state/types.py).

The cluster state is a JSON-shaped dict, exactly the schema the reference
maintains in its versioned ZooKeeper `state` znode (observable at
lib/adm.js:788-819 and lib/adm.js:1915-1928):

    {
      "generation":       int,        # bumps EXACTLY on primary/sync change
      "initWal":          "X/XXXXXXX" # xlog position at generation start
      "primary":          PeerInfo,
      "sync":             PeerInfo | None,
      "async":            [PeerInfo, ...],
      "deposed":          [PeerInfo, ...],
      "oneNodeWriteMode": bool,               # optional
      "freeze":           {"date", "reason"}  # optional / None
      "promote":          {"id", "role", "asyncIndex"?, "generation",
                           "expireTime"}      # optional / None
    }

PeerInfo = {"id": "ip:pgPort:backupPort", "zoneId", "ip", "pgUrl",
"backupUrl"} (built at lib/shard.js:39-54).

Invariants encoded by the reference's history annotator
(lib/adm.js:2296-2416):
  * generation never decreases;
  * a new primary must have been the previous sync, and bumps generation;
  * a generation bump without a primary change means the primary selected
    a new sync;
  * a sync change without a generation bump is an error;
  * multi-peer mode -> singleton mode is an unsupported transition.
"""

from __future__ import annotations


ClusterState = dict   # JSON-shaped; helpers below
PeerInfo = dict

INITIAL_WAL = "0/0000000"


def peer_info_from_active(active: dict) -> PeerInfo:
    """Build the PeerInfo stored in cluster state from an election-member
    record ({id, ...data} as emitted by ConsensusMgr.active)."""
    return {
        "id": active["id"],
        "zoneId": active.get("zoneId", active["id"]),
        "ip": active.get("ip"),
        "pgUrl": active.get("pgUrl"),
        "backupUrl": active.get("backupUrl"),
    }


def role_of(state: ClusterState | None, peer_id: str) -> str | None:
    """'primary' | 'sync' | 'async' | 'deposed' | None."""
    if not state:
        return None
    if state.get("primary") and state["primary"]["id"] == peer_id:
        return "primary"
    if state.get("sync") and state["sync"]["id"] == peer_id:
        return "sync"
    for a in state.get("async") or []:
        if a["id"] == peer_id:
            return "async"
    for d in state.get("deposed") or []:
        if d["id"] == peer_id:
            return "deposed"
    return None


def async_index_of(state: ClusterState, peer_id: str) -> int | None:
    for i, a in enumerate(state.get("async") or []):
        if a["id"] == peer_id:
            return i
    return None


def parse_lsn(lsn: str) -> int:
    """'16/B374D848' -> 64-bit int (pg-lsn parity, used at
    lib/postgresMgr.js:2390-2555 for catch-up checks)."""
    try:
        hi, lo = lsn.strip().split("/")
        return (int(hi, 16) << 32) | int(lo, 16)
    except (ValueError, AttributeError):
        raise ValueError("bad lsn: %r" % (lsn,)) from None


def compare_lsn(a: str, b: str) -> int:
    """-1, 0, 1 as a <, ==, > b."""
    ia, ib = parse_lsn(a), parse_lsn(b)
    return (ia > ib) - (ia < ib)


def frozen(state: ClusterState) -> bool:
    return bool(state.get("freeze"))


def validate_transition(old: ClusterState | None,
                        new: ClusterState) -> list[str]:
    """Check the annotator-encoded invariants; returns a list of violation
    strings (empty = legal).  Used by tests and debug assertions."""
    problems: list[str] = []
    if old is None:
        return problems
    og, ng = old.get("generation", 0), new.get("generation", 0)
    if ng < og:
        problems.append("generation went backwards (%d -> %d)" % (og, ng))
    try:
        if compare_lsn(new.get("initWal", INITIAL_WAL),
                       old.get("initWal", INITIAL_WAL)) < 0:
            # initWal is the WAL position at generation start; a takeover
            # stamps the taker's xlog, which the xlog-diverge guard keeps
            # at/above the previous generation's mark — going backwards
            # means a peer that never replicated this generation seized
            # the primary role (docs/xlog-diverge.md)
            problems.append("initWal went backwards (%s -> %s)"
                            % (old.get("initWal"), new.get("initWal")))
    except ValueError:
        problems.append("unparseable initWal (%r -> %r)"
                        % (old.get("initWal"), new.get("initWal")))
    if not old.get("oneNodeWriteMode") and new.get("oneNodeWriteMode"):
        problems.append("multi-peer -> singleton transition is unsupported")
    op, np_ = old.get("primary"), new.get("primary")
    osync, nsync = old.get("sync"), new.get("sync")
    if op and np_ and op["id"] != np_["id"]:
        if ng == og:
            problems.append("new primary but same generation")
        if osync is None or np_["id"] != osync["id"]:
            problems.append("new primary was not previous sync")
    elif ng > og and not old.get("oneNodeWriteMode"):
        same_sync = (osync is not None and nsync is not None
                     and osync["id"] == nsync["id"])
        if same_sync:
            problems.append("generation bumped but primary and sync "
                            "unchanged")
    elif ng == og:
        sync_changed = ((osync is None) != (nsync is None)
                        or (osync is not None and nsync is not None
                            and osync["id"] != nsync["id"]))
        if sync_changed:
            problems.append("sync changed without generation bump")
    return problems

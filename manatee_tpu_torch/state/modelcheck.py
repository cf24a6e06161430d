"""Explicit-state model checker for the cluster state machine.

The port's copy of manatee_tpu/state/modelcheck.py: the same stand-ins,
configurations, world and replay-based explorer (the oracle), driving
the port's copy of the machine; ``main`` runs the oracle or the array
engine (``--engine torch``, mc_array.py) on the card or the CPU.

SURVEY.md §7 ranks the state machine's safety invariants as the hardest
part of the rebuild and names property-style exploration over event
interleavings as the biggest quality lever over the reference (which
outsources the logic to the `manatee-state-machine` dependency and tests
it only through whole-cluster integration runs).  tests/test_soak.py
samples random interleavings; this module goes further and enumerates
them exhaustively up to a bounded depth.

It drives the REAL ``PeerStateMachine`` (manatee_tpu/state/machine.py) —
not a re-implementation — through deterministic checker-owned stand-ins
for the consensus manager and the PG manager:

* ``MCStore`` is the durable coordination state (the `state` znode plus
  election membership) with ZooKeeper CAS semantics: a write succeeds
  only when the writer's expected version matches
  (lib/zookeeperMgr.js:605-630).
* ``MCZk`` is one peer's *view* of the store.  Views go stale and are
  refreshed only by an explicit explorer action, which models watch
  delivery lag more adversarially than production (where the watch and
  the cache update arrive together).
* ``MCPg`` records reconfigure targets and serves a settable xlog
  position, like the unit suite's SimPg.

The explorer then runs a breadth-first search over action sequences —
peer evaluations, view refreshes, crashes, rebuilt rejoins, xlog
catch-up, operator promote/freeze writes, and network partitions — with
memoization on a canonical hash of the full system state.  At every
reached state it checks:

safety (checked on every store write, at every node):
  * every transition satisfies the generation discipline encoded by the
    reference's history annotator (validate_transition,
    lib/adm.js:2296-2416);
  * the durable generation never decreases;
  * at most one live peer is configured writable-primary AND named
    primary by the durable state;
  * a takeover only ever installs the previous sync as primary, and
    never while the taker's xlog is behind the generation's initWal
    (docs/xlog-diverge.md);
  * no evaluation raises an unexpected exception.

liveness (checked by running a fair schedule from every reached state):
  * the fair schedule reaches a fixpoint (no livelock/wedge);
  * a dead primary with a live, caught-up sync is always replaced;
  * a live primary with no sync appoints one whenever a candidate is
    alive;
  * every live peer's PG target matches its durable role, and the
    upstream/downstream replication chain is exactly the daisy chain the
    state describes (primary -> sync -> async[0] -> async[1] ...).

Run deep explorations from the CLI::

    python3 -m manatee_tpu_torch.state.modelcheck --config all --depth 7

The pytest wrapper (tests/test_model_check.py) runs bounded
configurations on every `make test`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
import time
from collections import deque
from dataclasses import dataclass, field

from manatee_tpu_torch.state import canon
from manatee_tpu_torch.state._support import (
    BadVersionError,
    ConnectionLossError,
    NodeExistsError,
)
from manatee_tpu_torch.state.machine import PeerStateMachine
from manatee_tpu_torch.state.types import (
    INITIAL_WAL,
    compare_lsn,
    frozen,
    role_of,
    validate_transition,
)

FUTURE_EXPIRY = "2099-01-01T00:00:00.000Z"
PAST_EXPIRY = "2000-01-01T00:00:00.000Z"

_ORIG_SLEEP = asyncio.sleep


async def _fast_sleep(delay, result=None):
    """Injected as machine._sleep during exploration: keep the yield
    point (tasks must still get scheduled) but drop the wall-clock wait
    so the machine's retry/backoff paths run at full speed."""
    return await _ORIG_SLEEP(0)


# ---------------------------------------------------------------------------
# deterministic stand-ins


class MCStore:
    """Durable coordination state with ZooKeeper CAS semantics."""

    def __init__(self):
        self.state: dict | None = None
        self.version: int | None = None
        self.actives: list[dict] = []     # election order = seq order
        self.seq = 0
        self.writes = 0
        self.violations: list[str] = []

    def join(self, info: dict) -> None:
        self.seq += 1
        rec = dict(info)
        rec["seq"] = self.seq
        self.actives.append(rec)

    def leave(self, peer_id: str) -> None:
        self.actives = [a for a in self.actives if a["id"] != peer_id]

    def apply(self, state: dict, new_version: int, who: str) -> None:
        for p in validate_transition(self.state, state):
            self.violations.append("%s wrote illegal transition: %s"
                                   % (who, p))
        if (self.state is not None and frozen(self.state)
                and not who.startswith("operator")):
            # frozen clusters make no automatic transitions
            # (docs/user-guide.md freeze semantics); only operator
            # writes (unfreeze, reap, promote requests) may land
            self.violations.append(
                "%s wrote state while the cluster was frozen" % who)
        if (self.state is not None
                and state.get("generation", 0)
                < self.state.get("generation", 0)):
            self.violations.append("%s: generation went backwards" % who)
        self.state = state
        self.version = new_version
        self.writes += 1

    def operator_edit(self, mutate, who: str) -> None:
        """An operator read-modify-CAS (freeze, promote, reap...)."""
        if self.state is None:
            return
        st = json.loads(json.dumps(self.state))
        mutate(st)
        self.apply(st, self.version + 1, who)


class MCZk:
    """One peer's (possibly stale) view of the store, presenting the
    narrow interface PeerStateMachine consumes (the zkinterface of
    lib/shard.js:59-71)."""

    def __init__(self, store: MCStore, peer):
        self._store = store
        self._peer = peer
        self.cluster_state: dict | None = None
        self.cluster_state_version: int | None = None
        self.active: list[dict] = []

    def on(self, event, cb):              # events are explorer-driven
        pass

    def view_current(self) -> bool:
        return (self.cluster_state_version == self._store.version
                and [a["id"] for a in self.active]
                == [a["id"] for a in self._store.actives])

    def sync_view(self) -> None:
        if self._peer.partitioned:
            return
        self.cluster_state = (None if self._store.state is None
                              else json.loads(json.dumps(self._store.state)))
        self.cluster_state_version = self._store.version
        self.active = [dict(a) for a in self._store.actives]
        self._peer.view_epoch += 1

    async def put_cluster_state(self, state: dict, *,
                                expected_version: int | None = None) -> None:
        if self._peer.partitioned:
            raise ConnectionLossError("partitioned from coordination")
        version = (expected_version if expected_version is not None
                   else self.cluster_state_version)
        if version is None:
            if self._store.state is not None:
                raise NodeExistsError("state already exists")
            new_version = 0
        else:
            if self._store.version != version:
                raise BadVersionError(
                    "expected v%s, have v%s" % (version, self._store.version))
            new_version = version + 1
        self._store.apply(json.loads(json.dumps(state)), new_version,
                          self._peer.name)
        # a successful write updates the writer's own cache
        # (coord/manager.py put_cluster_state)
        self.cluster_state = json.loads(json.dumps(state))
        self.cluster_state_version = new_version

    async def refresh_cluster_state(self) -> None:
        if self._peer.partitioned:
            raise ConnectionLossError("partitioned from coordination")
        self.cluster_state = (None if self._store.state is None
                              else json.loads(json.dumps(self._store.state)))
        self.cluster_state_version = self._store.version
        self._peer.view_epoch += 1


class MCPg:
    """PG manager stand-in: records the applied reconfigure target and
    serves a settable xlog position."""

    def __init__(self, xlog: str):
        self.cfg: dict | None = None
        self.xlog = xlog

    async def reconfigure(self, cfg: dict) -> None:
        self.cfg = cfg

    async def stop(self) -> None:
        self.cfg = {"role": "none"}

    async def get_xlog_location(self) -> str:
        return self.xlog


class MCPeer:
    def __init__(self, store: MCStore, name: str, xlog: str,
                 singleton: bool = False):
        self.name = name
        self.ident = "%s:5432:12345" % name
        self.info = {
            "id": self.ident, "zoneId": name, "ip": name,
            "pgUrl": "tcp://postgres@%s:5432/postgres" % name,
            "backupUrl": "http://%s:12345" % name,
        }
        self.alive = True
        self.partitioned = False
        # has this peer EVALUATED since it last learned new state?  the
        # split-brain check may only fire once it has: between seeing a
        # takeover and acting on it, a stale-primary window is the same
        # unavoidable transient the reference has
        self.view_epoch = 0
        self.eval_epoch = -1
        self.zk = MCZk(store, self)
        self.pg = MCPg(xlog)
        self.sm = PeerStateMachine(zk=self.zk, pg=self.pg,
                                   self_info=self.info,
                                   singleton=singleton,
                                   takeover_grace=0.0)


# ---------------------------------------------------------------------------
# configurations


@dataclass
class MCConfig:
    name: str
    peers: tuple = ("A", "B", "C")
    # xlog the first joiner (the bootstrap primary) starts at; appointing
    # a new sync stamps initWal with this, arming the takeover guard
    primary_xlog: str = "0/0001000"
    standby_xlog: str = "0/0001000"
    max_kills: int = 2
    max_rejoins: int = 0
    allow_promote: bool = False
    allow_freeze: bool = False
    allow_partition: bool = False
    # peers killed (then fair-settled) during boot, before exploration:
    # lets a config start from a later generation, e.g. with a nonzero
    # initWal arming the takeover guard.  Not counted against max_kills.
    boot_kills: tuple = ()
    depth: int = 5
    description: str = ""


CONFIGS = {
    c.name: c for c in [
        MCConfig(
            name="deaths3",
            description="3 peers; every interleaving of up to two "
                        "crashes with stale views and CAS races"),
        MCConfig(
            name="behind",
            peers=("A", "B", "C", "D"),
            standby_xlog="0/0000500", boot_kills=("B",), max_kills=1,
            description="boots past a sync re-appointment so initWal is "
                        "ahead of the standbys: the xlog takeover guard "
                        "must hold until an explicit catch-up event"),
        MCConfig(
            name="rejoin",
            max_kills=2, max_rejoins=2,
            description="crashed peers rejoin REBUILT (operator reap + "
                        "restore-to-initWal) in every order"),
        MCConfig(
            name="promote",
            peers=("A", "B", "C", "D"), max_kills=1, allow_promote=True,
            description="operator promote requests (sync, async swap, "
                        "already-expired) racing a crash"),
        MCConfig(
            name="freeze",
            max_kills=2, allow_freeze=True,
            description="freeze/unfreeze racing crashes: frozen clusters "
                        "must make no automatic transitions"),
        MCConfig(
            name="partition",
            max_kills=1, allow_partition=True,
            description="a partitioned (alive but unreachable) peer: "
                        "stale writes must lose CAS, the healed peer "
                        "must adopt the durable topology"),
    ]
}


# ---------------------------------------------------------------------------
# the world


class World:
    def __init__(self, config: MCConfig):
        self.config = config
        self.store = MCStore()
        self.peers: dict[str, MCPeer] = {}
        self.kills = 0
        self.rejoins = 0
        self.violations: list[str] = []

    # -- construction --

    async def boot(self) -> None:
        for name in self.config.peers:
            xlog = (self.config.primary_xlog if name == self.config.peers[0]
                    else self.config.standby_xlog)
            await self._add_peer(name, xlog)
        await self.fair_settle()
        if self.store.state is None:
            self.violations.append("bootstrap never declared a cluster")
        for name in self.config.boot_kills:
            p = self.peers[name]
            p.alive = False
            self.store.leave(p.ident)
            await self.fair_settle()

    async def _add_peer(self, name: str, xlog: str) -> MCPeer:
        p = MCPeer(self.store, name, xlog)
        self.peers[name] = p
        self.store.join(p.info)
        p.zk.sync_view()
        p.sm._on_zk_init({"active": p.zk.active})
        p.sm.pg_init()
        return p

    # -- actions --

    def enabled(self) -> list[tuple]:
        acts: list[tuple] = []
        alive = [p for p in self.peers.values() if p.alive]
        st = self.store.state
        for p in alive:
            acts.append(("eval", p.name))
            if not p.partitioned and not p.zk.view_current():
                acts.append(("refresh", p.name))
            if st is not None and not p.partitioned and \
                    compare_lsn(p.pg.xlog, st.get("initWal", INITIAL_WAL)) < 0:
                acts.append(("catchup", p.name))
        if self.kills < self.config.max_kills and len(alive) > 1:
            for p in alive:
                if not p.partitioned:
                    acts.append(("kill", p.name))
        if self.rejoins < self.config.max_rejoins:
            for name, p in self.peers.items():
                if not p.alive:
                    acts.append(("rejoin", name))
        if self.config.allow_partition:
            for p in alive:
                if not p.partitioned:
                    acts.append(("partition", p.name))
                else:
                    acts.append(("heal", p.name))
        if st is not None and "promote" not in st and self.config.allow_promote:
            if st.get("sync"):
                acts.append(("promote_sync",))
                acts.append(("promote_expired",))
            if st.get("async"):
                acts.append(("promote_async", 0))
                if len(st["async"]) > 1:
                    acts.append(("promote_async", 1))
        if self.config.allow_freeze and st is not None:
            acts.append(("unfreeze",) if frozen(st) else ("freeze",))
        return acts

    async def do(self, action: tuple) -> None:
        kind = action[0]
        if kind == "eval":
            await self._eval(self.peers[action[1]])
        elif kind == "refresh":
            p = self.peers[action[1]]
            p.zk.sync_view()
            p.sm._witness(p.zk.active)
        elif kind == "catchup":
            st = self.store.state
            if st is not None:
                self.peers[action[1]].pg.xlog = st.get("initWal", INITIAL_WAL)
        elif kind == "kill":
            p = self.peers[action[1]]
            p.alive = False
            self.kills += 1
            self.store.leave(p.ident)
        elif kind == "rejoin":
            await self._rejoin(action[1])
        elif kind == "partition":
            p = self.peers[action[1]]
            p.partitioned = True
            self.store.leave(p.ident)     # session expires
        elif kind == "heal":
            p = self.peers[action[1]]
            p.partitioned = False
            self.store.join(p.info)       # new session
            p.zk.sync_view()
            p.sm._on_session_rebuilt({"active": p.zk.active})
        elif kind == "promote_sync":
            def mut(st):
                st["promote"] = {"id": st["sync"]["id"], "role": "sync",
                                 "generation": st["generation"],
                                 "expireTime": FUTURE_EXPIRY}
            self.store.operator_edit(mut, "operator")
        elif kind == "promote_expired":
            def mut(st):
                st["promote"] = {"id": st["sync"]["id"], "role": "sync",
                                 "generation": st["generation"],
                                 "expireTime": PAST_EXPIRY}
            self.store.operator_edit(mut, "operator")
        elif kind == "promote_async":
            idx = action[1]

            def mut(st):
                asyncs = st.get("async") or []
                if idx < len(asyncs):
                    st["promote"] = {"id": asyncs[idx]["id"], "role": "async",
                                     "asyncIndex": idx,
                                     "generation": st["generation"],
                                     "expireTime": FUTURE_EXPIRY}
            self.store.operator_edit(mut, "operator")
        elif kind == "freeze":
            self.store.operator_edit(
                lambda st: st.__setitem__(
                    "freeze", {"date": "2026-01-01T00:00:00Z",
                               "reason": "modelcheck"}), "operator")
        elif kind == "unfreeze":
            self.store.operator_edit(
                lambda st: st.pop("freeze", None), "operator")
        else:
            raise ValueError("unknown action %r" % (action,))
        self._check_safety()

    async def _rejoin(self, name: str) -> None:
        """A crashed peer returns REBUILT: the operator reaped its
        deposed entry and the restore brought its xlog to the current
        initWal (what manatee-adm rebuild leaves behind,
        lib/adm.js:1533-1539)."""
        self.rejoins += 1
        st = self.store.state
        iw = (st or {}).get("initWal", INITIAL_WAL)
        ident = "%s:5432:12345" % name
        if st is not None and any(
                d["id"] == ident for d in st.get("deposed") or []):
            self.store.operator_edit(
                lambda s: s.__setitem__(
                    "deposed", [d for d in s.get("deposed") or []
                                if d["id"] != ident]), "operator-reap")
        await self._add_peer(name, iw)

    async def _eval(self, p: MCPeer) -> None:
        # the epoch this evaluation actually reasons about is the one at
        # entry: a CAS loss refreshes the view MID-eval (bumping
        # view_epoch), and the decision already taken used the old view —
        # only the next evaluation acts on the refreshed one
        epoch = p.view_epoch
        try:
            await p.sm._evaluate()
        except asyncio.CancelledError:
            raise
        except ConnectionLossError:
            pass                          # partitioned: expected
        except Exception as exc:          # noqa: BLE001 - report, don't die
            self.violations.append(
                "%s evaluation crashed: %r" % (p.name, exc))
        await self._settle_tasks()
        p.eval_epoch = max(p.eval_epoch, epoch)

    async def _settle_tasks(self) -> None:
        for _ in range(20):
            pending = [p.sm._pg_task for p in self.peers.values()
                       if p.sm._pg_task is not None
                       and not p.sm._pg_task.done()]
            if not pending:
                return
            await _ORIG_SLEEP(0)
        self.violations.append("pg task failed to settle")

    # -- invariants --

    def _check_safety(self) -> None:
        st = self.store.state
        if st is None:
            return
        prims = [p for p in self.peers.values()
                 if p.alive and not p.partitioned
                 and p.sm._pg_target
                 and p.sm._pg_target.get("role") == "primary"]
        for p in prims:
            named = bool(st.get("primary")
                         and st["primary"]["id"] == p.ident)
            if named:
                # the named primary's xlog must satisfy the generation's
                # initWal
                if compare_lsn(p.pg.xlog,
                               st.get("initWal", INITIAL_WAL)) < 0:
                    self.violations.append(
                        "%s is primary with xlog %s behind initWal %s"
                        % (p.name, p.pg.xlog, st.get("initWal")))
                continue
            # an UN-named peer still configured writable-primary is the
            # split-brain transient: tolerable while its view predates
            # the durable state, or while it has seen the takeover but
            # not yet evaluated (the reference tolerates the same
            # window, bounded by synchronous commit refusing to ack).
            # A peer that EVALUATED a current-or-newer view must have
            # stepped down.
            view_gen = (p.zk.cluster_state or {}).get("generation", -1)
            if (view_gen >= st.get("generation", 0)
                    and p.eval_epoch >= p.view_epoch):
                self.violations.append(
                    "%s configured primary with a current view (gen %s) "
                    "but the durable primary is %s"
                    % (p.name, view_gen,
                       (st.get("primary") or {}).get("id")))

    # -- fair schedule / liveness --

    async def fair_settle(self, rounds: int = 30) -> bool:
        """Deliver everything and evaluate everyone until fixpoint."""
        for _ in range(rounds):
            for p in self.peers.values():
                if p.alive and not p.partitioned:
                    p.zk.sync_view()
                    p.sm._witness(p.zk.active)
            writes = self.store.writes
            for p in self.peers.values():
                if p.alive and not p.partitioned:
                    await self._eval(p)
            if self.store.writes == writes and all(
                    p.zk.view_current() for p in self.peers.values()
                    if p.alive and not p.partitioned):
                return True
        return False

    def _expected_pg_role(self, st: dict, ident: str) -> str:
        role = role_of(st, ident)
        if st.get("oneNodeWriteMode") and role != "primary":
            return "none"
        if role in ("primary", "sync", "async"):
            return role
        return "none"

    async def check_liveness(self) -> None:
        """Run the fair schedule to fixpoint, then assert convergence."""
        # replication always catches up eventually under a fair schedule
        st = self.store.state
        if st is not None:
            iw = st.get("initWal", INITIAL_WAL)
            for p in self.peers.values():
                if p.alive and compare_lsn(p.pg.xlog, iw) < 0:
                    p.pg.xlog = iw
        if not await self.fair_settle():
            self.violations.append("fair schedule never reached fixpoint")
            return
        st = self.store.state
        alive = {p.ident: p for p in self.peers.values()
                 if p.alive and not p.partitioned}
        if st is None:
            if len(alive) >= 2:
                self.violations.append("no cluster despite %d live peers"
                                       % len(alive))
            return
        if not frozen(st):
            primary_alive = st.get("primary") and \
                st["primary"]["id"] in alive
            sync = st.get("sync")
            if not primary_alive and sync and sync["id"] in alive:
                self.violations.append(
                    "dead primary %s not replaced by live sync %s"
                    % (st["primary"]["id"], sync["id"]))
            if primary_alive and (sync is None or sync["id"] not in alive):
                candidates = [i for i in alive
                              if i != st["primary"]["id"]
                              and role_of(st, i) != "deposed"]
                if candidates:
                    self.violations.append(
                        "primary alive with no live sync despite "
                        "candidates %s" % candidates)
        # role consistency + replication chain
        for ident, p in alive.items():
            want = self._expected_pg_role(st, ident)
            got = (p.sm._pg_target or {}).get("role")
            if got != want:
                self.violations.append(
                    "%s pg target %r but durable role %r"
                    % (p.name, got, want))
        self._check_chain(st, alive)

    def _check_chain(self, st: dict, alive: dict) -> None:
        """The applied upstream/downstream links must spell the daisy
        chain primary -> sync -> async[0] -> async[1] -> ...
        (docs/user-guide.md:69-90)."""
        def target(ident):
            p = alive.get(ident)
            return (p.sm._pg_target or {}) if p else {}

        prim, sync = st.get("primary"), st.get("sync")
        asyncs = st.get("async") or []
        if prim and prim["id"] in alive and sync:
            down = target(prim["id"]).get("downstream")
            if (down or {}).get("id") != sync["id"]:
                self.violations.append(
                    "primary downstream %r != sync %s" % (down, sync["id"]))
        if sync and sync["id"] in alive and prim:
            up = target(sync["id"]).get("upstream")
            if (up or {}).get("id") != prim["id"]:
                self.violations.append(
                    "sync upstream %r != primary %s" % (up, prim["id"]))
        for i, a in enumerate(asyncs):
            if a["id"] not in alive:
                continue
            want_up = sync if i == 0 else asyncs[i - 1]
            up = target(a["id"]).get("upstream")
            if want_up and (up or {}).get("id") != want_up["id"]:
                self.violations.append(
                    "async[%d] upstream %r != %s"
                    % (i, up, want_up["id"]))

    # -- canonical hash --

    # the semantic-state quotient lives in canon.py, shared with the
    # array engine (mc_array.py) so the two engines cannot silently
    # disagree on what "same state" means
    _OBS_KEYS = canon.OBS_KEYS

    @staticmethod
    def _sem(state):
        """Semantic projection of a cluster state for hashing (see
        canon.sem_state; kept as a method for back-compat)."""
        return canon.sem_state(state)

    def canon(self) -> dict:
        return canon.world_canon(self)

    def digest(self) -> str:
        return canon.digest_of(canon.world_canon(self))


# ---------------------------------------------------------------------------
# the explorer


@dataclass
class MCResult:
    config: str
    nodes: int = 0            # states EXPANDED (popped from the queue)
    transitions: int = 0
    depth_reached: int = 0
    seconds: float = 0.0
    complete: bool = True     # False when max_nodes truncated the search
    violations: list = field(default_factory=list)
    states: int = 0           # distinct semantic states DISCOVERED
    engine: str = "python"

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def states_per_sec(self) -> float:
        return self.states / self.seconds if self.seconds > 0 else 0.0


async def _replay(config: MCConfig, seq: tuple) -> World:
    w = World(config)
    await w.boot()
    for action in seq:
        await w.do(action)
    return w


def _check_world(loop, w: World) -> list[str]:
    """Safety violations accumulated along the trace plus the liveness
    verdict from this state.  Mutates *w* (the fair schedule runs), so
    callers needing the pre-check world must replay again."""
    bad = list(w.violations + w.store.violations)
    loop.run_until_complete(w.check_liveness())
    bad += [v for v in w.violations + w.store.violations if v not in bad]
    return bad


def explore(config: MCConfig, depth: int | None = None,
            max_nodes: int = 200_000, collect=None,
            progress: bool = False) -> MCResult:
    """BFS over action interleavings with memoization on the canonical
    world digest.  Worlds are rebuilt by replaying the action sequence
    (the machine is deterministic), so counterexamples come out as
    minimal-length traces.  Each discovered state is checked exactly
    once, at discovery; the pop replays it only to expand children.

    *collect*, when given, is called as ``collect(digest, seq, bad)``
    for every discovered semantic state (root included) — the hook the
    differential oracle uses to compare reachable-state sets and
    violation verdicts against the array engine.  *progress* emits
    periodic states/sec + frontier-size lines to stderr."""
    depth = config.depth if depth is None else depth
    res = MCResult(config=config.name)
    t0 = time.monotonic()
    last_report = t0
    logging.getLogger("manatee.state").setLevel(logging.CRITICAL)
    from manatee_tpu_torch.state import machine as _machine
    patched, _machine._sleep = _machine._sleep, _fast_sleep
    try:
        loop = asyncio.new_event_loop()
        try:
            seen: set[str] = set()
            # each queue entry carries the action set captured at
            # discovery (before the liveness fair schedule mutated the
            # world), so a pop never needs to re-replay its own node
            queue: deque[tuple] = deque()
            root = loop.run_until_complete(_replay(config, ()))
            root_digest = root.digest()
            seen.add(root_digest)
            root_actions = root.enabled()
            root_bad = _check_world(loop, root)
            if collect is not None:
                collect(root_digest, (), root_bad)
            if _record(res, (), root_bad) and depth > 0:
                queue.append(((), root_actions))
            while queue:
                if res.nodes >= max_nodes:
                    res.complete = False
                    break
                seq, actions = queue.popleft()
                res.nodes += 1
                if progress and time.monotonic() - last_report >= 2.0:
                    last_report = time.monotonic()
                    el = last_report - t0
                    print("[modelcheck %s/python] states=%d frontier=%d "
                          "depth<=%d %.0f states/s"
                          % (config.name, len(seen), len(queue),
                             res.depth_reached, len(seen) / el),
                          file=sys.stderr, flush=True)
                for action in actions:
                    res.transitions += 1
                    child_seq = seq + (action,)
                    child = loop.run_until_complete(
                        _replay(config, child_seq))
                    d = child.digest()
                    if d in seen:
                        continue
                    seen.add(d)
                    res.depth_reached = max(res.depth_reached,
                                            len(child_seq))
                    child_actions = child.enabled()
                    bad = _check_world(loop, child)
                    if collect is not None:
                        collect(d, child_seq, bad)
                    ok = _record(res, child_seq, bad)
                    if ok and len(child_seq) < depth:
                        queue.append((child_seq, child_actions))
            res.states = len(seen)
        finally:
            loop.close()
    finally:
        _machine._sleep = patched
    res.seconds = time.monotonic() - t0
    return res


def _record(res: MCResult, seq: tuple, bad: list[str]) -> bool:
    """Record violations for a trace; returns True when clean."""
    if bad:
        res.violations.append({"trace": list(seq), "problems": bad})
        return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="exhaustively model-check the cluster state machine")
    ap.add_argument("--config", default="all",
                    choices=[*sorted(CONFIGS), "all"],
                    help="configuration name or 'all'")
    ap.add_argument("--depth", type=int, default=None,
                    help="override the per-config interleaving depth")
    ap.add_argument("--max-nodes", type=int, default=200_000)
    ap.add_argument("--engine", default="python",
                    choices=("python", "torch"),
                    help="python: replay-based BFS (the oracle); torch: "
                         "the array engine, the whole frontier expanded "
                         "at once by the hand kernels (mc_array.py)")
    ap.add_argument("--device", default=None,
                    help="where --engine torch runs: the CUDA card unless "
                         "this says otherwise (cpu runs the plain torch "
                         "version)")
    ap.add_argument("--progress", action="store_true",
                    help="periodic states/sec + frontier-size lines on "
                         "stderr")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON result line per config (the "
                         "CI artifact format)")
    args = ap.parse_args(argv)

    names = sorted(CONFIGS) if args.config == "all" else [args.config]
    rc = 0
    for name in names:
        cfg = CONFIGS[name]
        if args.engine == "torch":
            from manatee_tpu_torch.state import mc_array
            res = mc_array.explore_torch(cfg, depth=args.depth,
                                         max_nodes=args.max_nodes,
                                         progress=args.progress,
                                         device=args.device)
        else:
            res = explore(cfg, depth=args.depth,
                          max_nodes=args.max_nodes,
                          progress=args.progress)
        status = "ok" if res.ok else "VIOLATIONS"
        if not res.complete:
            # an incomplete sweep must not read as a pass: the whole
            # point of the tool is exhaustiveness within the bound
            status += "/TRUNCATED"
            rc = 1
        if args.as_json:
            print(json.dumps({
                "config": name, "engine": res.engine, "ok": res.ok,
                "complete": res.complete, "nodes": res.nodes,
                "states": res.states, "transitions": res.transitions,
                "depth": res.depth_reached,
                "seconds": round(res.seconds, 3),
                "states_per_sec": round(res.states_per_sec, 1),
                "violations": len(res.violations),
            }))
        else:
            print("%-10s %-10s nodes=%-6d transitions=%-7d depth=%d  "
                  "%.1fs  (%s)"
                  % (name, status, res.nodes, res.transitions,
                     res.depth_reached, res.seconds, cfg.description))
        for v in res.violations[:5]:
            rc = 1
            print("  trace: %s" % (v["trace"],))
            for p in v["problems"]:
                print("    - %s" % p)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""PeerStateMachine — the topology decision engine.

The port's copy of manatee_tpu/state/machine.py, line for line, with its
imports pointed at the port's own ``types`` and ``_support``: the model
checker drives this copy, and tests/test_torch_mc_parity.py::
test_oracle_explores_what_the_reference_explores holds its exploration
to the control plane's.

The reference outsources this to the `manatee-state-machine` dependency
(consumed at lib/shard.js:59-71); its behavior is re-derived here from the
observable schema, the history annotations (lib/adm.js:2296-2416), the
man-page promote semantics (docs/man/manatee-adm.md:346-419), the user
guide (docs/user-guide.md:69-90, 330-400), and the integration scenarios
(test/integ.test.js).

Inputs: the consensus manager's events ('init', 'activeChange',
'clusterStateChange' — lib/zookeeperMgr.js:44-52) and the PG manager's
'init' event (lib/postgresMgr.js:401-421).  Outputs:
``zk.put_cluster_state()`` and ``pg.reconfigure()/stop()``.

Decision rules:

* BOOTSTRAP — no cluster state yet:
  - singleton (ONWM): the configured peer writes gen-0 state with itself
    as primary, no sync, and an auto-freeze (moving ONWM->HA requires an
    explicit unfreeze, docs/user-guide.md:367-387);
  - normal: the peer with the LOWEST election sequence declares the
    cluster once >= 2 peers are present: primary = itself, sync = next
    in election order, rest = asyncs; generation 0, initWal '0/0000000'
    (the same initial shape state-backfill writes, lib/adm.js:1266-1276).

* PRIMARY duties (docs/user-guide.md:86-90 "the primary manages
  topology"): appoint a replacement sync from the asyncs when the sync
  dies (generation bump, initWal = its current xlog); add newly-joined
  peers as asyncs and remove dead asyncs (no bump); act on promote
  requests for asyncs.

* SYNC duties: take over when the primary dies (generation bump, old
  primary -> deposed, first async -> new sync), but ONLY if its own xlog
  has reached state.initWal (it actually replicated from this
  generation); act on a promote request naming itself (deposes a live
  primary).

* FROZEN clusters make no automatic transitions (docs/user-guide.md
  freeze section).

* A peer that finds itself deposed stops PostgreSQL and waits for the
  operator (docs/user-guide.md:337-365).  In ONWM, a peer that is not
  the primary shuts down (docs/user-guide.md:369-372).
"""

from __future__ import annotations

import asyncio
import datetime
import logging
import time
from typing import Callable

from manatee_tpu_torch.state._support import (
    BadVersionError,
    NodeExistsError,
    bind_parent,
    bind_trace,
    fault_point,
    get_journal,
    get_registry,
    get_span_store,
    hlc_now,
    iso_ms as _now_iso,
    merge_remote,
    new_trace_id,
    span,
)
from manatee_tpu_torch.state.types import (
    INITIAL_WAL,
    ClusterState,
    compare_lsn,
    frozen,
    peer_info_from_active,
    role_of,
)

log = logging.getLogger("manatee.state")

RETRY_DELAY = 1.0

_REG = get_registry()
# durable state writes by this peer (was the status server's ad-hoc
# listener counter; same exported name, now registry-owned)
_TRANSITIONS = _REG.counter(
    "state_transitions_total", "durable state writes made by this peer")
_TRANSITION_DUR = _REG.histogram(
    "transition_write_duration_seconds",
    "latency of the durable cluster-state CAS write")
# THE headline SLI: primary-loss-detection -> new-primary-writable,
# observed by the taking-over sync (detection stamped in _sync_duties,
# completion on the PG manager's 'writable' event)
# Buckets resized for the sub-second regime the bench now lives in
# (~0.5-0.8s end to end; the in-shard portion is tens of ms): the
# original grid was cut for the 30s reference budget and lumped every
# modern failover into its first two buckets.  Name and unit are
# unchanged, so no deprecated alias is owed under the metric naming
# contract; the tail keeps the old coarse steps so a restore-bound
# failover still lands in a finite bucket.
_FAILOVER_DUR = _REG.histogram(
    "failover_duration_seconds",
    "primary loss detected by the sync until the new primary re-enabled "
    "writes",
    buckets=(0.05, 0.1, 0.15, 0.25, 0.4, 0.6, 0.8, 1.0, 1.5, 2.5, 5.0,
             10.0, 30.0, 60.0, 120.0, 300.0))


# Injection point for the model checker: explore() swaps this for a
# zero-delay sleep so retry/backoff paths run at full speed WITHOUT
# monkeypatching the process-global asyncio.sleep (which would silently
# strip delays from unrelated asyncio code in the same process).
_sleep = asyncio.sleep


def _retry_backoff(op: str):
    """A jittered-backoff helper whose sleeps route through the
    swappable :data:`_sleep`, so the model checker's zero-delay
    exploration still covers every retry path at full speed."""
    from manatee_tpu_torch.state._support import Backoff
    return Backoff(op, base=RETRY_DELAY, cap=5 * RETRY_DELAY,
                   sleep_fn=lambda d: _sleep(d))


def _iso_to_ts(s: str) -> float:
    try:
        return datetime.datetime.fromisoformat(
            s.replace("Z", "+00:00")).timestamp()
    except ValueError:
        return 0.0


class PeerStateMachine:
    def __init__(self, *, zk, pg, self_info: dict,
                 singleton: bool = False,
                 takeover_grace: float = 0.0):
        """*zk* is a ConsensusMgr-shaped object (on/active/cluster_state/
        put_cluster_state); *pg* provides async reconfigure(cfg), stop(),
        get_xlog_location() (the pginterface of lib/shard.js:59-71);
        *self_info* is this peer's PeerInfo dict.

        *takeover_grace*: seconds after our own coordination init during
        which the sync will NOT treat the primary's absence as death.
        On a cold start the primary may simply not have joined yet —
        absence observed for less than a session timeout is not evidence
        of failure.  Wire it to the session timeout."""
        self.zk = zk
        self.pg = pg
        self.self_info = self_info
        self.self_id = self_info["id"]
        self.singleton = singleton
        self.takeover_grace = takeover_grace
        self._boot_time: float | None = None
        # peer ids seen alive in membership since our own init: a
        # disappearance we *witnessed* is death evidence (the failure
        # detector expired it while we watched), so the cold-start
        # absence-isn't-death grace does not apply to it
        self._witnessed: set[str] = set()

        self._zk_ready = False
        self._pg_ready = False
        self._closed = False
        self._notified_role: str | None = None
        self._kick = asyncio.Event()
        self._worker_task: asyncio.Task | None = None
        self._pg_task: asyncio.Task | None = None
        self._pg_target: dict | None = None
        self._pg_applied: dict | None = None
        # jittered retry schedules (reset on success): consecutive
        # failures back off instead of hammering a struggling database
        # or coordination service at a fixed cadence
        self._eval_retry = _retry_backoff("state.evaluate")
        self._pg_retry = _retry_backoff("pg.reconfigure")
        self._listeners: dict[str, list[Callable]] = {}
        # failover SLI bookkeeping: monotonic stamp of the moment this
        # peer (as sync) detected the primary's loss, and the trace id
        # of the takeover, cleared when the new primary is writable
        self._failover_t0: float | None = None
        self._failover_trace: str | None = None
        # the ROOT span of the failover tree: opened at loss detection,
        # closed when writes re-enable (the same window the SLI
        # histogram observes) — `manatee-adm trace` hangs the whole
        # cross-peer takeover under it
        self._failover_span = None
        # last foreign transition span we reacted to, so exactly one
        # state.evaluate span is recorded per observed transition (not
        # one per worker kick)
        self._reacted_span: str | None = None
        # the write-enable gate of an in-flight overlapped takeover:
        # created at promote start, opened when the CAS write lands,
        # reused across takeover retries so the running reconfigure is
        # not restarted per attempt
        self._takeover_gate: asyncio.Event | None = None

        zk.on("init", self._on_zk_init)
        zk.on("activeChange", self._on_active_change)
        zk.on("clusterStateChange", self._on_cluster_state)
        zk.on("sessionRebuilt", self._on_session_rebuilt)
        # 'writable' fires when the PG manager re-enables writes after
        # the downstream catches up — the end of the failover SLI.
        # getattr-guarded: unit-test fakes implement only the pg calls
        # the decision procedure needs.
        pg_on = getattr(pg, "on", None)
        if callable(pg_on):
            pg_on("writable", self._on_pg_writable)

    # ---- events out (role changes, shutdown requests) ----

    def on(self, event: str, cb: Callable) -> None:
        self._listeners.setdefault(event, []).append(cb)

    def _emit(self, event: str, payload=None) -> None:
        for cb in self._listeners.get(event, []):
            try:
                cb(payload)
            except Exception:
                log.exception("listener for %s failed", event)

    # ---- events in ----

    # Events only kick the worker; the evaluation reads state+version+
    # actives from the consensus manager in one event-loop step so the
    # CAS version always matches the snapshot the decision was computed
    # from.

    def _witness(self, actives: list[dict] | None) -> None:
        self._witnessed.update(a["id"] for a in actives or [])

    def _on_zk_init(self, payload: dict) -> None:
        self._zk_ready = True
        if self._boot_time is None:
            self._boot_time = asyncio.get_event_loop().time()
        self._witness((payload or {}).get("active"))
        self.kick()

    def _on_session_rebuilt(self, payload: dict) -> None:
        # after a session expiry/rebuild the absence-isn't-death grace
        # must re-arm: everyone just re-registered from scratch, so
        # prior sightings are void — but the rebuilt membership snapshot
        # counts as a fresh sighting (like the init payload), or a
        # primary that re-registered and later dies would wrongly get
        # the cold-start grace
        self._boot_time = asyncio.get_event_loop().time()
        self._witnessed.clear()
        self._witness((payload or {}).get("active"))
        # the failover clock rests on witnessed-death evidence, which a
        # rebuilt session voids along with the sightings themselves
        self._abort_failover_span("session rebuilt")
        self._failover_t0 = None
        self._failover_trace = None
        self.kick()

    def _on_active_change(self, actives: list[dict]) -> None:
        self._witness(actives)
        self.kick()

    def _on_cluster_state(self, _state: ClusterState) -> None:
        self.kick()

    @property
    def _state(self) -> ClusterState | None:
        return self.zk.cluster_state

    @property
    def _actives(self) -> list[dict]:
        return self.zk.active

    def pg_init(self) -> None:
        """Called once the PG manager is constructed and has reported its
        initial status (the 'init' event, lib/postgresMgr.js:401-421)."""
        self._pg_ready = True
        self.kick()

    # ---- lifecycle ----

    def start(self) -> None:
        if self._worker_task is None:
            self._worker_task = asyncio.create_task(self._worker())

    async def close(self) -> None:
        self._closed = True
        self._abort_failover_span("shutdown")
        self._kick.set()
        for t in (self._worker_task, self._pg_task):
            if t:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass       # the cancel we just requested
                except Exception:
                    pass       # a dying worker's last error is moot

    def kick(self) -> None:
        self._kick.set()

    def debug_state(self) -> dict:
        """Introspection for the status server (lib/shard.js:74-76)."""
        return {
            "id": self.self_id,
            "singleton": self.singleton,
            "role": role_of(self._state, self.self_id),
            "zkReady": self._zk_ready,
            "pgReady": self._pg_ready,
            "active": self._actives,
            "clusterState": self._state,
            "pgTarget": self._strip_cfg(self._pg_target),
            "pgApplied": self._strip_cfg(self._pg_applied),
        }

    async def _worker(self) -> None:
        while not self._closed:
            await self._kick.wait()
            self._kick.clear()
            try:
                await self._evaluate()
                self._eval_retry.reset()
            except asyncio.CancelledError:
                return
            except BadVersionError:
                # lost a CAS race; the watch will deliver the winning
                # state and re-kick us
                log.info("cluster-state CAS conflict; deferring")
            except Exception:
                log.exception("state machine evaluation failed")
                await self._eval_retry.sleep()
                self._kick.set()

    # ---- the decision procedure ----

    async def _evaluate(self) -> None:
        if not (self._zk_ready and self._pg_ready):
            return
        # consistent snapshot: state, its CAS version, and membership read
        # in the same event-loop step
        st = self.zk.cluster_state
        ver = self.zk.cluster_state_version
        actives = self.zk.active

        if st is None:
            await self._bootstrap(actives)
            return

        my_role = role_of(st, self.self_id)
        # react under the trace AND parent span of the transition that
        # produced this state: the pg reconfigure (and its logs/journal
        # events/spans) on EVERY peer then correlates with — and nests
        # under — the initiating write.  New transitions we decide
        # below mint their own fresh ids in _write_state.
        # fold the writer's HLC stamp before reacting: every record the
        # reaction produces then causally follows the state write, even
        # when our wall clock lags the writer's (degrades to wall-clock
        # ordering on merge failure, never blocks the evaluation)
        await merge_remote(st.get("hlc"))
        with bind_trace(st.get("trace")), bind_parent(st.get("span")):
            fresh = (st.get("span") is not None
                     and st.get("span") != self._reacted_span)
            if fresh:
                # exactly one evaluate span per observed transition per
                # peer (the worker re-kicks far more often than the
                # state changes); everything the reaction spawns —
                # the pg reconfigure task included — parents under it
                self._reacted_span = st.get("span")
                with span("state.evaluate", role=my_role or "none",
                          generation=st.get("generation")):
                    await self._react(st, ver, actives, my_role)
            else:
                await self._react(st, ver, actives, my_role)

    async def _react(self, st: ClusterState, ver: int | None,
                     actives: list[dict], my_role: str | None) -> None:
        self._notify_role(my_role, st)

        if st.get("oneNodeWriteMode") and my_role != "primary":
            # ONWM: foreign peers shut down
            # (docs/user-guide.md:369-372)
            log.warning("cluster is in one-node-write mode and we "
                        "are not the primary; shutting down")
            await self._apply_pg({"role": "none"})
            return

        if my_role == "primary":
            await self._apply_pg(self._pg_config_for(st, "primary"))
            await self._primary_duties(st, ver, actives)
        elif my_role == "sync":
            acted = await self._sync_duties(st, ver, actives)
            if not acted:
                await self._apply_pg(self._pg_config_for(st, "sync"))
        elif my_role == "async":
            await self._apply_pg(self._pg_config_for(st, "async"))
        elif my_role == "deposed":
            await self._apply_pg({"role": "none", "deposed": True})
        else:
            # unassigned: wait for the primary to adopt us
            await self._apply_pg({"role": "none"})

    def _notify_role(self, my_role: str | None, st: ClusterState) -> None:
        """Emit role-transition events ONCE per transition."""
        key = my_role
        if st.get("oneNodeWriteMode") and my_role != "primary":
            key = "onwm-foreign"
        if key == self._notified_role:
            return
        self._notified_role = key
        if key not in ("sync", "primary") and \
                self._failover_t0 is not None:
            # demoted (async/deposed/none) while a failover clock was
            # running: this peer can no longer complete the takeover it
            # detected, and a 'writable' event in some far-future
            # primary life must not observe a bogus duration
            get_journal().record("failover.aborted",
                                 trace_id=self._failover_trace,
                                 why="role became %s" % (key or "none"))
            self._abort_failover_span("role became %s" % (key or "none"))
            self._failover_t0 = None
            self._failover_trace = None
        get_journal().record("role.change", role=key or "none",
                             generation=st.get("generation"))
        if key == "deposed":
            log.warning("we are deposed; stopping postgres and waiting "
                        "for operator rebuild")
            self._emit("deposed", None)
        elif key == "onwm-foreign":
            self._emit("shutdown", "onwm-foreign-peer")
        self._emit("roleChange", key)

    # -- bootstrap --

    async def _bootstrap(self, actives: list[dict]) -> None:
        ids = [a["id"] for a in actives]
        if self.self_id not in ids:
            return
        if self.singleton:
            state = {
                "generation": 0,
                "initWal": INITIAL_WAL,
                "primary": self.self_info,
                "sync": None,
                "async": [],
                "deposed": [],
                "oneNodeWriteMode": True,
                "freeze": {"date": _now_iso(),
                           "reason": "one-node-write mode setup"},
            }
            await self._write_state(state, "singleton setup", None)
            return
        # normal mode: lowest election sequence declares, needs a sync
        by_seq = sorted(actives, key=lambda a: a.get("seq", 1 << 30))
        if len(by_seq) < 2 or by_seq[0]["id"] != self.self_id:
            return
        state = {
            "generation": 0,
            "initWal": INITIAL_WAL,
            "primary": peer_info_from_active(by_seq[0]),
            "sync": peer_info_from_active(by_seq[1]),
            "async": [peer_info_from_active(a) for a in by_seq[2:]],
            "deposed": [],
        }
        await self._write_state(state, "cluster setup", None)

    # -- primary --

    async def _primary_duties(self, st: ClusterState, ver: int | None,
                              actives: list[dict]) -> None:
        if frozen(st):
            return
        alive = {a["id"] for a in actives}

        if await self._handle_promote_as_primary(st, ver, alive):
            return

        if st.get("oneNodeWriteMode"):
            return

        asyncs = list(st.get("async") or [])
        alive_asyncs = [a for a in asyncs if a["id"] in alive]
        unassigned = [a for a in actives
                      if role_of(st, a["id"]) is None]

        sync = st.get("sync")
        if sync is None or sync["id"] not in alive:
            # need a replacement sync: prefer an alive async, else an
            # unassigned joiner ("sync added", lib/adm.js:2349-2358)
            if alive_asyncs:
                cand = alive_asyncs[0]
                rest = [a for a in asyncs if a["id"] != cand["id"]]
            elif unassigned:
                cand = peer_info_from_active(unassigned[0])
                rest = asyncs
            else:
                return  # nothing to appoint; wait for a joiner
            new = dict(st)
            new["generation"] = st["generation"] + 1
            new["initWal"] = await self.pg.get_xlog_location()
            new["sync"] = cand
            new["async"] = [a for a in rest if a["id"] in alive]
            await self._write_state(
                new, "appointed new sync %s" % cand["id"], ver)
            return

        # prune dead asyncs (no generation bump)
        if len(alive_asyncs) != len(asyncs):
            new = dict(st)
            new["async"] = alive_asyncs
            await self._write_state(new, "removed dead asyncs", ver)
            return

        # adopt unassigned joiners as asyncs (no generation bump)
        if unassigned:
            new = dict(st)
            new["async"] = asyncs + [peer_info_from_active(a)
                                     for a in unassigned]
            await self._write_state(
                new, "adopted asyncs %s"
                % [a["id"] for a in unassigned], ver)
            return

    async def _handle_promote_as_primary(self, st: ClusterState,
                                         ver: int | None,
                                         alive: set) -> bool:
        pr = st.get("promote")
        if not pr or pr.get("role") != "async":
            return False
        if pr.get("generation") != st.get("generation"):
            return False
        if _iso_to_ts(pr.get("expireTime", "")) < \
                datetime.datetime.now(datetime.timezone.utc).timestamp():
            return False
        asyncs = list(st.get("async") or [])
        idx = pr.get("asyncIndex", 0)
        if idx >= len(asyncs) or asyncs[idx]["id"] != pr.get("id"):
            return False  # topology moved; ignore the request
        if asyncs[idx]["id"] not in alive:
            return False
        new = dict(st)
        new.pop("promote", None)
        if idx == 0:
            # first async -> sync; old sync -> first async (gen bump:
            # sync changed, docs/man/manatee-adm.md:363-365)
            old_sync = st.get("sync")
            if old_sync is None:
                return False
            new["generation"] = st["generation"] + 1
            new["initWal"] = await self.pg.get_xlog_location()
            new["sync"] = asyncs[0]
            new["async"] = [old_sync] + asyncs[1:]
        else:
            # move up one position in the async chain (no data-path
            # impact, docs/man/manatee-adm.md:366)
            asyncs[idx - 1], asyncs[idx] = asyncs[idx], asyncs[idx - 1]
            new["async"] = asyncs
        await self._write_state(new, "acted on promote request", ver)
        return True

    # -- sync --

    async def _sync_duties(self, st: ClusterState, ver: int | None,
                           actives: list[dict]) -> bool:
        """Returns True if a takeover happened (state write succeeded)."""
        if frozen(st):
            return False
        alive = {a["id"] for a in actives}
        primary_alive = st["primary"]["id"] in alive

        pr = st.get("promote")
        promote_me = (
            pr is not None
            and pr.get("role") == "sync"
            and pr.get("id") == self.self_id
            and pr.get("generation") == st.get("generation")
            and _iso_to_ts(pr.get("expireTime", "")) >
            datetime.datetime.now(datetime.timezone.utc).timestamp())

        if primary_alive and not promote_me:
            if self._failover_t0 is not None:
                # the primary flapped back before we took over: the
                # detection was not a failover after all
                get_journal().record("failover.aborted",
                                     trace_id=self._failover_trace,
                                     primary=st["primary"]["id"])
                self._abort_failover_span("primary flapped back")
                self._failover_t0 = None
                self._failover_trace = None
            return False

        if not primary_alive and self._failover_t0 is None \
                and st["primary"]["id"] in self._witnessed:
            # SLI clock starts: we watched this primary die (witnessed
            # membership expiry), and it stops when the new primary
            # re-enables writes (_on_pg_writable)
            self._failover_t0 = time.monotonic()
            self._failover_trace = new_trace_id()
            # the ROOT of the cross-peer failover tree: everything the
            # takeover causes — the durable write, every peer's
            # reconfigure, the catchup wait — nests under this span,
            # and its duration IS the SLI window
            self._failover_span = get_span_store().start(
                "failover", trace_id=self._failover_trace, root=True,
                old_primary=st["primary"]["id"],
                generation=st.get("generation"))
            get_journal().record("failover.detected",
                                 trace_id=self._failover_trace,
                                 primary=st["primary"]["id"],
                                 generation=st.get("generation"))

        if not primary_alive and not promote_me and self._boot_time \
                and st["primary"]["id"] not in self._witnessed:
            # cold-start grace: shortly after boot, the primary's absence
            # may mean it has not re-joined yet, not that it died.  Only
            # for primaries we never saw alive — a disappearance we
            # witnessed (present in membership, then expired) is death.
            elapsed = asyncio.get_event_loop().time() - self._boot_time
            if elapsed < self.takeover_grace:
                delay = self.takeover_grace - elapsed + 0.05
                log.info("primary absent %0.1fs after boot; deferring "
                         "takeover %0.1fs (cold-start grace)",
                         elapsed, delay)
                loop = asyncio.get_event_loop()
                loop.call_later(delay, self.kick)
                return False

        # safety: never take over unless our xlog reached this
        # generation's initWal — otherwise we never replicated from this
        # primary and our database may predate it (docs/xlog-diverge.md)
        my_xlog = await self.pg.get_xlog_location()
        try:
            if compare_lsn(my_xlog, st.get("initWal", INITIAL_WAL)) < 0:
                log.warning(
                    "declining takeover: xlog %s behind initWal %s",
                    my_xlog, st.get("initWal"))
                return False
        except ValueError:
            log.warning("declining takeover: bad xlog %r", my_xlog)
            return False

        asyncs = list(st.get("async") or [])
        alive_asyncs = [a for a in asyncs if a["id"] in alive]
        new_sync = alive_asyncs[0] if alive_asyncs else None
        new = {
            "generation": st["generation"] + 1,
            "initWal": my_xlog,
            "primary": st["sync"],
            "sync": new_sync,
            "async": [a for a in asyncs
                      if new_sync is None or a["id"] != new_sync["id"]],
            "deposed": (st.get("deposed") or []) + [st["primary"]],
        }
        why = ("promote request" if promote_me else "primary death")
        # the takeover rides the trace minted at loss detection, so the
        # detection, the durable write, and the pg promotion all carry
        # one id across the journal and the logs — and parent under the
        # failover root span, so `manatee-adm trace` shows one tree.
        # No failover root (promote request; unwitnessed death): the
        # transition must root its own trace, or the ambient evaluate
        # span — which belongs to the PREVIOUS transition's trace —
        # leaks in as a cross-trace parent and the tree looks orphaned.
        tid = self._failover_trace or new_trace_id()
        parent = (self._failover_span.span_id
                  if self._failover_span is not None else None)
        with bind_trace(tid), bind_parent(parent):
            get_journal().record("takeover.begin", why=why,
                                 old_primary=st["primary"]["id"],
                                 new_generation=new["generation"])
            # OVERLAPPED TAKEOVER: the pg promotion starts while the
            # durable CAS write is still in flight — the two stages
            # are independent until write-enable.  Write authority is
            # NOT weakened: the promoted database stays read-only
            # until the commit gate opens, and the gate opens only
            # after the CAS write lands (the catchup watcher awaits it
            # even when the downstream is already caught up).  A
            # retried takeover (CAS fault, conflict re-drive) reuses
            # the SAME gate object so the in-flight reconfigure is
            # neither restarted nor orphaned.
            gate = self._takeover_gate
            if gate is None or gate.is_set():
                gate = self._takeover_gate = asyncio.Event()
            cfg = self._pg_config_for(new, "primary")
            cfg["commitGate"] = gate
            await self._apply_pg(cfg)
            if not await self._write_state(new, "takeover (%s)" % why,
                                           ver, trace_id=tid,
                                           root=parent is None):
                # lost the race (e.g. an operator freeze landed first):
                # withdraw the optimistic reconfigure — the gate never
                # opens, so no write was ever enabled.  The retract
                # cannot UNDO a pg_promote that already executed: if
                # the winner's state still names us sync, the promoted
                # (non-recovery, still read-only) database cannot
                # re-enter recovery and ends up on the restore path —
                # the deliberate cost of overlapping promote with the
                # CAS write, paid only in the rare lost-race window
                # and never as a write-authority violation.
                self._retract_pg(cfg)
                self._takeover_gate = None
                return False
            # the takeover is durable; we are the primary now — open
            # the write-enable gate
            gate.set()
            self._takeover_gate = None
        return True

    # -- shared helpers --

    async def _write_state(self, state: ClusterState, why: str,
                           expected_version: int | None, *,
                           trace_id: str | None = None,
                           root: bool | None = None) -> bool:
        """CAS-write; returns False when the write lost a race.

        Every durable transition mints a trace id (or rides the one the
        caller minted, e.g. at failover detection) and embeds it in the
        state object — along with the transition SPAN's id — so peers
        reacting to the watch (and the coordd that stored it) log,
        journal, and span under the same identity, parented to this
        write."""
        # the decided-transition seam: error/delay/stall here models a
        # peer that decides a topology change but cannot commit it (the
        # worker's jittered-backoff retry re-drives the evaluation)
        await fault_point("state.write")
        tid = trace_id or new_trace_id()
        state = dict(state)
        state["trace"] = tid
        journal = get_journal()
        with bind_trace(tid):
            log.info("writing cluster state gen=%s (%s)",
                     state.get("generation"), why)
            # root when WE minted the trace (callers with a same-trace
            # parent — the takeover under its failover root — pass
            # root=False explicitly): the ambient span here is the
            # evaluate span reacting to the PREVIOUS state, and a
            # cross-trace parent link would make this trace's own tree
            # look orphaned.
            with span("state.transition",
                      root=(trace_id is None if root is None
                            else root),
                      why=why,
                      generation=state.get("generation")) as tsp:
                # the embedded span id is what makes a transition's
                # effects on OTHER peers children of this write
                state["span"] = tsp.span_id
                # the written state object is an HLC piggyback
                # boundary: peers reacting to the watch merge this
                # stamp, so their reaction records sort after the
                # write at any wall-clock skew
                state["hlc"] = hlc_now()
                journal.record("transition.begin", why=why,
                               generation=state.get("generation"))
                try:
                    with span("state.cas_write"), \
                            _TRANSITION_DUR.time():
                        await self.zk.put_cluster_state(
                            state, expected_version=expected_version)
                except (BadVersionError, NodeExistsError):
                    log.info("state write lost a race (%s); deferring",
                             why)
                    journal.record("transition.conflict", why=why)
                    tsp.end(status="conflict")
                    # refresh the cached state explicitly: if our watch
                    # was lost, waiting for it would spin on the same
                    # stale snapshot
                    refresh = getattr(self.zk, "refresh_cluster_state",
                                      None)
                    if refresh is not None:
                        try:
                            await refresh()
                        except asyncio.CancelledError:
                            raise
                        except Exception:
                            pass
                    await _sleep(0.05)
                    self.kick()
                    return False
                _TRANSITIONS.inc()
                journal.record("transition.committed", why=why,
                               generation=state.get("generation"))
                self._emit("stateWritten", state)
        self.kick()
        return True

    def _on_pg_writable(self, _standby_id) -> None:
        """PG manager re-enabled writes.  If a failover clock is
        running, this peer just completed a takeover end-to-end: observe
        the headline SLI and close the root span — both cover the same
        detection→writable window, so `manatee-adm trace`'s critical
        path total and the histogram sample agree."""
        if self._failover_t0 is None:
            return
        dur = time.monotonic() - self._failover_t0
        _FAILOVER_DUR.observe(dur)
        get_journal().record("failover.complete",
                             trace_id=self._failover_trace,
                             duration_s=round(dur, 3))
        if self._failover_span is not None:
            self._failover_span.end(duration_s=round(dur, 3))
            self._failover_span = None
        self._failover_t0 = None
        self._failover_trace = None

    def _abort_failover_span(self, why: str) -> None:
        """A failover clock that will never complete must not leave its
        root span open (the leak the chaos suite asserts against)."""
        if self._failover_span is not None:
            self._failover_span.end(status="aborted", why=why)
            self._failover_span = None

    def _pg_config_for(self, st: ClusterState, role: str) -> dict:
        """The reconfigure contract {role, upstream, downstream}
        (lib/postgresMgr.js:758-816)."""
        asyncs = st.get("async") or []
        if role == "primary":
            return {"role": "primary", "upstream": None,
                    "downstream": st.get("sync")}
        if role == "sync":
            return {"role": "sync", "upstream": st.get("primary"),
                    "downstream": asyncs[0] if asyncs else None}
        idx = next(i for i, a in enumerate(asyncs)
                   if a["id"] == self.self_id)
        # the preceding peer in the daisy chain.  A takeover written
        # while every standby candidate was dead leaves sync=None with
        # asyncs listed (the crash sweep's state.write scenario hits
        # exactly this window); the chain then collapses to
        # primary <- async0, and an upstream of None here would boot
        # the async as a NON-recovery database that never streams —
        # a silent permanent wedge
        upstream = (st.get("sync") or st.get("primary")) if idx == 0 \
            else asyncs[idx - 1]
        downstream = asyncs[idx + 1] if idx + 1 < len(asyncs) else None
        return {"role": "async", "upstream": upstream,
                "downstream": downstream}

    @staticmethod
    def _strip_cfg(cfg: dict | None) -> dict | None:
        """The reconfigure contract minus the overlapped-takeover gate:
        equality checks (and debug output) must see the same target
        whether or not a commit gate rides along, or a committed
        takeover's follow-up evaluation would cancel its own in-flight
        promote just to restart it gateless."""
        if cfg is None or "commitGate" not in cfg:
            return cfg
        return {k: v for k, v in cfg.items() if k != "commitGate"}

    async def _apply_pg(self, cfg: dict) -> None:
        if self._strip_cfg(cfg) == self._strip_cfg(self._pg_target):
            if self._pg_target is not None \
                    and "commitGate" in self._pg_target \
                    and "commitGate" not in (cfg or {}):
                # an UNGATED request for the same config can only come
                # from reacting to the durable state itself — exactly
                # the authority the gate guards.  Open any still-closed
                # gate rather than leaving a gated catchup waiting on a
                # takeover that concluded through another write (e.g. a
                # lost CAS race whose winner still names us primary).
                self._pg_target["commitGate"].set()
            return
        self._pg_target = cfg
        if self._pg_task and not self._pg_task.done():
            # cancel the in-flight transition (a restore can take hours
            # and must not wedge the next topology change,
            # lib/postgresMgr.js:1263-1275)
            self._pg_task.cancel()
        self._pg_task = asyncio.create_task(self._run_pg(cfg))

    def _retract_pg(self, cfg: dict) -> None:
        """Withdraw an optimistic reconfigure whose durable write lost
        its race: cancel the in-flight task (if it is still ours) and
        clear the target so the winner's state re-drives pg.  Compared
        by CONTENT (gate stripped): a retried takeover's cfg is a
        fresh dict while the target still holds the first attempt's —
        identity would no-op exactly when the retract matters most."""
        if self._pg_target is None or \
                self._strip_cfg(self._pg_target) != self._strip_cfg(cfg):
            return               # something else took over the target
        self._pg_target = None
        if self._pg_task and not self._pg_task.done():
            self._pg_task.cancel()
        self.kick()

    async def _run_pg(self, cfg: dict) -> None:
        try:
            await self.pg.reconfigure(cfg)
            self._pg_applied = cfg
            self._pg_retry.reset()
            self._emit("pgApplied", cfg)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("pg reconfigure to %s failed; will retry",
                          cfg.get("role"))
            self._pg_target = None
            await self._pg_retry.sleep()
            self.kick()

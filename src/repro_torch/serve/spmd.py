"""The gateway's graph tenant over SPMD ranks: rank 0 leads, the others
follow.

The reference has no counterpart of this module: its `Gateway` is one
controller that owns the whole mesh and the RPC socket, and a sharded
count is one program over that mesh (`repro/serve/gateway.py`,
`repro/launch/gateway.py`).  The port runs one process per GPU, and a
sharded count (`ShardedMatcher`) is a collective of every rank, so
every rank must make the same `QueryEngine.run_pending` calls over the
same queue.

Rank 0 owns the Gateway's scheduler, the RPC server and the LM tenant.
Its engine is a `LeaderEngine`, which journals every change to its
queue as it happens: each admitted ticket with its id (admission,
`tenant_depth`, is decided on rank 0 alone), each cancel that took,
each mutation batch.  Before each round it broadcasts the journal with
the round's limit (one `Round`).  The other ranks run a `Follower`
over a plain `QueryEngine(group=)` built without a depth bound: it
replays each record in order, so ticket ids and queues equal rank 0's,
then runs the same round, so every rank makes the same collectives
(the matcher's SUM/MAX per pass).  Queued mutations apply at the start
of a round, so an epoch swap (`Matcher.rebind`) happens at the same
round boundary on every rank.  A stop record ends the followers when
rank 0 drains or shuts down; while rank 0 waits for clients it sends
heartbeats, rounds that run nothing, so no follower's broadcast
outlasts the group's timeout.

A sharded count ignores the engine's preemption budget: it runs whole,
as one dispatch unit of its round, on every rank alike.  Only
`run_pending` is mirrored: rank 0 calls `plan()` (a collective on a
miss) only inside rounds, and every rank calls `warm_from_disk()`
itself before serving.

The LM tenant spans the ranks too (tensor parallelism: every rank
holds its shard of one `LMSession` and the steps are collectives).
Rank 0's session is wrapped in a `LeaderSession`, which broadcasts
each call that moves the session (start, decode steps, admit, evict)
as a `Round` that runs no graph round, before making it; a follower
makes the same call on its own shard, so the collectives pair up.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..launch.mesh import broadcast
from ..obs import get_tracer, timer
from ..query import QueryEngine, Ticket
from .rpc import KEEPALIVE_S

__all__ = ["Follower", "LeaderEngine", "LeaderSession", "Round"]

LEADER = 0                        # the rank that owns the queue


@dataclass
class Round:
    """What rank 0 broadcasts before a round: the journal since the
    last one — ``("admit", seq, request)``, ``("cancel", seq)``,
    ``("mutate", verb, edges)`` — and the round's arguments.  ``run``
    False is a heartbeat (the journal applies, no round runs); ``stop``
    ends the followers.  ``lm`` = (method, args, kwargs) is a call each
    follower makes on its LM session (with ``run`` False)."""

    journal: list = field(default_factory=list)
    limit: int | None = None
    max_dispatches: int | None = None
    run: bool = True
    stop: bool = False
    lm: tuple | None = None


class LeaderEngine(QueryEngine):
    """Rank 0's engine: a `QueryEngine(group=)` that journals its queue
    and broadcasts each round to the followers before running it.
    `stop_when_drained` (a fixed workload: nothing is admitted once
    serving starts) stops the followers after the round that empties
    the queue, so rank 0's other tenants may run on for longer than
    the group's timeout."""

    def __init__(self, graph, *, group, stop_when_drained: bool = False,
                 **kw):
        self._journal: list = []
        self.stop_when_drained = stop_when_drained
        self.broadcasts = 0
        self.stopped = False
        self._since_sent = timer().__enter__()
        super().__init__(graph, group=group, **kw)

    def try_enqueue(self, request):
        out = super().try_enqueue(request)
        if isinstance(out, Ticket):
            self._journal.append(("admit", out.seq, out.request))
        return out

    def cancel(self, ticket) -> bool:
        ok = super().cancel(ticket)
        if ok:
            self._journal.append(("cancel", ticket.seq))
        return ok

    def request_mutation(self, verb: str, edges=None) -> dict:
        ack = super().request_mutation(verb, edges)
        self._journal.append(("mutate", *self._mutations[-1]))
        return ack

    def run_pending(self, limit: int | None = None, *,
                    max_dispatches: int | None = None):
        self._send(Round(limit=limit, max_dispatches=max_dispatches))
        out = super().run_pending(limit, max_dispatches=max_dispatches)
        if self.stop_when_drained and not (
                self.pending() or self.inflight()
                or self.mutations_pending()):
            self.stop()
        return out

    def keepalive(self) -> None:
        """Send the journal without a round when nothing was sent for
        `KEEPALIVE_S` seconds (while rank 0 idles or serves the LM
        alone), so no follower's broadcast outlasts the group's
        timeout."""
        self._since_sent.__exit__(None, None, None)  # reads, keeps running
        if not self.stopped and self._since_sent.seconds >= KEEPALIVE_S:
            self._send(Round(run=False))

    def lm_call(self, method: str, *args, **kw) -> None:
        """Have the followers call `method` on their LM session."""
        self._send(Round(run=False, lm=(method, args, kw)))

    def stop(self) -> None:
        """End the followers' loops (once)."""
        if not self.stopped:
            self._send(Round(run=False, stop=True))
            self.stopped = True

    def _send(self, rnd: Round) -> None:
        if self.stopped:
            raise RuntimeError("the followers were stopped")
        rnd.journal, self._journal = self._journal, []
        with get_tracer().span("spmd.broadcast", records=len(rnd.journal),
                               run=rnd.run, stop=rnd.stop):
            broadcast(self.group, rnd, src=LEADER)
        self.broadcasts += 1
        self._since_sent = timer().__enter__()


class LeaderSession:
    """Rank 0's LM session: each call that moves it is broadcast to the
    followers first (`LeaderEngine.lm_call`); everything else reads the
    session itself."""

    MIRRORED = ("start", "decode_steps", "admit", "evict")

    def __init__(self, session, engine: LeaderEngine):
        self.session = session
        self.engine = engine

    def __getattr__(self, name):
        attr = getattr(self.session, name)
        if name not in self.MIRRORED:
            return attr

        def mirrored(*args, **kw):
            self.engine.lm_call(name, *args, **kw)
            return attr(*args, **kw)

        return mirrored


class Follower:
    """A non-zero rank's loop over its own `QueryEngine(group=)`: replay
    rank 0's journal, run the same rounds, make the same LM session
    calls (`session`, its shard of rank 0's), stop when told.
    `tickets` holds the replayed tickets in admission order; `rounds`
    counts the rounds run, `lm_calls` the session calls."""

    def __init__(self, engine: QueryEngine, session=None):
        if engine.tenant_depth is not None:
            raise ValueError("a follower's engine replays rank 0's "
                             "admissions; build it without tenant_depth")
        self.engine = engine
        self.session = session
        self.tickets: list = []
        self._queued: dict[int, Ticket] = {}
        self.rounds = 0
        self.heartbeats = 0
        self.lm_calls = 0

    def apply(self, journal) -> None:
        eng = self.engine
        for rec in journal:
            kind = rec[0]
            if kind == "admit":
                _, seq, request = rec
                ticket = eng.enqueue(request)
                if ticket.seq != seq:
                    raise RuntimeError(f"replayed ticket #{ticket.seq} != "
                                       f"rank 0's #{seq}")
                self.tickets.append(ticket)
                self._queued[seq] = ticket
            elif kind == "cancel":
                ticket = self._queued.pop(rec[1], None)
                if ticket is None or not eng.cancel(ticket):
                    raise RuntimeError(f"cannot replay the cancel of "
                                       f"ticket #{rec[1]}")
            elif kind == "mutate":
                eng.request_mutation(rec[1], rec[2])
            else:
                raise ValueError(f"unknown journal record {kind!r}")

    def run(self) -> "Follower":
        """Follow until the stop record; returns self."""
        while True:
            rnd = broadcast(self.engine.group, None, src=LEADER)
            self.apply(rnd.journal)
            if rnd.stop:
                return self
            if rnd.lm is not None:
                method, args, kw = rnd.lm
                getattr(self.session, method)(*args, **kw)
                self.lm_calls += 1
                continue
            if not rnd.run:
                self.heartbeats += 1
                continue
            self.engine.run_pending(rnd.limit,
                                    max_dispatches=rnd.max_dispatches)
            self.rounds += 1
            self._queued = {s: t for s, t in self._queued.items()
                            if not t.done}

    def results(self) -> list:
        """Resolved results in admission order (cancelled tickets are
        skipped), as rank 0's `GraphQueryWorkload.results`."""
        return [t.result for t in self.tickets if t.done]

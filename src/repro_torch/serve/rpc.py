"""Ticket RPC front door — N client processes, ONE resident graph.

Port of `repro/serve/rpc.py`; the frames and operations are the
reference's byte for byte, so a client of either package talks to a
server of either package.  The Gateway is in-process: callers must own
the Python object to submit tickets.  This module puts a thin asyncio socket server in front of it
(`launch/gateway.py --listen PORT`) so independent client processes
drive one warmed engine — plan cache, resident CSR, LM batch and all —
without each paying the model/graph cold start.

Wire format (the reference's DESIGN.md §5): every message, both directions, is a FRAME
— a 4-byte big-endian unsigned length prefix followed by that many
bytes of UTF-8 JSON.  One request frame yields exactly one response
frame on the same connection (pipelining is sequential per connection;
run several connections for concurrency).  Operations:

    {"op": "submit", "pattern": "P1" | {"n":3, "edges":[[0,1],...]},
     "use_iep": false, "verify": false, "mode": "graphpi",
     "tenant": "default"}
        -> {"ok": true, "ticket": 7}
        -> {"ok": false, "error": "rejected", "rejection": {...}}
           (admission control: the tenant's queue is at its depth bound)
    {"op": "poll",   "ticket": 7} -> {"ok": true, "done": false,
                                      "cancelled": false}
    {"op": "result", "ticket": 7} -> blocks until resolved;
        -> {"ok": true, "result": {..., "count": N, "line": "..."}}
    {"op": "cancel", "ticket": 7} -> {"ok": true|false}
    {"op": "stats"}               -> {"ok": true, "stats": engine summary}
    {"op": "mutate", "verb": "insert_edges" | "delete_edges" | "compact",
     "edges": [[u, v], ...]}      -> {"ok": true, "verb": ...,
                                      "queued_edges": N,
                                      "pending_batches": B,
                                      "edge_epoch": E}
        Live engines only (`launch/gateway.py --live`).  The batch is
        QUEUED and applies atomically at the next round boundary
        (src/repro_torch/live/), so the ordering is deterministic: any submit
        acked after this mutate ack is answered on the post-mutation
        epoch, and no in-flight count ever straddles epochs.
    {"op": "shutdown"}            -> {"ok": true}  (server exits after)

CONCURRENCY MODEL.  One process drives one device stream, so the
server stays single-threaded: the asyncio event loop interleaves socket frames
with `Gateway.run_round()` calls — each round is bounded by the
workloads' quanta (and the engine's preemption budget), so the loop
returns to the sockets promptly even mid-huge-query.  Result waiters
park on an event that pulses once per round.

The counts are BIT-IDENTICAL to the in-process path: the server calls
the same `QueryEngine.run_pending` rounds a local Gateway would
(tests/test_torch_rpc.py asserts it, against both packages' servers
and clients).

`python -m repro_torch.serve.rpc --connect HOST:PORT --requests
trace.jsonl` is the command-line client: submits every request in the trace, then
prints each result line (in submission order) like the launcher does.
A trace line `{"mutate": "insert_edges", "edges": [[u,v],...]}` drains
outstanding results first (pre-mutation counts print on their admission
epoch), then sends the mutate frame — so a trace interleaving queries
and mutations replays as a deterministic epoch history.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import socket
import struct
import sys
from dataclasses import asdict

from ..query.engine import Rejection

__all__ = [
    "GatewayRPCServer",
    "RPCClient",
    "RPCError",
    "request_from_spec",
    "result_to_wire",
]

_HDR = struct.Struct(">I")
MAX_FRAME = 16 << 20             # 16 MiB: a frame larger than this is a bug
# seconds between a parked drive loop's keepalive calls, and the longest
# a sharded gateway's rank 0 stays silent: well inside the group's
# timeout (`launch.mesh.GROUP_TIMEOUT_S`), which bounds each follower's
# wait for the next broadcast
KEEPALIVE_S = 30.0


def encode_frame(obj) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(body)} bytes")
    return _HDR.pack(len(body)) + body


async def read_frame(reader) -> dict | None:
    """One length-prefixed JSON frame; None on clean EOF."""
    try:
        hdr = await reader.readexactly(_HDR.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = _HDR.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n} bytes")
    body = await reader.readexactly(n)
    return json.loads(body.decode("utf-8"))


def request_from_spec(spec: dict, get_pattern=None):
    """One trace-file/wire request spec -> QueryRequest (the same format
    `launch/query_serve.py --requests` reads, plus a `tenant` field)."""
    from ..core.pattern import Pattern
    from ..query import QueryRequest

    pat = spec["pattern"]
    if isinstance(pat, str):
        if get_pattern is None:
            from ..configs.graphpi import get_pattern
        pattern = get_pattern(pat)
    else:
        pattern = Pattern(
            int(pat["n"]),
            tuple((int(u), int(v)) for u, v in pat["edges"]),
            name=pat.get("name", "inline"),
        )
    return QueryRequest(
        pattern,
        use_iep=bool(spec.get("use_iep", False)),
        verify=bool(spec.get("verify", False)),
        mode=spec.get("mode", "graphpi"),
        tenant=str(spec.get("tenant", "default")),
    )


def result_to_wire(result) -> dict:
    """QueryResult -> JSON-safe dict (tuples become lists; the rendered
    serving-log `line` rides along so clients print what the launcher
    prints — `count=N` included, which the smoke diff greps)."""
    out = asdict(result)
    out["order"] = list(out["order"])
    out["res_set"] = [list(r) for r in out["res_set"]]
    out["line"] = result.line()
    return out


class GatewayRPCServer:
    """Asyncio front door over one Gateway + GraphQueryWorkload.

    The server owns the drive loop: whenever any workload is ready it
    calls `gateway.run_round()` (one bounded scheduler round), then
    yields to the sockets; when everything is drained it sleeps on a
    work event that `submit` sets.  `serve_forever()` returns after a
    `shutdown` frame (or `stop()`)."""

    def __init__(self, gateway, workload, *, host: str = "127.0.0.1",
                 port: int = 0, get_pattern=None, keepalive=None):
        self.gateway = gateway
        self.workload = workload
        self.engine = workload.engine
        self.host = host
        self.port = port             # 0 = ephemeral; real port set on serve
        self._get_pattern = get_pattern
        self._tickets: dict[int, object] = {}
        self._work: asyncio.Event | None = None
        self._round_ev: asyncio.Event | None = None
        self._stop_ev: asyncio.Event | None = None
        self.rounds = 0
        self.connections = 0
        # called after every turn of the drive loop, and at least every
        # KEEPALIVE_S seconds while it is parked (the sharded gateway's
        # rank 0 keeps its followers' broadcast inside the group timeout)
        self._keepalive = keepalive

    # ------------------------------------------------------------ lifecycle
    def stop(self) -> None:
        if self._stop_ev is not None:
            self._stop_ev.set()

    def serve_forever(self, *, on_ready=None) -> None:
        """Blocking entry point (runs its own event loop)."""
        asyncio.run(self.serve(on_ready=on_ready))

    async def serve(self, *, on_ready=None) -> None:
        self._work = asyncio.Event()
        self._round_ev = asyncio.Event()
        self._stop_ev = asyncio.Event()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        if on_ready is not None:
            on_ready(self.host, self.port)
        drive = asyncio.get_event_loop().create_task(self._drive())
        try:
            await self._stop_ev.wait()
        finally:
            drive.cancel()
            self._pulse()            # release any parked result waiters
            server.close()
            await server.wait_closed()

    async def _drive(self) -> None:
        while not self._stop_ev.is_set():
            out = self.gateway.run_round()
            if self._keepalive is not None:
                self._keepalive()
            if out is not None:
                self.rounds += 1
                self._pulse()
                await asyncio.sleep(0)   # let socket frames interleave
                continue
            # drained: park until new work (or shutdown) arrives
            self._pulse()
            self._work.clear()
            work = asyncio.ensure_future(self._work.wait())
            stop = asyncio.ensure_future(self._stop_ev.wait())
            try:
                await asyncio.wait(
                    {work, stop}, return_when=asyncio.FIRST_COMPLETED,
                    timeout=None if self._keepalive is None
                    else KEEPALIVE_S)
            finally:
                work.cancel()
                stop.cancel()

    def _pulse(self) -> None:
        """Wake every coroutine waiting on 'a round happened'."""
        ev, self._round_ev = self._round_ev, asyncio.Event()
        ev.set()

    # ------------------------------------------------------------- handlers
    async def _handle(self, reader, writer) -> None:
        self.connections += 1
        try:
            while True:
                msg = await read_frame(reader)
                if msg is None:
                    break
                try:
                    resp = await self._dispatch(msg)
                except Exception as e:   # a bad frame must not kill the loop
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                writer.write(encode_frame(resp))
                await writer.drain()
        finally:
            writer.close()

    async def _dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "submit":
            return self._submit(msg)
        if op == "poll":
            t = self._tickets.get(msg.get("ticket"))
            if t is None:
                return {"ok": False, "error": "unknown ticket"}
            return {"ok": True, "done": t.done, "cancelled": t.cancelled}
        if op == "result":
            return await self._result(msg.get("ticket"))
        if op == "cancel":
            t = self._tickets.get(msg.get("ticket"))
            if t is None:
                return {"ok": False, "error": "unknown ticket"}
            return {"ok": self.engine.cancel(t)}
        if op == "stats":
            return {"ok": True, "stats": self.engine.summary(),
                    "rounds": self.rounds}
        if op == "mutate":
            ack = self.engine.request_mutation(msg.get("verb"),
                                               msg.get("edges"))
            # the queued batch applies at the next round boundary; wake
            # the drive loop so a drained server still processes it
            self._work.set()
            return {"ok": True, **ack}
        if op == "shutdown":
            self._stop_ev.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _submit(self, msg: dict) -> dict:
        req = request_from_spec(msg, self._get_pattern)
        out = self.engine.try_enqueue(req)
        if isinstance(out, Rejection):
            return {"ok": False, "error": "rejected",
                    "rejection": asdict(out)}
        self.workload.tickets.append(out)
        self._tickets[out.seq] = out
        self._work.set()
        return {"ok": True, "ticket": out.seq}

    async def _result(self, seq) -> dict:
        t = self._tickets.get(seq)
        if t is None:
            return {"ok": False, "error": "unknown ticket"}
        while not t.done:
            if t.cancelled:
                return {"ok": False, "error": "cancelled"}
            ev = self._round_ev
            self._work.set()
            await ev.wait()
        return {"ok": True, "result": result_to_wire(t.result)}


class RPCError(RuntimeError):
    """A server-side {"ok": false} response, surfaced client-side."""

    def __init__(self, resp: dict):
        super().__init__(resp.get("error", "rpc error"))
        self.resp = resp


class RPCClient:
    """Synchronous stdlib-socket client (one connection, sequential
    frames) — what the CLI below and the smoke/CI scripts use."""

    def __init__(self, host: str, port: int, *, tenant: str = "default",
                 timeout: float = 300.0):
        self.tenant = tenant
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def close(self) -> None:
        self.sock.close()

    def call(self, msg: dict) -> dict:
        self.sock.sendall(encode_frame(msg))
        hdr = self._recv(_HDR.size)
        (n,) = _HDR.unpack(hdr)
        return json.loads(self._recv(n).decode("utf-8"))

    def _recv(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed the connection")
            buf += chunk
        return buf

    # ------------------------------------------------------------- verbs
    def submit(self, spec: dict) -> int:
        msg = {"op": "submit", "tenant": self.tenant, **spec}
        resp = self.call(msg)
        if not resp.get("ok"):
            raise RPCError(resp)
        return resp["ticket"]

    def submit_many(self, specs) -> list[int]:
        """Submit every spec in ONE write (the frames pipelined on this
        connection), so the server admits them all before its next
        round and same-class tickets coalesce; returns the ticket ids,
        or raises the first rejection once every response is read."""
        specs = list(specs)
        self.sock.sendall(b"".join(
            encode_frame({"op": "submit", "tenant": self.tenant, **spec})
            for spec in specs))
        resps = []
        for _ in specs:
            (n,) = _HDR.unpack(self._recv(_HDR.size))
            resps.append(json.loads(self._recv(n).decode("utf-8")))
        for resp in resps:
            if not resp.get("ok"):
                raise RPCError(resp)
        return [resp["ticket"] for resp in resps]

    def poll(self, ticket: int) -> dict:
        return self.call({"op": "poll", "ticket": ticket})

    def result(self, ticket: int) -> dict:
        resp = self.call({"op": "result", "ticket": ticket})
        if not resp.get("ok"):
            raise RPCError(resp)
        return resp["result"]

    def cancel(self, ticket: int) -> bool:
        return bool(self.call({"op": "cancel", "ticket": ticket}).get("ok"))

    def stats(self) -> dict:
        resp = self.call({"op": "stats"})
        if not resp.get("ok"):
            raise RPCError(resp)
        return resp

    def mutate(self, verb: str, edges=None) -> dict:
        msg = {"op": "mutate", "verb": verb}
        if edges is not None:
            msg["edges"] = [[int(u), int(v)] for u, v in edges]
        resp = self.call(msg)
        if not resp.get("ok"):
            raise RPCError(resp)
        return resp

    def shutdown(self) -> None:
        self.call({"op": "shutdown"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="RPC client for a --listen'ing launch/gateway.py")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--requests", required=True,
                    help="JSON-lines request trace (query_serve format)")
    ap.add_argument("--tenant", default="default")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--shutdown", action="store_true",
                    help="ask the server to exit after the last result")
    args = ap.parse_args(argv)

    host, _, port = args.connect.rpartition(":")
    client = RPCClient(host or "127.0.0.1", int(port),
                       tenant=args.tenant, timeout=args.timeout)
    rc = 0
    tickets: list[int] = []

    def flush() -> None:
        """Print results for every outstanding ticket, in order."""
        nonlocal rc
        for tk in tickets:
            try:
                r = client.result(tk)
                print("[rpc]", r["line"])
                if r.get("verified") is False:
                    rc = 1
            except RPCError as e:
                print(f"[rpc] ticket {tk} FAILED: {e}")
                rc = 1
        tickets.clear()

    with open(args.requests) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            spec = json.loads(line)
            if "mutate" in spec:
                # drain first so earlier submits are answered (and
                # printed) on their admission epoch, then mutate — the
                # trace reads as a deterministic epoch history
                flush()
                try:
                    ack = client.mutate(spec["mutate"], spec.get("edges"))
                    print(f"[rpc] mutate {ack['verb']} "
                          f"queued_edges={ack['queued_edges']} "
                          f"edge_epoch={ack['edge_epoch']}")
                except RPCError as e:
                    print(f"[rpc] mutate FAILED: {e}")
                    rc = 1
                continue
            tickets.append(client.submit(spec))
    flush()
    if args.shutdown:
        client.shutdown()
    client.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())

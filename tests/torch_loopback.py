"""Loopback mirrors for the port's socket tests, and the check that a test
leaves nothing running.

``RangeServer.stop()`` halts the accept loop only: its handler threads
keep serving the sessions that are still open.  ``Loopback.halt`` severs
those sessions, stops the accept loop, and severs again whatever was
accepted in between, so every handler thread can end.

A test module that imports ``no_thread_left`` gets it as an autouse
fixture: after each test, the live threads must be the ones that were
alive before it, within ``JOIN_S`` seconds.  A thread, server or event
loop that outlives its test fails that test.

Every socket case is bounded: ``arun`` wraps a coroutine in
``asyncio.wait_for``, and ``Loopback.bounded`` runs a blocking call (one
that starts its own event loop) on a thread with a join timeout.  When it
gives up, it halts the test's servers first, so the thread can end.
"""

from __future__ import annotations

import asyncio
import threading
import time

import pytest

from repro_torch.transfer import PeerMirror, RangeServer, Throttle

#: seconds a test's leftover threads get to end before the test fails
JOIN_S = 3.0
#: seconds any one socket case may run before it fails
LIMIT = 15.0
#: seconds between the accept loop's checks for ``stop()``: the servers
#: of these tests poll at 20 ms instead of the default half second, so a
#: teardown does not wait half a second per server
POLL_S = 0.02


@pytest.fixture(autouse=True)
def no_thread_left():
    """Fail the test if it leaves a thread running."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + JOIN_S
    left = []
    for t in threading.enumerate():
        if t in before or t is threading.current_thread():
            continue
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            left.append(t.name)
    assert not left, f"threads still running after the test: {left}"


def arun(coro, timeout: float = LIMIT):
    """``asyncio.run`` with a time limit: a hang fails the test."""
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _polled(srv: RangeServer) -> RangeServer:
    """Run ``srv``'s accept loop at ``POLL_S`` (before it starts)."""
    srv._thread = threading.Thread(target=srv._srv.serve_forever,
                                   args=(POLL_S,), daemon=True)
    return srv


def throttle(rate: float, shared: bool = False) -> Throttle:
    """Deterministic pacing: a mirror's rate is an upper bound that host
    load cannot raise."""
    return Throttle(bytes_per_s=rate, deterministic=True, shared=shared)


class Loopback:
    """The servers and peer mirrors one test starts; ``halt`` stops them
    all (the ``loopback`` fixture calls it in its teardown)."""

    def __init__(self):
        self.items: list = []

    def server(self, blobs=None, files=None, rate: float = 0.0,
               shared: bool = False, faults=None) -> RangeServer:
        """A started ``RangeServer`` holding ``blobs`` (path -> bytes) and
        ``files`` (path -> file name)."""
        s = _polled(RangeServer(
            throttle=throttle(rate, shared) if rate else None, faults=faults))
        s.start()
        self.items.append(s)
        for path, data in (blobs or {}).items():
            s.add_blob(path, data)
        for path, name in (files or {}).items():
            s.add_file(path, name)
        return s

    def checkpoint(self, d: str, step: int, rate: float = 0.0,
                   faults=None) -> RangeServer:
        """A mirror of the checkpoint directory ``d`` under ``/ckpt``."""
        base = f"/ckpt/step_{step:010d}"
        return self.server(files={f"{base}/{n}": f"{d}/{n}"
                                  for n in ("manifest.json", "data.bin")},
                           rate=rate, faults=faults)

    def mirror(self, sink=None, rate: float = 0.0, **kw) -> PeerMirror:
        """A ``PeerMirror`` (bound to ``sink`` when one is given)."""
        m = PeerMirror(throttle=throttle(rate, shared=True) if rate else None,
                       **kw)
        _polled(m.server)
        self.items.append(m)
        if sink is not None:
            m.bind(sink)
        return m

    def halt(self) -> None:
        """Sever every session, stop every accept loop, then sever what
        was accepted in between."""
        for x in self.items:
            srv = x.server if isinstance(x, PeerMirror) else x
            srv.kill_connections()
            x.stop()
            srv.kill_connections()

    def bounded(self, fn, timeout: float = LIMIT):
        """``fn()`` on a thread, its result or its exception; after
        ``timeout`` seconds the servers are halted and the test fails."""
        out, err = [], []

        def run():
            try:
                out.append(fn())
            except BaseException as e:       # re-raised in the caller
                err.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            self.halt()
            t.join(JOIN_S)
            raise AssertionError(f"timed out after {timeout} s")
        if err:
            raise err[0]
        return out[0]


@pytest.fixture
def loopback():
    lb = Loopback()
    try:
        yield lb
    finally:
        lb.halt()

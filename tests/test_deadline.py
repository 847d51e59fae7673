"""tests/_deadline.py, the per-phase time limit that the root conftest.py
puts on every fast-gate test: it ends the socket hang it exists for, fires
again after an expiry that was swallowed, and puts the previous SIGALRM
handler and timer back whichever way it exits."""
import asyncio
import signal
import time

import pytest

from _deadline import REPEAT_S, limit


async def _hang():
    """A server whose handler never closes, a client connection left open,
    then close and wait: on Python 3.12 `wait_closed` waits for the open
    connection, so it never returns."""

    async def on_conn(reader, writer):
        await reader.read()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    _, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        server.close()
        await server.wait_closed()
    finally:
        writer.close()


def test_limit_ends_a_hung_wait_closed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="the hang ran past its 0.5 s limit"):
        with limit(0.5, "the hang"):
            asyncio.run(_hang())
    assert time.monotonic() - t0 < 2.0


def test_limit_fires_again_after_a_swallowed_expiry():
    """A task that catches Exception around its work, as a retry loop
    does, swallows the first expiry; the next one lands while the loop
    waits in select and ends the run."""
    swallowed = []

    async def retry_loop():
        while True:
            try:
                if not swallowed:
                    time.sleep(5)  # busy: the first expiry lands here
                await asyncio.sleep(0.05)
            except Exception as e:
                swallowed.append(e)

    async def main():
        task = asyncio.create_task(retry_loop())
        await asyncio.sleep(10)  # far past the limit and two repeats
        task.cancel()

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="the loop ran past its 0.5 s limit"):
        with limit(0.5, "the loop"):
            asyncio.run(main())
    assert swallowed and all(isinstance(e, TimeoutError) for e in swallowed)
    assert time.monotonic() - t0 < 0.5 + 3 * REPEAT_S


def test_limit_puts_the_handler_and_the_timer_back():
    def sentinel(signum, frame):
        raise AssertionError("the outer handler ran")

    handler = signal.signal(signal.SIGALRM, sentinel)
    # This test's own phase limit, lifted here and put back below.
    phase_timer = signal.setitimer(signal.ITIMER_REAL, 0)
    try:
        # No timer before: none after, whether the limit expired or not.
        with pytest.raises(TimeoutError, match="ran past its 0.5 s limit"):
            with limit(0.5, "the sleep"):
                time.sleep(5)
        assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
        assert signal.getsignal(signal.SIGALRM) is sentinel
        with limit(0.5, "the pass"):
            pass
        assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
        assert signal.getsignal(signal.SIGALRM) is sentinel

        # An outer timer comes back with what is left of it.
        signal.setitimer(signal.ITIMER_REAL, 60.0, 2.0)
        with limit(0.5, "the inner"):
            time.sleep(0.2)
        left, every = signal.getitimer(signal.ITIMER_REAL)
        signal.setitimer(signal.ITIMER_REAL, 0)
        assert 59.0 < left < 59.85 and every == 2.0
        assert signal.getsignal(signal.SIGALRM) is sentinel

        # An outer limit that ran out inside an inner one fires on exit.
        with pytest.raises(TimeoutError, match="the outer ran past its 0.2 s"):
            with limit(0.2, "the outer"):
                with limit(5.0, "the inner"):
                    time.sleep(0.4)
                time.sleep(5)
        assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
        assert signal.getsignal(signal.SIGALRM) is sentinel
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, handler)
        signal.setitimer(signal.ITIMER_REAL, *phase_timer)

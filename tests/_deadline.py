"""A time limit for one phase of a test.

The repo's root conftest.py runs the setup, the call and the teardown of
every test under tests/ that is not marked `slow` inside
`limit(PHASE_LIMIT_S, ...)`.  When the limit passes, SIGALRM raises
TimeoutError("<test id> <phase> ran past its 300 s limit") in the main
thread, so the hung test fails on its own and the worker goes on to the
next test.

The timer then fires again every REPEAT_S until the phase ends.  An expiry
can land inside code that swallows it: a coroutine step under an
`except Exception`, which asyncio's Task would also keep to itself.  The
next one most likely lands where the loop waits in select, or in the
test's own frame, and ends the phase there.

The limit catches waits and sleeps: a socket wait that never returns, an
Event nobody sets, a join, an `asyncio.run` whose loop idles in select.
Python runs the handler only when control comes back to the interpreter,
so a C call (an XLA compile, say) that runs past the limit fails its test
too, but only when it returns; one that never returns is left to the
suite's outer time limit.  The `slow` tier (JAX kernel compiles, some of
them about 5 min on the CPU) has no limit of its own.

On exit the previous handler is put back, and the previous timer with
what is left of it: a limit inside another one keeps the outer one, and
an outer limit that ran out inside the inner one fires as soon as the
inner one exits.
"""
import contextlib
import signal
import time

# The fast gate's slowest phase was 94 s on 8 cores with 6 workers
# (test_bls_jax.py::test_pallas_T_point_ops_bit_exact): about 3x that.
PHASE_LIMIT_S = 300.0
REPEAT_S = 1.0


@contextlib.contextmanager
def limit(seconds: float, what: str):
    """Raise TimeoutError in the main thread if the body runs past
    `seconds`, and again every REPEAT_S until it ends; on exit put the
    previous SIGALRM handler and timer back."""

    def expire(signum, frame):
        raise TimeoutError(f"{what} ran past its {seconds:g} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    outer_left, outer_every = signal.setitimer(
        signal.ITIMER_REAL, seconds, REPEAT_S
    )
    t0 = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if outer_left > 0:
            left = outer_left - (time.monotonic() - t0)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-6), outer_every)

"""One time limit on each phase of every test under tests/ that is not
marked `slow` (tests/_deadline.py): a hung wait fails its own test in
minutes instead of holding its worker, and the rest of its file still
runs.  Tests elsewhere (benchmark/tests) and the `slow` tier run as
before."""
import contextlib
import os
import sys

import pytest

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
sys.path.insert(0, _TESTS)

from _deadline import PHASE_LIMIT_S, limit  # noqa: E402


def _limited(item, phase):
    if item.get_closest_marker("slow") or not str(item.path).startswith(
        _TESTS + os.sep
    ):
        return contextlib.nullcontext()
    return limit(PHASE_LIMIT_S, f"{item.nodeid} {phase}")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _limited(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _limited(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _limited(item, "teardown"):
        return (yield)

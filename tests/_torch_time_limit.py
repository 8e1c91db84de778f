"""A time limit for a test module that starts a runtime, a cluster or
subprocesses. Not a test module.

    from _torch_time_limit import session_watchdog, time_limits
    _module_limit, _test_limit = time_limits(module_s=120, test_s=60)

All three fixtures are autouse. ``faulthandler.dump_traceback_later(limit,
exit=True)`` dumps every thread's stack and ends the process when a test
(``test_s``) or the module's set-up and tear-down (``module_s``: the
runtime's start before the first test and its shutdown after the last) runs
past its limit. Under xdist that costs one worker, which xdist replaces,
instead of blocking the run until its clock runs out.

``session_watchdog`` covers what comes after the last test: at the
session's tear-down it arms the same dump for ``WATCHDOG_S`` seconds, so a
worker that hangs in a later finalizer or in a runtime's ``atexit``
shutdown dumps its stacks and ends, instead of holding the run with no
test running until the run's own clock cuts it.
"""
import faulthandler
import os
import sys

import pytest

WATCHDOG_S = 120  # past the session's tear-down: finalizers and atexit shutdowns


def _stderr_fd(config) -> int:
    """The stderr pytest's faulthandler writes to: taken before output
    capture, so a dump reaches the terminal (or the xdist controller's)
    and not a capture file that dies with the process."""
    try:
        from _pytest.faulthandler import fault_handler_stderr_fd_key

        return config.stash[fault_handler_stderr_fd_key]
    except (ImportError, KeyError):
        return sys.__stderr__.fileno()


def time_limits(module_s: float, test_s: float):
    fd = []

    def arm(limit):
        faulthandler.dump_traceback_later(limit, exit=True, file=fd[0])

    @pytest.fixture(scope="module", autouse=True)
    def _module_limit(pytestconfig):
        fd[:] = [_stderr_fd(pytestconfig)]
        arm(module_s)  # set up first: covers the module's own fixtures
        yield
        faulthandler.cancel_dump_traceback_later()  # torn down last

    @pytest.fixture(autouse=True)
    def _test_limit(_module_limit):
        arm(test_s)
        yield
        arm(module_s)  # the next test's set-up, or the module's tear-down

    return _module_limit, _test_limit


@pytest.fixture(scope="session", autouse=True)
def session_watchdog(pytestconfig):
    # a fd of our own: pytest closes its copy of stderr at unconfigure,
    # before the atexit handlers this watchdog is for
    fd = os.dup(_stderr_fd(pytestconfig))
    yield
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True, file=fd)

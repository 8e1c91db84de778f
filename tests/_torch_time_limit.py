"""A time limit for a test module that starts a runtime, a cluster or
subprocesses. Not a test module.

    from _torch_time_limit import time_limits
    _module_limit, _test_limit = time_limits(module_s=120, test_s=60)

Both fixtures are autouse. ``faulthandler.dump_traceback_later(limit,
exit=True)`` dumps every thread's stack and ends the process when a test
(``test_s``) or the module's set-up and tear-down (``module_s``: the
runtime's start before the first test and its shutdown after the last) runs
past its limit. Under xdist that costs one worker, which xdist replaces,
instead of blocking the run until its clock runs out.
"""
import faulthandler
import sys

import pytest


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

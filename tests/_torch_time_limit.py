"""A time limit for a test module that starts a runtime, a cluster or
subprocesses. Not a test module.

    from _torch_time_limit import session_watchdog, time_limits
    _module_limit, _test_limit = time_limits(module_s=120, test_s=60)

All three fixtures are autouse. ``faulthandler.dump_traceback_later(limit,
exit=True)`` dumps every thread's stack and ends the process when a test
(``test_s``) or the module's set-up and tear-down (``module_s``: the
runtime's start before the first test and its shutdown after the last) runs
past its limit. Under xdist that costs one worker, which xdist replaces,
instead of blocking the run until its clock runs out. Every other test in a
pytest process that has imported this module (under xdist: every worker,
as each collects the port's modules), JAX's included, runs under the same
dump after ``DEFAULT_TEST_S``.

``session_watchdog`` covers what comes after the last test: the session's
tear-down (later session finalizers) and the process's exit (the runtimes'
``atexit`` shutdowns), each under the same dump for ``WATCHDOG_S`` seconds,
so a worker that hangs there dumps its stacks and ends instead of holding
the run with no test running until the run's own clock cuts it. Between the
two it is off: an xdist worker whose session has ended waits, idle, for the
controller to close it, and that wait is not a hang.

At import this module also makes SIGTERM dump every thread's stack before
the process dies. ``timeout`` without ``--foreground`` sends SIGTERM to its
whole process group, which holds the xdist workers, and every worker
imports this module while it collects the port's tests: a run cut by its
clock then shows what each busy worker was running, in a JAX test or in a
port test.
"""
import atexit
import faulthandler
import os
import select
import signal
import sys
import threading

import pytest

WATCHDOG_S = 120  # past the session's tear-down: finalizers and atexit shutdowns
# any test in a worker that has imported this module, JAX's included,
# until its module's own limits take over: the slowest test seen under
# -n 6 took ~104 s (a set-up), and a deadlocked one should cost one
# worker, not the rest of the run
DEFAULT_TEST_S = 360


def _stderr_fd(config) -> int:
    """The stderr pytest's faulthandler writes to: taken before output
    capture, so a dump reaches the terminal (or the xdist controller's)
    and not a capture file that dies with the process."""
    try:
        from _pytest.faulthandler import fault_handler_stderr_fd_key

        return config.stash[fault_handler_stderr_fd_key]
    except (AttributeError, ImportError, KeyError):
        return sys.__stderr__.fileno()


def _importing_config():
    """The Config of the pytest run that imports this module. A module's
    import runs no hook and gets no fixture, so the collector's frame is
    the one place it shows; None outside pytest."""
    frame = sys._getframe(1)
    while frame is not None:
        config = getattr(frame.f_locals.get("self"), "config", None)
        if isinstance(config, pytest.Config):
            return config
        frame = frame.f_back
    return None


def _worker_tag() -> bytes:
    return f"[{os.environ.get('PYTEST_XDIST_WORKER', 'main')} "\
           f"pid {os.getpid()}] ".encode()


def _forward_sigterm_dump(r: int, out: int) -> None:
    """Wait for a SIGTERM dump on pipe ``r``; write it to ``out`` a line
    at a time, each line tagged with this worker, then end the process as
    SIGTERM would have. The workers of one cut dump at once into one
    pipe: faulthandler writes a stack in many small pieces, which
    interleave into noise, while a tagged line of one write each stays
    whole."""
    data = os.read(r, 1 << 16)
    while select.select([r], [], [], 0.5)[0]:  # half a second of quiet
        data += os.read(r, 1 << 16)
    for line in data.splitlines(keepends=True):
        os.write(out, _worker_tag() + line)
    os._exit(128 + signal.SIGTERM)


def _dump_on_sigterm(out: int) -> None:
    r, w = os.pipe()
    faulthandler.register(signal.SIGTERM, file=w, all_threads=True,
                          chain=False)
    # a forked child keeps the handler but not the thread that ends
    # the process: it dies of SIGTERM as before
    os.register_at_fork(
        after_in_child=lambda: faulthandler.unregister(signal.SIGTERM))
    threading.Thread(target=_forward_sigterm_dump, args=(r, out),
                     name="sigterm-dump", daemon=True).start()


class _DefaultLimit:
    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_protocol(self):
        faulthandler.dump_traceback_later(DEFAULT_TEST_S, exit=True, file=_DUMP_FD)
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()


# a fd of our own: pytest closes its copy of stderr at unconfigure, before
# the atexit handlers the watchdog covers
_CONFIG = _importing_config()
_DUMP_FD = os.dup(_stderr_fd(_CONFIG))
_dump_on_sigterm(_DUMP_FD)
if _CONFIG is not None and not _CONFIG.pluginmanager.has_plugin("torch_default_limit"):
    _CONFIG.pluginmanager.register(_DefaultLimit(), "torch_default_limit")


def time_limits(module_s: float, test_s: float):
    def arm(limit):
        faulthandler.dump_traceback_later(limit, exit=True, file=_DUMP_FD)

    @pytest.fixture(scope="module", autouse=True)
    def _module_limit():
        arm(module_s)  # set up first: covers the module's own fixtures
        yield
        faulthandler.cancel_dump_traceback_later()  # torn down last

    @pytest.fixture(autouse=True)
    def _test_limit(_module_limit):
        arm(test_s)
        yield
        arm(module_s)  # the next test's set-up, or the module's tear-down

    return _module_limit, _test_limit


def _arm_watchdog():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True, file=_DUMP_FD)


class _SessionEnd:
    @pytest.hookimpl(wrapper=True)
    def pytest_sessionfinish(self):
        # after the session's tear-down, which runs inside this hook
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()
            # registered after every runtime's atexit shutdown, so run
            # before them: the dump covers them
            atexit.register(_arm_watchdog)


@pytest.fixture(scope="session", autouse=True)
def session_watchdog(pytestconfig):
    if not pytestconfig.pluginmanager.has_plugin("torch_session_end"):
        pytestconfig.pluginmanager.register(_SessionEnd(), "torch_session_end")
    yield
    _arm_watchdog()  # the session finalizers torn down after this one

import os

# Tests run with a controlled TWO-device CPU view so the transfer engine's
# multi-device paths (direct D2D copies, per-device transfer queues,
# indexed scheduler placement) are exercised in-process. Any user-supplied
# XLA_FLAGS are dropped first (the dry-run sets 512 in its own subprocess;
# multi-device tests that need more spawn subprocesses with their own
# counts).
os.environ.pop("XLA_FLAGS", None)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def pytest_sessionfinish(session, exitstatus):
    """Session-end sanitizer gate (active under REPRO_SANITIZE=1): the
    whole suite is the false-positive corpus. Every lock acquisition of
    every test fed one global may-precede graph; a cycle anywhere is a
    potential deadlock and fails the run even though no test hung."""
    from repro.core import sanitizer

    san = sanitizer.current()
    if san is None:
        return
    snap = san.stats_snapshot()
    cycles = san.lock_order_cycles()
    print(f"\n[sanitizer] {snap}")
    if cycles:
        print(f"[sanitizer] lock-order cycles: {cycles}")
        print(f"[sanitizer] edges: {sorted(san.lock_order_edges())}")
        session.exitstatus = 1
        raise sanitizer.SanitizerError(
            f"lock-order cycles observed across the suite: {cycles}")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips where there is none)")

"""Make ``src/`` importable regardless of how pytest is invoked.

NOTE: do NOT set XLA_FLAGS / device-count overrides here — smoke tests and
benches must see the real single-device CPU backend.  Only
``src/repro/launch/dryrun.py`` (run as its own process) forces 512 host
devices.
"""

import os
import sys

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if os.path.abspath(_SRC) not in (os.path.abspath(p) for p in sys.path):
    sys.path.insert(0, os.path.abspath(_SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's hand-written kernels); "
        "skipped without a card")

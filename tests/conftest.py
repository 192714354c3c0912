import os
import sys

# Make `repro` importable whether or not PYTHONPATH=src was set.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single CPU device; only launch/dryrun.py forces 512 host devices, and
# multi-device integration tests spawn subprocesses with their own flags.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); skipped without one")

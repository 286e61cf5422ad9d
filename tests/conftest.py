import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: no XLA_FLAGS here on purpose — tests see the real single CPU device.
# Multi-device behaviour is exercised via subprocesses (test_multidevice.py)
# and the dry-run driver, which own their device counts.


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end test (real compiles)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
                   "skips without one")


def pytest_addoption(parser):
    parser.addoption(
        "--corpus-update", action="store_true", default=False,
        help="anomaly-corpus replay: accept observed drift and rewrite "
             "benchmarks/results/anomaly_corpus.json instead of failing "
             "(use after an INTENDED behaviour change; review the diff)")

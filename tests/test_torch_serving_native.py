"""The reference's native-front scenarios against the port, on the CPU.

Every test of ``test_serving_native.py`` runs against the port's epoll
front (``serving/native_front.py`` over its own copy of
``native/src/httpfront.cpp``, built with g++ into the port's build
directory) and its load generator (``loadgen.cpp``), with the module's
``mmlspark_tpu.serving``, ``.io.http`` and ``.native`` imports pointed at
``mmlspark_torch`` (``torch_obs_port``): round trip and keep-alive, a
32-way burst, 404 routing, the 504 sweep, the latency guard, headers
reaching the pipeline, the closed loop on both fronts and non-200 replies
counted apart from success latency.
"""

import pytest
import torch

from torch_obs_port import port_reference_tests


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


globals().update(port_reference_tests("test_serving_native.py", rewrites=(
    ("mmlspark_tpu.serving", "mmlspark_torch.serving"),
    ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
    ("mmlspark_tpu.native", "mmlspark_torch.native"))))

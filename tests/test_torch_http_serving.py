"""The reference's HTTP and serving scenarios against the port, on the CPU.

Every test of ``test_http_serving.py`` runs against the port's
``io/http/`` and ``serving/`` (``torch_obs_port`` with the module's
``mmlspark_tpu.serving``, ``.io.http``, ``.core``, ``.lightgbm`` and
``.native`` imports pointed at ``mmlspark_torch``), on the same inputs and
with the same assertions: the HTTP transformers against a live echo
service, ``serving_query`` round trips and bursts on the threaded front,
404 routing, the DSL serving a fitted ``LightGBMRegressor``, mid-pipeline
replies, replay and exhausted retries, the Nagle-stall guard, quiet early
disconnects, continuous and micro-batch modes, the ``handler`` UDFParam and
``backend="auto"`` picking the native front. So do ``test_longtail_io.py``'s
port forwarders (``TestTcpForwarder``, ``TestSshTunnel``) and
``make_reply_udf`` test, and ``test_llm_serving.py``'s
``TestScenarioAndLoadgen`` (the LLM scenarios on the port's engine, and
``loadgen.summarize``).

The reference's scenarios build their models at the default device; the
fixture ``cpu_default`` points the port's ``resolve_device`` (and the
GBDT modules' bound copies) at the CPU while they run.
"""

import pytest
import torch

import mmlspark_torch.device as tdevice
import mmlspark_torch.lightgbm.booster as tbooster
import mmlspark_torch.lightgbm.trainer as ttrainer
from torch_obs_port import port_reference_tests

_resolve = tdevice.resolve_device


def _cpu_resolve(device=None):
    if device is None or torch.device(device).type == "cuda":
        return torch.device("cpu")
    return _resolve(device)


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    for mod in (tdevice, tbooster, ttrainer):
        monkeypatch.setattr(mod, "resolve_device", _cpu_resolve)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SERVING = (("mmlspark_tpu.serving", "mmlspark_torch.serving"),
            ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
            ("mmlspark_tpu.native", "mmlspark_torch.native"))

globals().update(port_reference_tests("test_http_serving.py", rewrites=(
    *_SERVING,
    ("mmlspark_tpu.core", "mmlspark_torch.core"),
    ("mmlspark_tpu.lightgbm", "mmlspark_torch.lightgbm"))))
globals().update(port_reference_tests("test_longtail_io.py", (
    # dataclass codecs, R bindings, file streams, PowerBI and the model
    # equality helper: the long tail (ROADMAP.md §1 item 11)
    "TestDataclassBindings", "TestColumnMetadata", "TestRGeneration",
    "TestFileStream", "TestPowerBIWriter",
    "test_assert_model_equal_catches_differences"), rewrites=_SERVING))
globals().update(port_reference_tests("test_llm_serving.py", (
    # the JAX engine's own contracts: the port's are in
    # test_torch_llm_serving.py
    "TestHandoff", "TestGreedyIdentity", "TestPrefixReuseAndTTFT",
    "TestSteadyState"), rewrites=(
    ("mmlspark_tpu.serving.loadgen", "mmlspark_torch.serving.loadgen"),)))

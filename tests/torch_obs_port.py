"""Runs a JAX-package test module's scenarios against the port.

``port_reference_tests("test_fleet.py", exclude)`` reads the reference test
module, points its imports of the modules the port has (``obs``, the
telemetry logger's name, ``sched``, ``resilience``, ``perf.costmodel``,
``stages`` and ``testing.benchmarks``) at ``mmlspark_torch``, executes it
as a module of its own and
returns its test classes and fixtures, less the tests named in
``exclude`` (``"TestClass.test_name"``). A test module that does
``globals().update(port_reference_tests(...))`` then collects the same
scenarios, on the same inputs and with the same assertions, against the
port: what the reference checks of its own package, the port is held to.
Everything else the module imports (numpy, the JAX package's other
modules) stays as it is. A rewritten name is a prefix of a dotted path, so
``mmlspark_tpu.sched`` also carries ``mmlspark_tpu.sched.policy`` and the
``"mmlspark_tpu.sched"`` logger across. ``rewrites=`` adds pairs for one
module (the compile slice's tests point ``mmlspark_tpu.core`` and
``mmlspark_tpu.featurize`` at the port too).
"""

import os
import types

TESTS = os.path.dirname(os.path.abspath(__file__))

_REWRITES = (("mmlspark_tpu.obs", "mmlspark_torch.obs"),
             ("mmlspark_tpu.telemetry", "mmlspark_torch.telemetry"),
             ("mmlspark_tpu.sched", "mmlspark_torch.sched"),
             ("mmlspark_tpu.resilience", "mmlspark_torch.resilience"),
             ("mmlspark_tpu.perf.costmodel", "mmlspark_torch.perf.costmodel"),
             ("mmlspark_tpu.stages", "mmlspark_torch.stages"),
             ("mmlspark_tpu.testing.benchmarks",
              "mmlspark_torch.testing.benchmarks"))


def port_reference_tests(name: str, exclude=(), rewrites=()) -> dict:
    """``rewrites``: more (JAX package prefix, port prefix) pairs for this
    module, applied before the shared ones."""
    path = os.path.join(TESTS, name)
    with open(path) as f:
        src = f.read()
    for old, new in (*rewrites, *_REWRITES):
        src = src.replace(old, new)
    mod = types.ModuleType(f"torch_port_of_{name[:-3]}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    ns = mod.__dict__
    for qual in exclude:
        if "." in qual:
            cls, meth = qual.split(".")
            delattr(ns[cls], meth)
        else:
            del ns[qual]
    out = {}
    for key, value in ns.items():
        if key.startswith("__"):
            continue
        if isinstance(value, type) and key.startswith("Test"):
            if not any(a.startswith("test") for a in vars(value)):
                continue
            value.__module__ = mod.__name__
        out[key] = value
    return out

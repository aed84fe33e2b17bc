"""Runtime registry (the port's own copy of the JAX package's
runtimes/__init__.py), keyed by ``tony.application.framework`` and the
per-role ``tony.<role>.framework`` override.

The port registers ``torch`` (its primary runtime and the default:
runtimes/torch_runtime.py, the counterpart of the JAX package's ``jax``),
``serving`` (SlotServer replicas), ``standalone`` and ``generic``. The JAX
package's other framework runtimes are refused by name: each waits for
ROADMAP.md queue 1's item for them.
"""

from __future__ import annotations

from .base import DriverAdapter, Runtime, TaskAdapter, TaskContext
from .generic import (
    GenericDriverAdapter,
    GenericTaskAdapter,
    StandaloneDriverAdapter,
    StandaloneTaskAdapter,
)
from .serving import ServingDriverAdapter, ServingTaskAdapter
from .torch_runtime import TorchDriverAdapter, TorchTaskAdapter

# the JAX package's runtimes the port does not have, and why
NOT_PORTED = {
    "jax": "the port's counterpart of the jax runtime is 'torch' (the "
           "default framework)",
    "tensorflow": "ROADMAP.md queue 1, 'other framework runtimes'",
    "pytorch": "ROADMAP.md queue 1, 'other framework runtimes' (the "
               "reference's INIT_METHOD/RANK/WORLD contract; the port's "
               "torch runtime exports the TONY_* one)",
    "mxnet": "ROADMAP.md queue 1, 'other framework runtimes'",
    "horovod": "ROADMAP.md queue 1, 'other framework runtimes'",
    "ray": "ROADMAP.md queue 1, 'other framework runtimes'",
    "router": "ROADMAP.md queue 1, 'the router, its role and HA'",
}


class _SimpleRuntime(Runtime):
    def __init__(self, name: str, driver_cls, task_cls):
        self.name = name
        self._driver_cls = driver_cls
        self._task_cls = task_cls

    def driver_adapter(self) -> DriverAdapter:
        return self._driver_cls()

    def task_adapter(self) -> TaskAdapter:
        return self._task_cls()


_REGISTRY: dict[str, Runtime] = {}


def register_runtime(runtime: Runtime) -> None:
    _REGISTRY[runtime.name] = runtime


for _name, _d, _t in (
    ("torch", TorchDriverAdapter, TorchTaskAdapter),
    ("serving", ServingDriverAdapter, ServingTaskAdapter),
    ("standalone", StandaloneDriverAdapter, StandaloneTaskAdapter),
    ("generic", GenericDriverAdapter, GenericTaskAdapter),
):
    register_runtime(_SimpleRuntime(_name, _d, _t))


def get_runtime(name: str) -> Runtime:
    key = name.lower()
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"framework runtime {name!r} is not ported: {NOT_PORTED[key]}")
    raise ValueError(
        f"unknown framework runtime {name!r}; known: {sorted(_REGISTRY)}")


__all__ = [
    "DriverAdapter",
    "TaskAdapter",
    "TaskContext",
    "Runtime",
    "get_runtime",
    "register_runtime",
    "NOT_PORTED",
]

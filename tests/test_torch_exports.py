"""Package exports: an import that works on `bigdl_tpu` works on the port.

For every package both trees have, each name the reference package exports
(its `__all__`, else its public attributes) must be an attribute of the
port's package too, whenever the port has the module that defines the
name in the reference and that port module defines it as well. Names the
port has not ported yet are left to `tests/test_torch_signatures.py` and
`ROADMAP.md`.
"""

import importlib
import pkgutil
import types

import pytest

import bigdl_tpu_torch


def _shared_packages():
    names = ["bigdl_tpu_torch"] + [
        info.name for info in pkgutil.walk_packages(
            bigdl_tpu_torch.__path__, "bigdl_tpu_torch.") if info.ispkg]
    out = []
    for name in names:
        ref = "bigdl_tpu" + name[len("bigdl_tpu_torch"):]
        try:
            if importlib.util.find_spec(ref) is not None:
                out.append((name, ref))
        except ModuleNotFoundError:
            pass
    return sorted(out)


PACKAGES = _shared_packages()


def _exported(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in dir(module) if not n.startswith("_")]
    return names


def _owed(port_name, ref_name):
    """(name, defining module) of each reference export the port owes."""
    ref = importlib.import_module(ref_name)
    owed = []
    for name in _exported(ref):
        obj = getattr(ref, name)
        origin = getattr(obj, "__module__", None)
        if isinstance(obj, types.ModuleType) or not origin \
                or not origin.startswith("bigdl_tpu."):
            continue
        port_origin = "bigdl_tpu_torch" + origin[len("bigdl_tpu"):]
        try:
            port_module = importlib.import_module(port_origin)
        except ModuleNotFoundError:
            continue
        if name in vars(port_module):
            owed.append((name, port_origin))
    return owed


def test_the_walk_sees_the_shared_packages():
    names = {p for p, _ in PACKAGES}
    assert {"bigdl_tpu_torch", "bigdl_tpu_torch.utils",
            "bigdl_tpu_torch.models", "bigdl_tpu_torch.optim",
            "bigdl_tpu_torch.parallel", "bigdl_tpu_torch.nn"} <= names


@pytest.mark.parametrize("port_name,ref_name", PACKAGES,
                         ids=[p for p, _ in PACKAGES])
def test_the_port_package_exports_what_the_reference_does(port_name,
                                                          ref_name):
    port = importlib.import_module(port_name)
    missing = [f"{name} (defined in {where})"
               for name, where in _owed(port_name, ref_name)
               if not hasattr(port, name)]
    assert not missing, f"{port_name} lacks: " + ", ".join(missing)


def test_the_fault_names_import_as_from_the_reference():
    from bigdl_tpu_torch.models import basic_block, bottleneck
    from bigdl_tpu_torch.optim import (Adam, DistriOptimizer, DistriPredictor,
                                       ParallelAdam, ParallelOptimizer)
    from bigdl_tpu_torch.parallel import (GPipe, MoE, PipelineStages,
                                          data_sharding, replicate_sharding,
                                          split_sequential)
    from bigdl_tpu_torch.utils import Engine
    from bigdl_tpu_torch.utils.engine import Engine as E
    assert Engine is E and ParallelAdam is Adam
    assert issubclass(ParallelOptimizer, DistriOptimizer)
    assert callable(basic_block) and callable(bottleneck)
    assert all(callable(f) for f in (GPipe, MoE, PipelineStages,
                                     data_sharding, replicate_sharding,
                                     split_sequential, DistriPredictor))

"""tests/test_scripts.py's static checks on the port's drivers
(mind_tpu_torch/scripts/*.py): each file parses, imports without error,
binds every name it loads, and each driver has main(argv) -> int; and
every driver's output defaults lie under outputs/torch/. One case per file,
so each counts.
"""

import argparse
import builtins
import importlib
import inspect
import pathlib

import pytest

from test_scripts import _IMPLICIT, _bound_and_loaded

ROOT = pathlib.Path(__file__).resolve().parent.parent
DRIVERS = sorted((ROOT / "mind_tpu_torch" / "scripts").glob("*.py"))


def module_of(path):
    name = "mind_tpu_torch.scripts"
    return name if path.stem == "__init__" else f"{name}.{path.stem}"


@pytest.mark.parametrize("path", DRIVERS, ids=lambda p: p.name)
def test_driver_has_no_unbound_names(path):
    import ast

    tree = ast.parse(path.read_text(), filename=str(path))
    bound, loaded = _bound_and_loaded(tree)
    allowed = bound | set(dir(builtins)) | _IMPLICIT
    bad = sorted({(n.id, n.lineno) for n in loaded if n.id not in allowed})
    assert not bad, f"{path.name} loads names bound nowhere in the file: {bad}"


@pytest.mark.parametrize("path", DRIVERS, ids=lambda p: p.name)
def test_driver_imports(path):
    mod = importlib.import_module(module_of(path))
    if path.stem == "__init__":
        names = [p.stem for p in DRIVERS if p.stem != "__init__"]
        assert all(f"- {n} (scripts/{n}.py)" in mod.__doc__ for n in names)   # listed
        return
    assert list(inspect.signature(mod.main).parameters) == ["argv"]
    assert inspect.signature(mod.main).parameters["argv"].default is None


@pytest.mark.parametrize("path", [p for p in DRIVERS if p.stem != "__init__"],
                         ids=lambda p: p.name)
def test_driver_defaults_write_under_outputs_torch(path, monkeypatch):
    """The defaults of every option naming a file are under outputs/torch/
    (the JAX scripts' defaults are the committed TPU artifacts)."""
    from mind_tpu_torch import scripts

    parsers = []
    real = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, *a, **kw: parsers.append(self) or real(self, *a, **kw))
    mod = importlib.import_module(module_of(path))
    argv = ["--synthetic"] if "--synthetic" in path.read_text() else []
    if path.stem == "bench_unroll_ab":
        argv = ["label", *argv]
    mod._parse(argv)
    defaults = [a.default for a in parsers[0]._actions
                if isinstance(a.default, str) and ("/" in a.default or "." in a.default)]
    for d in defaults:
        p = pathlib.Path(d).resolve()
        assert scripts.OUT in p.parents, f"{path.name}: default {d}"

"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every import of every module
under tgbench/, compared by its top-level name whole."""
import ast
import os

import pytest

from tgbench import harness

HERE = harness.HERE
JAX_NAMES = {"jax", "jaxlib", "flax", "tamgcn_tpu"}


def modules():
    for root, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), HERE)


def top_level_imports(path: str) -> set:
    with open(os.path.join(HERE, path)) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", list(modules()))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX_NAMES, path


@pytest.mark.parametrize("path", [p for p in modules() if p.startswith("reference" + os.sep)])
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX_NAMES | {"tamgcn_tpu_torch"}), path


def test_names_are_compared_whole():
    """The port's name begins with the JAX package's: a prefix match would
    flag it; the whole top-level name does not."""
    assert "tamgcn_tpu_torch".split(".")[0] not in JAX_NAMES
    assert harness.forbidden_modules() == sorted(
        {"jax", "jaxlib", "flax", "tamgcn_tpu"} & {n.split(".")[0] for n in __import__("sys").modules})


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "tamgcn_tpu"])
def test_the_run_refuses_a_process_holding_jax(monkeypatch, capsys, name):
    """A module loaded after the window (by a reader or the reference) is
    caught too: the look comes just before the result line, which is then
    not printed."""
    import sys
    import types

    from tgbench import run

    checks = [harness.Check("logit_gap", 0.0, 1.0)]
    assert run.finish({"correct": True}, checks) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == '{"correct": true}'
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [name]
    assert run.finish({"correct": True}, checks) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and name in captured.err

"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the program: each module parsed with
``ast``, each imported module's top-level name compared whole."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "stylegan_for_facerec_tpu"}


def modules():
    for dirpath, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), HERE)


def imported(path):
    tree = ast.parse(open(os.path.join(HERE, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


@pytest.mark.parametrize("path", sorted(modules()))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in imported(path)
            if not name.startswith(".")}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(p for p in modules()
                                        if p.startswith("reference")))
def test_reference_imports_nothing_of_the_program(path):
    for name in imported(path):
        top = name.split(".")[0]
        assert top not in ("stylegan_for_facerec_torch", "port_bench"), \
            (path, name)
        assert not name.startswith(".."), (path, name)


def test_module_names_compared_whole():
    """The port's name starts with the JAX package's name."""
    assert "stylegan_for_facerec_torch".split(".")[0] not in FORBIDDEN

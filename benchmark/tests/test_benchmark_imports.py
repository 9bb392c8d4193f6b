"""Nothing under benchmark/ imports JAX or the JAX package, and the references import
nothing of the port. Names are compared whole, by their top-level part:
`embodied_clip_tpu_torch` begins with `embodied_clip_tpu` and is not it."""

import ast

import pytest

from benchmark.harness.cell import HERE

JAX = {"jax", "jaxlib", "flax", "embodied_clip_tpu"}
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "embodied_clip_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "collections", "math", "numpy",
                                       "torch"}


def test_whole_name_comparison():
    assert "embodied_clip_tpu_torch".split(".")[0] not in JAX

"""What the benchmark's modules import, by top-level name compared
whole: nothing of JAX or the JAX package anywhere, and nothing of the
program in the reference's modules."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
# what the reference is made of: it judges the program and takes nothing
# from it
REFERENCE = ("reference.py", "feed.py", "philox.py", "symbols.py", "weights.py", "compare.py",
             "corpus.py", "cost.py", "families/plbert.py")


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_compared_whole():
    """``pl_bert_tpu_torch`` begins with ``pl_bert_tpu`` and is not it."""
    assert _top_level_imports(HERE / "run.py") & {"pl_bert_tpu_torch"}
    assert not _top_level_imports(HERE / "run.py") & {"pl_bert_tpu"}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "pl_bert_tpu"}


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_takes_nothing_of_the_program(name):
    assert "pl_bert_tpu_torch" not in _top_level_imports(HERE / name)

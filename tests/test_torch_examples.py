"""The port's example scripts (``examples/*_torch.sh``): each parses with
``bash -n``, takes its device from ``DEVICE`` (default ``cuda``, as the
entry points default) and passes it on as ``--device`` to every entry
point that runs a model, and every module it runs with ``python -m`` or
imports is a module of the port that exists; none names the JAX
package."""

import importlib.util
import re
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = ["end_to_end_torch.sh", "serve_http_torch.sh", "migrate_from_reference_torch.sh"]
ON_DEVICE = ("training.train", "training.evaluate", "serving.server", "models.inference")


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_script_runs_the_port(name):
    path = REPO / "examples" / name
    subprocess.run(["bash", "-n", str(path)], check=True)
    text = path.read_text(encoding="utf-8")
    assert 'DEVICE="${DEVICE:-cuda}"' in text
    assert not re.search(r"\bpl_bert_tpu\.", text)
    calls = re.findall(r"python -m ([\w.]+)((?:[^\n]*\\\n)*[^\n]*)", text)
    imports = re.findall(r"^from ([\w.]+) import", text, re.M)
    assert calls
    for module in [m for m, _ in calls] + imports:
        assert module.startswith("pl_bert_tpu_torch."), module
        assert importlib.util.find_spec(module) is not None, module
    for module, args in calls:
        if module.removeprefix("pl_bert_tpu_torch.") in ON_DEVICE:
            assert '--device "$DEVICE"' in args, (module, args)

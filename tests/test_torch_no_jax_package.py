"""The port stands alone: in a fresh interpreter where importing ``jax``,
``flax`` or the JAX package ``pl_bert_tpu`` raises, every module of
``pl_bert_tpu_torch`` and every module ``chip_smoke.py`` imports load,
and the port's HTTP server builds on the CPU and answers a request."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

BLOCKER = '''
import importlib.abc, sys

class _Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "pl_bert_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Blocked())
'''


def _port_modules() -> list[str]:
    pkg = REPO / "pl_bert_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
        # the Triton kernel source needs triton and loads only at a launch
        if p.name != "_ln_triton.py" and "_build" not in p.parts
    )


def _smoke_imports() -> list[str]:
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return sorted(names)


def _run(code: str, tmp_path) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER + code], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                          "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_every_port_module_and_smoke_import_loads_without_the_jax_package(tmp_path):
    mods = _port_modules()
    smoke = [m for m in _smoke_imports() if m != "torch.nn.functional"]
    assert "pl_bert_tpu_torch.training.train_step" in mods
    assert any(m.startswith("pl_bert_tpu_torch") for m in smoke)
    out = _run(
        "import importlib\n"
        "try:\n    import pl_bert_tpu\nexcept ImportError:\n    print('blocked')\n"
        f"for m in {mods + smoke!r}:\n    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'pl_bert_tpu'))\n"
        "assert not bad, bad\nprint('ok')\n",
        tmp_path,
    )
    assert out.split() == ["blocked", "ok"]


def test_port_server_builds_and_answers_without_the_jax_package(tmp_path):
    code = f'''
import http.client, json, torch
from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.models.albert import AlbertConfig, AlbertModel
from pl_bert_tpu_torch.serving.server import build_server, serve_in_thread

cfg = Config.from_dict({{"model_params": dict(
    hidden_size=128, num_attention_heads=2, intermediate_size=256,
    max_position_embeddings=64, num_hidden_layers=2, embedding_size=32),
    "dataset_params": {{"max_seq_length": 64}}}})
cfg.save({str(tmp_path / "cfg.yml")!r})
torch.manual_seed(0)
sd = AlbertModel(AlbertConfig.from_params(cfg.model_params)).state_dict()
torch.save({{"net": {{"encoder." + k: v for k, v in sd.items()}}}}, {str(tmp_path / "s.pth")!r})
server = build_server(["--checkpoint", {str(tmp_path / "s.pth")!r}, "--config_path",
                       {str(tmp_path / "cfg.yml")!r}, "--port", "0", "--device", "cpu",
                       "--max_batch", "2", "--buckets", "16"])
serve_in_thread(server)
try:
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    conn.request("POST", "/encode", body=json.dumps({{"phonemes": "qalam"}}),
                 headers={{"Content-Type": "application/json"}})
    reply = json.loads(conn.getresponse().read())
    conn.request("GET", "/stats")
    stats = json.loads(conn.getresponse().read())
finally:
    server.shutdown()
    server.batcher.close()
    server.server_close()
assert reply["length"] == 5 and len(reply["hidden"][0]) == 128, reply.keys()
assert stats["requests"] == 1, stats
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pl_bert_tpu"))
assert not bad, bad
print("served")
'''
    assert _run(code, tmp_path).split() == ["served"]

"""The port stands alone: in a fresh interpreter where importing ``jax``,
``flax``, ``orbax``, the JAX package ``pl_bert_tpu``, ``transformers``
or ``safetensors`` raises, every module of ``pl_bert_tpu_torch`` and
every module ``chip_smoke.py`` imports load, the port's HTTP server
builds on the CPU and answers a request, the port's Trainer runs a
packed run and resumes it, a multi-task run trains and
``training/evaluate.py`` scores it, a corpus goes through the pack CLI,
``verify_store`` and the elastic launcher into a Trainer run from the
packed store, raw Arabic text goes through the clean, phonemize and
tokenize stages, a checkpoint goes through the export CLI into
``from_hf_export`` and an int8 forward, and two ranks over gloo take a
tensor- and sequence-parallel step with ZeRO-1 through the Trainer."""

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
        if top in ("jax", "jaxlib", "flax", "orbax", "pl_bert_tpu", "transformers",
                   "safetensors"):
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
    for new in ("ops.flash_attention", "ops.ondevice_masking", "data.packed", "data.pipeline",
                "training.checkpoint", "training.metrics", "training.train", "utils.profiler",
                "tools.bench_fused_ln", "training.evaluate", "ops.masked_ce",
                "data.packed_store", "data.verify_store", "preprocess.shard_engine",
                "preprocess.pipeline", "training.orchestrate", "runtime",
                "export.safetensors", "export.to_hf", "export.cli", "ops.quant",
                "serving.client", "parallel.mesh", "parallel.tp", "parallel.collectives",
                "text.normalize", "text.arabic_numbers", "text.word_tokenizer",
                "text.converters", "text.converters.Measure", "text.converters.numbers",
                "preprocess.phonemize", "preprocess.diacritize", "data.dataset"):
        assert f"pl_bert_tpu_torch.{new}" in mods, new
    assert "pl_bert_tpu_torch.training.train" in smoke
    assert "pl_bert_tpu_torch.tools" in smoke or "pl_bert_tpu_torch.tools.bench_fused_ln" in smoke
    assert any(m.startswith("pl_bert_tpu_torch") for m in smoke)
    out = _run(
        "import importlib\n"
        "try:\n    import pl_bert_tpu\nexcept ImportError:\n    print('blocked')\n"
        f"for m in {mods + smoke!r}:\n    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'orbax', 'pl_bert_tpu', 'transformers', 'safetensors'))\n"
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


def test_port_two_rank_step_without_the_jax_package(tmp_path):
    """Two ranks (model 2, sequence parallelism, ZeRO-1 on the 1×2 mesh)
    train one step through ``training.train.train`` on the CPU, each in an
    interpreter where the JAX package cannot be imported."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = f'''
import os, yaml
os.environ.update(PLBERT_DISTRIBUTED="1", PLBERT_COORDINATOR="localhost:{port}",
                  PLBERT_NUM_PROCESSES="2", PLBERT_PROCESS_ID=RANK)
from pl_bert_tpu_torch.training.train import train

cfg = {str(tmp_path / "cfg.yml")!r}
if RANK == "0":
    raw = {{
        "training_params": dict(output_dir={str(tmp_path / "runs")!r}, mixed_precision="fp32",
                                batch_size=4, save_interval=1, num_steps=1, model_axis=2,
                                zero1=True, training_dataset="synthetic:80:0:3-12"),
        "dataset_params": dict(max_seq_length=64, ondevice_masking=True),
        "model_params": dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                             max_position_embeddings=64, num_hidden_layers=2,
                             embedding_size=32, sequence_parallel=True),
    }}
    with open(cfg + ".tmp", "w") as f:
        yaml.safe_dump(raw, f)
    os.replace(cfg + ".tmp", cfg)
while not os.path.exists(cfg):
    pass
assert train({{"config_path": cfg, "run_name": "r", "device": "cpu"}}) == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "orbax", "pl_bert_tpu"))
assert not bad, bad
print("stepped")
'''
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": str(REPO),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", BLOCKER + f"RANK = {str(r)!r}\n" + code],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(2)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0 and out.split()[-1] == "stepped", out[-4000:]
    assert (tmp_path / "runs" / "r" / "step_1.pth").exists()


def test_port_trainer_runs_and_resumes_without_the_jax_package(tmp_path):
    code = f'''
import os, yaml
from pl_bert_tpu_torch.training.train import train
from pl_bert_tpu_torch.training.checkpoint import list_checkpoints

cfg = {str(tmp_path / "cfg.yml")!r}
raw = {{
    "training_params": dict(output_dir={str(tmp_path / "runs")!r}, mixed_precision="fp32",
                            batch_size=4, save_interval=2, log_interval=1, num_steps=2,
                            training_dataset="synthetic:80:0:3-12"),
    "dataset_params": dict(max_seq_length=64, ondevice_masking=True, sequence_packing=True),
    "model_params": dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                         max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
                         attention_impl="pallas"),
}}
def write(path, steps):
    raw["training_params"]["num_steps"] = steps
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
write(cfg, 2)
args = {{"config_path": cfg, "run_name": "r", "device": "cpu"}}
assert train(args) == 2
write(os.path.join({str(tmp_path / "runs" / "r")!r}, "cfg.yml"), 4)
assert train(args) == 4
assert list_checkpoints({str(tmp_path / "runs" / "r")!r}) == [2, 4]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "orbax", "pl_bert_tpu"))
assert not bad, bad
print("trained")
'''
    assert _run(code, tmp_path).split()[-1] == "trained"


def test_port_multitask_trainer_and_evaluate_without_the_jax_package(tmp_path):
    code = f'''
import json, yaml
from pl_bert_tpu_torch.training.evaluate import evaluate
from pl_bert_tpu_torch.training.train import train

cfg = {str(tmp_path / "cfg.yml")!r}
raw = {{
    "training_params": dict(output_dir={str(tmp_path / "runs")!r}, mixed_precision="fp32",
                            batch_size=4, save_interval=2, log_interval=1, num_steps=2,
                            training_dataset="synthetic:80:0:3-12", grad_accum_steps=2,
                            lm_head_capacity=8),
    "dataset_params": dict(max_seq_length=64, ondevice_masking=True, sequence_packing=True),
    "model_params": dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                         max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
                         num_token_vocab=100),
}}
with open(cfg, "w") as f:
    yaml.safe_dump(raw, f)
assert train({{"config_path": cfg, "run_name": "mt", "device": "cpu"}}) == 2
out = evaluate({{"checkpoint": {str(tmp_path / "runs" / "mt")!r}, "config_path": cfg,
                 "device": "cpu"}})
assert out["val_token_loss"] > 0, out
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "orbax", "pl_bert_tpu"))
assert not bad, bad
print("evaluated")
'''
    assert _run(code, tmp_path).split()[-1] == "evaluated"


def test_pack_verify_and_launch_from_a_store_without_the_jax_package(tmp_path):
    code = f'''
import yaml
from pl_bert_tpu_torch import runtime
from pl_bert_tpu_torch.data import verify_store
from pl_bert_tpu_torch.preprocess import pipeline
from pl_bert_tpu_torch.preprocess.shard_engine import combine_and_save
from pl_bert_tpu_torch.training.orchestrate import launch
from pl_bert_tpu_torch.training.train import make_synthetic_corpus

src = {str(tmp_path / "phonemized")!r}
combine_and_save([make_synthetic_corpus(40, words_per_sample=(3, 12))], src)
cfg = {str(tmp_path / "cfg.yml")!r}
raw = {{
    "training_params": dict(output_dir={str(tmp_path / "runs")!r}, mixed_precision="fp32",
                            batch_size=4, save_interval=2, log_interval=1, num_steps=2,
                            training_dataset=src + ".packed"),
    "dataset_params": dict(max_seq_length=64, ondevice_masking=True, sequence_packing=True),
    "model_params": dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                         max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
                         attention_impl="pallas"),
}}
with open(cfg, "w") as f:
    yaml.safe_dump(raw, f)
pipeline.main(["--stage", "pack", "--dataset_path", src, "--config_path", cfg])
assert runtime.NATIVE_PACKS.count > 0 and runtime.NUMPY_PACKS.count == 0
verify_store.main([src + ".packed"])
assert launch({{"config_path": cfg, "run_name": "r", "device": "cpu"}}, max_restarts=0,
              restart_delay=0.0) == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "orbax", "pl_bert_tpu", "datasets"))
assert not bad, bad
print("launched")
'''
    out = _run(code, tmp_path)
    assert "OK (full scan)" in out and out.split()[-1] == "launched"


def test_text_stages_without_the_jax_package(tmp_path):
    """clean → phonemize → tokenize through the port's pipeline CLI on a
    small Arabic corpus (digits verbalised, Latin dropped), the shard
    engine forking its workers, with the JAX package blocked."""
    code = f'''
import json, os, yaml
from pl_bert_tpu_torch.preprocess import pipeline

root = {str(tmp_path)!r}
corpus = os.path.join(root, "corpus.txt")
with open(corpus, "w", encoding="utf-8") as f:
    f.write("ولد الكاتب عام 1986 في مدينة كبيرة، وكان يحب القراءة.\\n"
            "كتب 3 رسائل hello إلى أصدقائه.\\n")
cfg = os.path.join(root, "cfg.yml")
yaml.safe_dump({{"preprocess_params": dict(num_shards=2, max_workers=2, max_try_count=1,
    preprocess_dir=os.path.join(root, "prep"), cleaned_output_dir="cleaned",
    g2p_backend="identity")}}, open(cfg, "w"))
prep = os.path.join(root, "prep")
pipeline.main(["--config_path", cfg, "--stage", "clean", "--local_dataset_path", corpus])
pipeline.main(["--config_path", cfg, "--stage", "phonemize", "--dataset_path",
               os.path.join(prep, "cleaned")])
pipeline.main(["--config_path", cfg, "--stage", "tokenize", "--dataset_path",
               os.path.join(prep, "cleaned.phonemized")])
rows = [json.loads(l) for l in open(os.path.join(prep, "cleaned.phonemized.tokenized",
                                                  "records.jsonl"), encoding="utf-8")]
assert len(rows) == 2 and all(r["token_alignment"] == "exact" for r in rows), rows
assert "1986" not in rows[0]["text"] and "hello" not in rows[1]["text"]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "pl_bert_tpu"))
assert not bad, bad
print("stages", len(rows[0]["phonemes"]))
'''
    last = _run(code, tmp_path).splitlines()[-1].split()
    assert last[0] == "stages" and int(last[1]) > 10


def test_export_and_int8_serving_without_the_jax_package_or_transformers(tmp_path):
    code = f'''
import numpy as np, torch
from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.export import cli
from pl_bert_tpu_torch.models.albert import build_model, init_params
from pl_bert_tpu_torch.models.inference import PhonemeEncoder

cfg = Config.from_dict({{"model_params": dict(
    hidden_size=128, num_attention_heads=2, intermediate_size=256,
    max_position_embeddings=64, num_hidden_layers=2, embedding_size=32),
    "dataset_params": {{"max_seq_length": 64}}}})
cfg.save({str(tmp_path / "cfg.yml")!r})
model = init_params(build_model(cfg.model_params, "fp32"), seed=0)
torch.save({{"net": model.state_dict(), "step": 5, "epoch": 0}}, {str(tmp_path / "step_5.pth")!r})
out = cli.main(["--checkpoint_path", {str(tmp_path / "step_5.pth")!r}, "--config_path",
                {str(tmp_path / "cfg.yml")!r}, "--output_dir", {str(tmp_path / "hf")!r}])
hf = PhonemeEncoder.from_hf_export(out, device="cpu", mixed_precision="fp32")(["qalam"])[0]
pth = PhonemeEncoder.from_checkpoint({str(tmp_path / "step_5.pth")!r}, cfg, device="cpu",
                                     mixed_precision="fp32")(["qalam"])[0]
assert np.array_equal(hf, pth)
q = PhonemeEncoder.from_hf_export(out, device="cpu", quantize="int8")
assert q.weights["encoder"]["mapping"]["wq"].dtype == torch.int8
h, n = q(["qalam"])
assert np.isfinite(h).all() and n[0] == 5
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "flax", "orbax", "pl_bert_tpu", "transformers", "safetensors"))
assert not bad, bad
print("exported")
'''
    assert _run(code, tmp_path).split()[-1] == "exported"

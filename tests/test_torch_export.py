"""The port's HF export and loading against the JAX package's and
transformers': its ``.safetensors`` reader and writer against the
``safetensors`` package, exports crossing between the two packages in
both directions and into ``transformers.AlbertModel``, ``config.json``
against JAX's, the multi-task export, ``from_hf_export``, and the
server and the inference CLI on ``--hf_dir --int8``."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from safetensors import safe_open
from safetensors.torch import load_file as package_load
from safetensors.torch import save_file as package_save

from pl_bert_tpu.config import Config as JaxConfig
from pl_bert_tpu.config import ModelParams
from pl_bert_tpu.export import to_hf as jax_to_hf
from pl_bert_tpu.models.albert import build_model, init_params
from pl_bert_tpu.models.inference import PhonemeEncoder as JaxEncoder
from pl_bert_tpu_torch.export import bridge, cli, to_hf
from pl_bert_tpu_torch.export import safetensors as port_st
from pl_bert_tpu_torch.models.albert import AlbertConfig, AlbertModel
from pl_bert_tpu_torch.models.inference import PhonemeEncoder

SMALL = {
    "model_params": {
        "hidden_size": 96, "num_attention_heads": 4, "intermediate_size": 192,
        "max_position_embeddings": 64, "num_hidden_layers": 3, "embedding_size": 48,
        "dropout": 0.0, "attention_impl": "xla",
    },
    "dataset_params": {"max_seq_length": 64},
}
TEXTS = ["qalam", "bajt ʃams", "ˈmaʕna θaːbit", "ab"]


def _tensors():
    rng = np.random.default_rng(0)
    out = {
        "a.f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "b.f64": torch.from_numpy(rng.normal(size=(7,))),
        "c.i64": torch.from_numpy(rng.integers(-2**40, 2**40, (2, 2, 3))),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }
    out["d.bf16"] = out["a.f32"].to(torch.bfloat16)
    out["e.f16"] = out["a.f32"].t().to(torch.float16)  # not contiguous
    return out


def test_port_writer_read_by_safetensors_package(tmp_path):
    path = str(tmp_path / "t.safetensors")
    tensors = _tensors()
    port_st.save_file(tensors, path, metadata={"note": "x"})
    (n,) = np.frombuffer(open(path, "rb").read(8), "<u8")
    assert n % 8 == 0
    back = package_load(path)
    assert back.keys() == tensors.keys()
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"format": "pt", "note": "x"}


def test_package_writer_read_by_port(tmp_path):
    path = str(tmp_path / "t.safetensors")
    tensors = {k: v.contiguous() for k, v in _tensors().items()}
    package_save(tensors, path, metadata={"format": "pt"})
    back, meta = port_st.read(path)
    assert meta == {"format": "pt"} and back.keys() == tensors.keys()
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    back["a.f32"].add_(1.0)  # writable, and not the file's bytes


def test_port_reader_refuses_malformed_files(tmp_path):
    path = str(tmp_path / "i32.safetensors")
    package_save({"x": torch.arange(4, dtype=torch.int32)}, path)
    with pytest.raises(ValueError, match="not one of"):
        port_st.read(path)
    good = str(tmp_path / "good.safetensors")
    port_st.save_file({"x": torch.ones(16)}, good)
    cut = str(tmp_path / "cut.safetensors")
    with open(good, "rb") as f, open(cut, "wb") as g:
        g.write(f.read()[:-4])
    with pytest.raises(ValueError, match="offsets"):
        port_st.read(cut)


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A directory from JAX's ``export_checkpoint`` (through transformers'
    ``save_pretrained``) and the params it was written from."""
    params = init_params(build_model(ModelParams(**SMALL["model_params"]), "fp32"), 64, seed=3)
    out = str(tmp_path_factory.mktemp("jax") / "hf")
    jax_to_hf.export_checkpoint(params, JaxConfig.from_dict(SMALL).to_dict(), out, step=12,
                                epoch=1, checkpoint_path="/ckpt/step_12")
    return params, out


@pytest.fixture(scope="module")
def port_export(jax_export, tmp_path_factory):
    """The same params as a port ``.pth`` (heads and all), exported by
    the port's CLI."""
    params, _ = jax_export
    root = tmp_path_factory.mktemp("port")
    cfg = str(root / "cfg.yml")
    with open(cfg, "w", encoding="utf-8") as f:
        yaml.safe_dump(SMALL, f)
    pth = str(root / "step_7.pth")
    net = bridge.model_state_dict_from_jax({k: params[k] for k in ("encoder", "phoneme_predictor")})
    torch.save({"net": net, "step": 7, "epoch": 2}, pth)
    out = cli.main(["--checkpoint_path", pth, "--config_path", cfg,
                    "--output_dir", str(root / "exports" / "hf")])
    return params, out, cfg


def test_jax_export_loads_into_port_bitwise(jax_export, tmp_path):
    params, out = jax_export
    want = bridge.state_dict_from_jax(params["encoder"])
    sd, config = to_hf.load_pl_bert_model(out)
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], v), k
    assert config["model_params"]["hidden_size"] == 96
    # pytorch_model.bin (HF's older save, with the position-id buffer)
    # when there is no model.safetensors
    old = str(tmp_path / "bin")
    shutil.copytree(out, old)
    os.remove(os.path.join(old, "model.safetensors"))
    torch.save({**want, "embeddings.position_ids": torch.arange(64)[None]},
               os.path.join(old, "pytorch_model.bin"))
    sd_bin, _ = to_hf.load_pl_bert_model(old)
    assert all(torch.equal(sd_bin[k], v) for k, v in want.items()) and sd_bin.keys() == want.keys()
    # strict keys, and no sharded checkpoint
    torch.save({**want, "encoder.extra": torch.zeros(1)}, os.path.join(old, "pytorch_model.bin"))
    with pytest.raises(ValueError, match="unexpected=\\['encoder.extra'\\]"):
        to_hf.load_pl_bert_model(old)
    open(os.path.join(old, "pytorch_model.bin.index.json"), "w").write("{}")
    with pytest.raises(ValueError, match="sharded"):
        to_hf.load_pl_bert_model(old)


def test_from_hf_export_matches_jax(jax_export):
    """``from_hf_export`` on JAX's directory against JAX's own, fp32, at
    tests/test_torch_model.py's gate."""
    _, out = jax_export
    ref, ref_len = JaxEncoder.from_hf_export(out, mixed_precision="fp32", batch_size=4)(TEXTS)
    got, lengths = PhonemeEncoder.from_hf_export(out, mixed_precision="fp32", batch_size=4,
                                                 device="cpu")(TEXTS)
    np.testing.assert_array_equal(lengths, ref_len)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], atol=5e-4, rtol=1e-3)


def test_port_export_loads_into_jax_and_transformers(port_export):
    from transformers import AlbertModel as HFAlbert

    params, out, _ = port_export
    encoder, config = jax_to_hf.load_pl_bert_model(out)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from (leaves(v, prefix + (k,)) if isinstance(v, dict)
                        else [(prefix + (k,), np.asarray(v))])

    got, want = dict(leaves(encoder)), dict(leaves(params["encoder"]))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg="/".join(path))
    assert {k: config["model_params"][k] for k in SMALL["model_params"]} == SMALL["model_params"]
    hf, info = HFAlbert.from_pretrained(out, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    assert not info["mismatched_keys"] and hf.config.vocab_size == 188
    ids = np.random.default_rng(0).integers(0, 188, (2, 64))
    with torch.no_grad():
        ref = hf.eval()(torch.from_numpy(ids)).last_hidden_state.numpy()
    model = AlbertModel.from_state_dict(
        AlbertConfig.from_params(ModelParams(**SMALL["model_params"])),
        to_hf.load_pl_bert_model(out)[0])
    with torch.inference_mode():
        h, _ = model(torch.from_numpy(ids))
    # tests/test_export.py's fp32 envelope (two BLAS stacks' summation orders)
    np.testing.assert_allclose(h.numpy(), ref, rtol=1e-5, atol=5e-6)
    meta = open(os.path.join(out, "training_metadata.txt")).read()
    assert "Step: 7" in meta and "Epoch: 2" in meta
    full = torch.load(os.path.join(out, "pl_bert_full_model.pt"), weights_only=True)
    assert full["phoneme_predictor.weight"].shape == (188, 96)
    assert "token_predictor.weight" not in full


def test_config_json_matches_jax(jax_export, port_export):
    """The port's config.json equals JAX's on every key of JAX's
    ``hf_albert_config``, as transformers reads both back."""
    from transformers import AlbertConfig as HFConfig

    _, jax_dir = jax_export
    _, port_dir, _ = port_export
    keys = jax_to_hf.hf_albert_config(SMALL["model_params"]).to_dict()
    ours, theirs = HFConfig.from_pretrained(port_dir).to_dict(), HFConfig.from_pretrained(
        jax_dir).to_dict()
    for k in keys:
        if k != "_name_or_path":
            assert ours[k] == theirs[k], k
    raw = [json.load(open(os.path.join(d, "config.json"))) for d in (port_dir, jax_dir)]
    raw[1].pop("transformers_version")
    assert raw[0] == raw[1]


def test_multitask_export_carries_token_head(tmp_path):
    """A multi-task model's bare state dict: the heads reach
    ``pl_bert_full_model.pt``, the step comes from the file name."""
    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.models.albert import build_model as port_build_model

    raw = {"model_params": dict(SMALL["model_params"], num_token_vocab=57),
           "dataset_params": SMALL["dataset_params"]}
    cfg = str(tmp_path / "mt.yml")
    Config.from_dict(raw).save(cfg)
    model = port_build_model(Config.from_dict(raw).model_params, "fp32")
    pth = str(tmp_path / "step_9.pth")
    torch.save(model.state_dict(), pth)
    out = cli.main(["--checkpoint_path", pth, "--config_path", cfg,
                    "--output_dir", str(tmp_path / "mt")])
    full = torch.load(os.path.join(out, "pl_bert_full_model.pt"), weights_only=True)
    assert full["token_predictor.weight"].shape == (57, 96)
    assert full["token_predictor.bias"].shape == (57,)
    assert full["phoneme_predictor.weight"].shape == (188, 96)
    assert torch.equal(full["encoder.pooler.weight"], model.encoder.pooler.weight)
    assert "Step: 9" in open(os.path.join(out, "training_metadata.txt")).read()
    wide = dict(raw, model_params=dict(raw["model_params"], hidden_size=128))
    with pytest.raises(RuntimeError, match="size mismatch"):
        to_hf.export_checkpoint(model.state_dict(), wide, str(tmp_path / "bad"))
    assert not os.path.exists(tmp_path / "bad")


def test_server_on_hf_dir_int8_answers_as_direct_calls(port_export, tmp_path):
    """``--hf_dir DIR --int8 --device cpu``: each answer equals a direct
    int8 call; ``/reload`` to a sibling export changes the answers to a
    direct call's on the new weights; ``--config_path`` is refused."""
    from pl_bert_tpu_torch.serving.client import ServingClient
    from pl_bert_tpu_torch.serving.server import build_server, serve_in_thread

    params, out, cfg = port_export
    second = os.path.join(os.path.dirname(out), "second")
    sd = {f"encoder.{k}": v + 0.01 for k, v in to_hf.load_pl_bert_model(out)[0].items()}
    to_hf.export_checkpoint(sd, SMALL, second)
    server = build_server(["--hf_dir", out, "--int8", "--device", "cpu", "--port", "0",
                           "--max_batch", "4", "--buckets", "16"])
    serve_in_thread(server)
    client = ServingClient(f"127.0.0.1:{server.server_address[1]}")
    kw = dict(quantize="int8", batch_size=4, seq_buckets=(16,), device="cpu")
    try:
        for src in (out, second):
            if src == second:
                assert client.reload(second)["ok"]
            direct = PhonemeEncoder.from_hf_export(src, **kw)
            assert direct.weights["encoder"]["mapping"]["wq"].dtype == torch.int8
            for text in TEXTS[:2]:
                hidden, n = client.encode(text, encoding="b64")
                ref, lengths = direct([text])
                assert n == lengths[0]
                np.testing.assert_array_equal(hidden, ref[0, :n])
        assert not np.array_equal(hidden, PhonemeEncoder.from_hf_export(out, **kw)([TEXTS[1]])[0][0, :n])
    finally:
        client.close()
        server.shutdown()
        server.batcher.close()
        server.server_close()
    with pytest.raises(SystemExit):
        build_server(["--hf_dir", out, "--config_path", cfg, "--device", "cpu"])


def test_inference_cli_on_hf_dir_int8(port_export, tmp_path):
    from pl_bert_tpu_torch.models import inference

    _, out, _ = port_export
    src = tmp_path / "in.txt"
    src.write_text("\n".join(TEXTS) + "\n")
    npz = tmp_path / "h.npz"
    inference.main(["--hf_dir", out, "--int8", "--input", str(src), "--output", str(npz),
                    "--batch_size", "4", "--device", "cpu"])
    got = np.load(npz)
    ref, lengths = PhonemeEncoder.from_hf_export(out, quantize="int8", batch_size=4,
                                                 device="cpu")(TEXTS)
    np.testing.assert_array_equal(got["lengths"], lengths)
    np.testing.assert_array_equal(got["hidden"], ref)

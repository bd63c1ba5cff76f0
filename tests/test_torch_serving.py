"""PyTorch serving path: PhonemeEncoder against the JAX one, weight
swaps, the HTTP round trip, the CLIs, and the port's independence from
jax."""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pl_bert_tpu.config import ModelParams
from pl_bert_tpu.models.albert import build_model, init_params
from pl_bert_tpu.models.inference import PhonemeEncoder as JaxEncoder
from pl_bert_tpu.serving.client import ServingClient
from pl_bert_tpu.serving.server import make_server, serve_in_thread
from pl_bert_tpu_torch.export.bridge import state_dict_from_jax
from pl_bert_tpu_torch.models.inference import PhonemeEncoder

REPO = Path(__file__).resolve().parent.parent
MP = ModelParams(
    hidden_size=256, num_attention_heads=4, intermediate_size=512,
    max_position_embeddings=128, num_hidden_layers=2, embedding_size=64,
    dropout=0.0, attention_impl="xla",
)
MAX_LEN = 128
TEXTS = ["qalam", "bajt ʃams", "ˈmaʕna θaːbit", "ab", "ʃ" * 70, "qalam bajt"]


@pytest.fixture(scope="module")
def params():
    return init_params(build_model(MP, "fp32"), MAX_LEN, seed=11)["encoder"]


def _port(params, **kw):
    kw.setdefault("batch_size", 4)
    return PhonemeEncoder(
        state_dict_from_jax(params), MP, MAX_LEN, mixed_precision="fp32",
        device="cpu", **kw,
    )


@pytest.mark.parametrize("buckets", [None, (16, 64)])
def test_encoder_matches_jax_encoder(params, buckets):
    jax_enc = JaxEncoder(
        params, MP, MAX_LEN, mixed_precision="fp32", batch_size=4,
        seq_buckets=buckets,
    )
    enc = _port(params, seq_buckets=buckets)
    for chunk in (TEXTS[:4], TEXTS[4:]):
        ref, ref_len = jax_enc(chunk)
        out, lengths = enc(chunk)
        np.testing.assert_array_equal(lengths, ref_len)
        assert out.shape == ref.shape and out.dtype == np.float32
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(out[i, :n], ref[i, :n], atol=5e-4, rtol=1e-3)


def test_valid_prefix_independent_of_batch(params):
    enc = _port(params, seq_buckets=(16, 64))
    alone, _ = enc(["qalam"])
    batched, _ = enc(["qalam", "bajt ʃams", "ab"])
    np.testing.assert_allclose(alone[0, :5], batched[0, :5], atol=1e-5)


def test_swap_params_rebinds_and_validates(params):
    enc = _port(params)
    before, _ = enc(["qalam"])
    old = enc.weights
    sd = {k: v.clone() for k, v in state_dict_from_jax(params).items()}
    sd["pooler.bias"] = sd["pooler.bias"] + 1.0
    sd["embeddings.LayerNorm.bias"] = sd["embeddings.LayerNorm.bias"] + 0.5
    enc.swap_params(sd)
    assert enc.weights is not old  # rebound, not written in place
    after, _ = enc(["qalam"])
    assert not np.allclose(before, after)

    bad = dict(sd)
    bad["pooler.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="pooler.weight"):
        enc.swap_params(bad)
    bad = dict(sd)
    del bad["pooler.bias"]
    with pytest.raises(ValueError, match="missing"):
        enc.swap_params(bad)
    bad = dict(sd)
    bad["pooler.bias"] = bad["pooler.bias"].double()
    with pytest.raises(ValueError, match="reloads must keep"):
        enc.swap_params(bad)


def test_swap_during_forwards_never_mixes_weights(params):
    """Forwards racing a stream of swaps each run wholly on one weight
    set: every result equals the old set's or the new set's."""
    enc = _port(params)
    sd_a = state_dict_from_jax(params)
    sd_b = {k: v + 0.01 for k, v in sd_a.items()}
    ref_a = enc(["qalam"])[0]
    enc.swap_params(sd_b)
    ref_b = enc(["qalam"])[0]
    assert not np.allclose(ref_a, ref_b, atol=1e-3)
    stop = threading.Event()
    torn: list[np.ndarray] = []
    done = [0]

    def reader():
        while not stop.is_set():
            h = enc(["qalam"])[0]
            if not (np.allclose(h, ref_a, atol=1e-5) or np.allclose(h, ref_b, atol=1e-5)):
                torn.append(h)
            done[0] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    readers = [threading.Thread(target=reader) for _ in range(10)]
    try:
        for t in readers:
            t.start()
        for i in range(10):
            enc.swap_params(sd_a if i % 2 == 0 else sd_b)
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers)
    assert done[0] > 0 and not torn


def test_http_round_trip_matches_direct(params):
    enc = _port(params, seq_buckets=(16, 64))
    server = make_server(enc, max_wait_ms=20.0, pipeline_depth=2)
    serve_in_thread(server)
    try:
        client = ServingClient(f"127.0.0.1:{server.server_address[1]}")
        results: dict[int, tuple] = {}

        def worker(i):
            results[i] = client.encode(TEXTS[i], encoding="b64")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(TEXTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i, text in enumerate(TEXTS):
            hidden, n = results[i]
            direct, lengths = enc([text])
            assert n == lengths[0]
            np.testing.assert_allclose(hidden, direct[0, :n], atol=1e-5)
    finally:
        server.shutdown()
        server.batcher.close()


def test_two_dispatches_before_the_first_fetch(params):
    """pipeline_depth 2's order: batch N dispatched, then N+1, then N
    fetched, then N+1; each answer equals a direct encoder call."""
    enc = _port(params, seq_buckets=(16, 64))
    chunks = (TEXTS[:3], TEXTS[3:])
    handles = [enc.dispatch(chunk) for chunk in chunks]
    for chunk, handle in zip(chunks, handles):
        hidden, lengths = enc.fetch(handle)
        direct, direct_lengths = enc(chunk)
        np.testing.assert_array_equal(lengths, direct_lengths)
        np.testing.assert_array_equal(hidden, direct)


def test_port_batcher_at_depth_two_matches_direct(params):
    """The port's batcher with two batches in flight (max_batch 2, so six
    requests make three batches): every answer equals a direct call."""
    from pl_bert_tpu_torch.serving.batcher import DynamicBatcher

    enc = _port(params, seq_buckets=(16, 64))
    batcher = DynamicBatcher(enc, max_batch=2, max_wait_ms=5.0, seq_buckets=(16, 64),
                             pipeline_depth=2)
    try:
        futures = [batcher.submit(t) for t in TEXTS]
        for text, fut in zip(TEXTS, futures):
            hidden, n = fut.result(timeout=60)
            direct, lengths = enc([text])
            assert n == lengths[0]
            np.testing.assert_allclose(hidden, direct[0, :n], atol=1e-5)
    finally:
        batcher.close()


def test_replica_pool_over_port_encoders(params):
    """The --replicas building blocks: one clone per device behind the
    JAX package's ReplicaPool, answers equal to the template's, and a
    pool-wide swap reaching every replica."""
    from pl_bert_tpu.serving.pool import ReplicaPool

    enc = _port(params, seq_buckets=(16, 64))
    pool = ReplicaPool.from_encoder(enc, ["cpu", "cpu"], max_wait_ms=5.0)
    try:
        futures = [pool.submit(t) for t in TEXTS]
        for text, fut in zip(TEXTS, futures):
            hidden, n = fut.result(timeout=60)
            np.testing.assert_allclose(hidden, enc([text])[0][0, :n], atol=1e-5)
        sd = {k: v + 0.01 for k, v in state_dict_from_jax(params).items()}
        pool.swap_params(sd)
        enc.swap_params(sd)
        for replica in pool.encoders:
            np.testing.assert_allclose(replica(["qalam"])[0], enc(["qalam"])[0], atol=1e-6)
    finally:
        pool.close()


def test_clone_to_copies_the_weight_set(params):
    enc = _port(params)
    clone = enc.clone_to("cpu")
    assert clone.weights is not enc.weights
    np.testing.assert_array_equal(clone(["qalam"])[0], enc(["qalam"])[0])


def test_cuda_default_raises_without_gpu(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PhonemeEncoder(state_dict_from_jax(params), MP, MAX_LEN)


def test_int8_not_yet_ported(params):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _port(params, quantize="int8")


def test_npz_cli_on_cpu(params, tmp_path):
    from pl_bert_tpu_torch.models import inference

    ckpt = tmp_path / "enc.pth"
    torch.save({"net": {f"encoder.{k}": v for k, v in
                        state_dict_from_jax(params).items()}, "step": 1}, ckpt)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "model_params:\n" + "".join(
            f"  {k}: {getattr(MP, k)}\n" for k in (
                "hidden_size", "num_attention_heads", "intermediate_size",
                "max_position_embeddings", "num_hidden_layers", "embedding_size",
            )
        ) + f"dataset_params:\n  max_seq_length: {MAX_LEN}\n"
    )
    src = tmp_path / "in.txt"
    src.write_text("\n".join(TEXTS[:3]) + "\n")
    out = tmp_path / "h.npz"
    inference.main([
        "--checkpoint", str(ckpt), "--config_path", str(cfg), "--input", str(src),
        "--output", str(out), "--batch_size", "2", "--buckets", "16",
        "--device", "cpu",
    ])
    got = np.load(out)
    ref, lengths = PhonemeEncoder(  # the CLI computes in bf16
        state_dict_from_jax(params), MP, MAX_LEN, device="cpu"
    )(TEXTS[:3])
    np.testing.assert_array_equal(got["lengths"], lengths)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got["hidden"][i, :n], ref[i, :n], atol=2e-2)


def test_port_imports_no_jax():
    """Every module of the port imports without jax or flax (the Triton
    kernel source needs triton and loads only when a kernel launches)."""
    pkg = REPO / "pl_bert_tpu_torch"
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
        if p.name != "_ln_triton.py" and "_build" not in p.parts
    )
    assert "pl_bert_tpu_torch.serving.server" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)

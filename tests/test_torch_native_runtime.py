"""The port's native packer (``runtime/native/packer.cc``, built with the
host compiler) against its numpy route and against the JAX package's
``pack_batch_native``: the same arrays bit for bit, the same refusals; a
build that fails warns once and packs on the numpy route, and the route
counters show which one packed."""

import numpy as np
import pytest

from pl_bert_tpu.runtime import pack_batch_native as jax_pack
from pl_bert_tpu_torch import runtime
from pl_bert_tpu_torch.data.packed import PackedSequenceDataset
from pl_bert_tpu_torch.ops.ondevice_masking import pack_sample
from pl_bert_tpu_torch.runtime import build
from pl_bert_tpu_torch.text.symbols import UNKNOWN_ID, encode


def _samples(n=8, words=40, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("ɑɐɒæbtkmnlsʃθð")
    return [["".join(rng.choice(alphabet, size=int(rng.integers(2, 9))))
             for _ in range(words)] for _ in range(n)]


def _numpy_route(samples, max_len, offsets=None):
    out = [pack_sample(s, max_len, offset=0 if offsets is None else int(offsets[i]))
           for i, s in enumerate(samples)]
    return tuple(np.stack([o[j] for o in out]).astype(np.int32) for j in range(3))


CASES = {
    "words": (_samples(), 128, None),
    "crop offsets": (_samples(seed=1), 64, np.array([0, 1, 5, 17, 40, 63, 100, 2], np.int32)),
    "out of vocabulary": ([["عxyz漢", "ab"], ["ab", "عx"]], 4, None),
    "empty sample": ([[], ["ab"]], 8, None),
    "tuples of words": ([("ab", "cd"), ("e",)], 6, None),
}


def test_native_builds_here():
    assert runtime.native_available()
    assert build.host_library_path().is_file()


@pytest.mark.parametrize("case", list(CASES))
def test_native_equals_numpy_route_and_jax(case):
    samples, max_len, offsets = CASES[case]
    before = runtime.NATIVE_PACKS.count
    got = runtime.pack_batch_native(samples, max_len, offsets)
    assert runtime.NATIVE_PACKS.count == before + 1
    for want in (_numpy_route(samples, max_len, offsets), jax_pack(samples, max_len, offsets)):
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    if case == "out of vocabulary":
        assert got[2][0] == 4 and got[0][0][0] == UNKNOWN_ID
        np.testing.assert_array_equal(got[0][0], encode("عxyz"))
    if case == "empty sample":
        assert got[2][0] == 0 and (got[0][0] == 0).all() and (got[1][0] == -1).all()


@pytest.mark.parametrize("bad", [[[42]], [["ab", None]], [7]])
def test_native_refuses_bad_types_as_jax_does(bad):
    with pytest.raises(TypeError):
        runtime.pack_batch_native(bad, 8)
    with pytest.raises(TypeError):
        jax_pack(bad, 8)


def test_a_failed_build_warns_once_and_packs_on_the_numpy_route(monkeypatch, tmp_path):
    """JAX's loader swallows a failed build; the port's warns with the
    compiler's error, once, and the numpy route packs the same arrays."""
    samples, max_len, offsets = CASES["crop offsets"]
    want = runtime.pack_batch_native(samples, max_len, offsets)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(runtime, "_native", None)
    monkeypatch.setattr(runtime, "_initialised", False)
    native, numpy_route = runtime.NATIVE_PACKS.count, runtime.NUMPY_PACKS.count
    with pytest.warns(RuntimeWarning, match="numpy route: .*no-such-compiler"):
        got = runtime.pack_batch_native(samples, max_len, offsets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the second call does not warn again
        PackedSequenceDataset([{"phonemes": s} for s in samples], max_len)
    assert not runtime.native_available()
    assert runtime.NATIVE_PACKS.count == native
    assert runtime.NUMPY_PACKS.count == numpy_route + 2

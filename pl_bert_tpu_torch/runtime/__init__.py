"""Host runtime: the native batch packer, and the build of the kernels
and of the packer (``build.py``).

A copy of ``pl_bert_tpu/runtime/__init__.py`` (:31-104):
``pack_batch_native(samples, max_len)`` packs a whole batch of per-word
phoneme strings into (label_ids, word_ids, lengths) int32 arrays in one
C pass (``runtime/native/packer.cc``, built with the host compiler at
first use, :func:`build.build_host`). Without the extension the numpy
route (``ops/ondevice_masking.py::pack_sample``, the reference the
extension is tested against) packs the same arrays, slower.

One deliberate difference: where JAX's loader swallows a failed build,
this one warns once with the compiler's error before it packs on the
numpy route. Each route counts its calls (:data:`NATIVE_PACKS`,
:data:`NUMPY_PACKS`), so a run can show which one packed it.
"""

from __future__ import annotations

import importlib.util
import threading
import warnings

import numpy as np

from pl_bert_tpu_torch.runtime.build import BuildError, LaunchCounter, build_host
from pl_bert_tpu_torch.text.symbols import SEPARATOR_ID, UNKNOWN_ID, _LOOKUP

NATIVE_PACKS = LaunchCounter("pack_batch native")
NUMPY_PACKS = LaunchCounter("pack_batch numpy")

_native = None
_initialised = False
_load_lock = threading.Lock()


def _load_native():
    """The extension module, built and loaded at the first call of the
    process, or None (after one warning) when it cannot be."""
    global _native, _initialised
    with _load_lock:
        if _initialised:
            return _native
        _initialised = True
        try:
            path = build_host()
            spec = importlib.util.spec_from_file_location("_plbert_native", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.set_symbol_table(
                np.asarray(_LOOKUP, dtype=np.int32).tobytes(),
                int(UNKNOWN_ID),
                int(SEPARATOR_ID),
            )
        except (BuildError, ImportError, OSError) as exc:
            warnings.warn(
                f"the native packer is unavailable, packing on the numpy route: {exc}",
                RuntimeWarning, stacklevel=3,
            )
            return None
        _native = mod
        return _native


def native_available() -> bool:
    return _load_native() is not None


def pack_batch_native(
    samples: list[list[str]],
    max_len: int,
    offsets: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch of per-word phoneme strings → (label_ids [B, L], word_ids
    [B, L], lengths [B]). ``offsets`` ([B] int32, default zeros) crops
    each sample's window to start at that char-stream position (the
    per-epoch random crop). Uses the C++ packer when available."""
    b = len(samples)
    labels = np.zeros((b, max_len), np.int32)
    words = np.full((b, max_len), -1, np.int32)
    lengths = np.zeros(b, np.int32)
    if offsets is None:
        offsets = np.zeros(b, np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    native = _load_native()
    if native is not None:
        # the C side walks samples via the PySequence API — only coerce
        # non-sequences; re-copying every sample per call would re-add
        # Python-level O(total words) work to the hot loop this
        # extension exists to remove
        batch = [
            s if isinstance(s, (list, tuple)) else list(s) for s in samples
        ]
        native.pack_batch(
            batch, max_len,
            memoryview(labels).cast("B"),
            memoryview(words).cast("B"),
            memoryview(lengths).cast("B"),
            offsets.tobytes(),
        )
        NATIVE_PACKS.add()
        return labels, words, lengths
    from pl_bert_tpu_torch.ops.ondevice_masking import pack_sample

    for i, sample in enumerate(samples):
        labels[i], words[i], lengths[i] = pack_sample(
            sample, max_len, offset=int(offsets[i])
        )
    NUMPY_PACKS.add()
    return labels, words, lengths

"""Memory-mapped packed data shards: the scalable training data plane.

A copy of ``pl_bert_tpu/data/packed_store.py`` (``write_packed_store``
:185, ``_NpyFile`` :280, ``MemmapPackedDataset`` :405,
``MemmapPackedSequenceDataset`` :498, ``open_packed_store`` :522): the
same on-disk format (``FORMAT_VERSION`` 1, byte for byte), so a store
written by either package is read by the other to the same batches.

The reference keeps its corpus arrow/memory-mapped end to end
(reference: preprocess.py:364-371 ``save_to_disk``, lazily loaded at
train.py:245). This module is the TPU build's equivalent for the
*packed* layout the on-device masking path consumes: a ``pack``
preprocessing stage runs the native C++ packer ONCE over the corpus and
writes per-shard dense ``.npy`` arrays; training then memory-maps them,
so Trainer startup is O(metadata) and resident memory stays bounded by
the working set of recently touched batches — a 1.2M-article corpus
(the reference's configured scale, configs/config.yml:9-10) trains with
flat RSS instead of several in-RAM corpus copies.

On-disk layout (``packed_meta.json`` marks a store)::

    out_dir/
      packed_meta.json            # format, shapes, shard table, stats
      shard_00000/
        label_ids.npy   [n, L] int32   phoneme ids (epoch-0 head crop)
        word_ids.npy    [n, L] int32   word index per position, -1 = sep/pad
        lengths.npy     [n]    int32
        token_ids.npy   [n, L] int32   (multi-task stores only)
        # kind="rows" stores also carry the FULL char streams of samples
        # longer than L, so per-epoch random re-cropping (reference
        # semantics: dataloader.py:110-126) is a pure window slice with
        # no re-packing at train time:
        long_rows.npy     [k]   int64  shard-local row index
        long_offsets.npy  [k+1] int64  stream boundaries
        long_labels.npy   [sum] int32
        long_words.npy    [sum] int32  global word ids (-1 at separators)
        long_tokens.npy   [sum] int32  (multi-task stores only)
      shard_00001/ ...

Two kinds:

- ``rows``: one sample per row (reader: :class:`MemmapPackedDataset`,
  bit-compatible with ``data.packed.PackedPhonemeDataset`` including the
  Philox re-crop stream — asserted by tests/test_torch_packed_store.py);
- ``packed_rows``: sequence-packed rows with segment/position ids
  (reader: :class:`MemmapPackedSequenceDataset`; FFD binning runs per
  write-chunk instead of globally — occupancy is within noise of the
  global FFD for chunks ≥ tens of thousands of samples).

Readers fetch rows with ``os.pread`` instead of mmapping the shards
(see :class:`_NpyFile` for the measured why), so hot data lives in the
kernel page cache while process RSS stays bounded by the batch arrays
regardless of corpus size (verified by the RSS-bound test).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Iterable, Iterator

import numpy as np

from pl_bert_tpu_torch.data.packed import (
    PackedSequenceDataset,
    _PackedBase,
    full_lengths,
    pack_token_batch,
)

META_NAME = "packed_meta.json"
FORMAT_VERSION = 1
_ROW_FIELDS = ("label_ids", "word_ids", "lengths")
_SEQ_FIELDS = _ROW_FIELDS + ("segment_ids", "position_ids")


def is_packed_store(path: str) -> bool:
    return os.path.isfile(os.path.join(path, META_NAME))


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}"


def _chunks(records: Iterable[dict], size: int) -> Iterator[list[dict]]:
    chunk: list[dict] = []
    for r in records:
        chunk.append(r)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def _write_rows_shard(
    shard_dir: str, chunk: list[dict], L: int, token_separator: int,
    has_tokens: bool,
) -> dict:
    from pl_bert_tpu_torch.runtime import pack_batch_native

    samples = [r["phonemes"] for r in chunk]
    labels, words, lengths = pack_batch_native(samples, L)
    full_lens = full_lengths(samples)
    long_local = np.flatnonzero(full_lens > L)

    os.makedirs(shard_dir)
    np.save(os.path.join(shard_dir, "label_ids.npy"), labels)
    np.save(os.path.join(shard_dir, "word_ids.npy"), words)
    np.save(os.path.join(shard_dir, "lengths.npy"), lengths)

    max_token_id = -1
    token_lists = None
    if has_tokens:
        token_lists = [r["token_ids"] for r in chunk]
        for tids in token_lists:
            if tids:
                max_token_id = max(max_token_id, max(tids))
        np.save(
            os.path.join(shard_dir, "token_ids.npy"),
            pack_token_batch(samples, token_lists, L, token_separator),
        )

    # full char streams of the long samples (per-epoch re-crop source)
    long_lens = full_lens[long_local]
    offsets = np.zeros(len(long_local) + 1, np.int64)
    np.cumsum(long_lens, out=offsets[1:])
    long_labels = np.zeros(int(offsets[-1]), np.int32)
    long_words = np.zeros(int(offsets[-1]), np.int32)
    long_tokens = np.zeros(int(offsets[-1]) if has_tokens else 0, np.int32)
    if len(long_local):
        maxfull = int(long_lens.max())
        long_samples = [samples[i] for i in long_local]
        ll, lw, _ = pack_batch_native(long_samples, maxfull)
        if has_tokens:
            lt = pack_token_batch(
                long_samples,
                [token_lists[i] for i in long_local],
                maxfull,
                token_separator,
            )
        for j, n in enumerate(long_lens):
            sl = slice(int(offsets[j]), int(offsets[j + 1]))
            long_labels[sl] = ll[j, :n]
            long_words[sl] = lw[j, :n]
            if has_tokens:
                long_tokens[sl] = lt[j, :n]
    np.save(os.path.join(shard_dir, "long_rows.npy"),
            long_local.astype(np.int64))
    np.save(os.path.join(shard_dir, "long_offsets.npy"), offsets)
    np.save(os.path.join(shard_dir, "long_labels.npy"), long_labels)
    np.save(os.path.join(shard_dir, "long_words.npy"), long_words)
    if has_tokens:
        np.save(os.path.join(shard_dir, "long_tokens.npy"), long_tokens)

    return {
        "rows": len(chunk),
        "samples": len(chunk),
        "long_rows": int(len(long_local)),
        "tokens": int(lengths.sum()),
        "max_token_id": int(max_token_id),
    }


def _write_packed_rows_shard(
    shard_dir: str, chunk: list[dict], L: int, token_separator: int,
    has_tokens: bool,
) -> dict:
    # reuse the in-RAM FFD packer per chunk — identical row layout,
    # binning scope is the chunk instead of the whole corpus
    ds = PackedSequenceDataset(chunk, L, token_separator=token_separator)
    os.makedirs(shard_dir)
    for f in _SEQ_FIELDS:
        np.save(os.path.join(shard_dir, f + ".npy"), getattr(ds, f))
    max_token_id = -1
    if has_tokens:
        np.save(os.path.join(shard_dir, "token_ids.npy"), ds.token_ids)
        for r in chunk:
            if r["token_ids"]:
                max_token_id = max(max_token_id, max(r["token_ids"]))
    return {
        "rows": len(ds),
        "samples": len(chunk),
        "long_rows": 0,
        "tokens": int(ds.lengths.sum()),
        "max_token_id": int(max_token_id),
    }


def write_packed_store(
    records: Iterable[dict],
    out_dir: str,
    max_seq_length: int = 512,
    token_separator: int = 87,
    sequence_packing: bool = False,
    shard_rows: int = 65536,
) -> str:
    """Stream ``records`` (dicts with ``phonemes`` and optionally
    ``token_ids``) into a packed store at ``out_dir``. The whole write
    goes to ``out_dir + '.tmp'`` and renames at the end, so a killed
    writer never leaves a half-store behind."""
    tmp = out_dir.rstrip("/") + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    it = iter(records)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("cannot pack an empty dataset") from None
    has_tokens = "token_ids" in first

    import itertools

    shards = []
    totals = {"rows": 0, "samples": 0, "long_rows": 0, "tokens": 0}
    max_token_id = -1
    write = _write_packed_rows_shard if sequence_packing else _write_rows_shard
    seen = 0
    for i, chunk in enumerate(
        _chunks(itertools.chain([first], it), shard_rows)
    ):
        for j, r in enumerate(chunk):
            if has_tokens != ("token_ids" in r):
                raise ValueError(
                    "inconsistent dataset: some records have 'token_ids' "
                    "and some do not"
                )
            if has_tokens and len(r["token_ids"]) != len(r["phonemes"]):
                # fail HERE with the record index, not as an opaque numpy
                # broadcast error deep inside a shard write (the host
                # training path validates the same invariant per row,
                # train.py; reference expects alignment at dataloader.py:40)
                raise ValueError(
                    f"record {seen + j}: token_ids has "
                    f"{len(r['token_ids'])} entries for "
                    f"{len(r['phonemes'])} phoneme words — run the "
                    "tokenize stage to (re)build aligned token_ids"
                )
        seen += len(chunk)
        name = _shard_name(i)
        stats = write(
            os.path.join(tmp, name), chunk, max_seq_length,
            token_separator, has_tokens,
        )
        max_token_id = max(max_token_id, stats.pop("max_token_id"))
        for k in totals:
            totals[k] += stats[k]
        shards.append({"dir": name, **stats})

    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "packed_rows" if sequence_packing else "rows",
        "max_seq_length": max_seq_length,
        "token_separator": token_separator,
        "has_tokens": has_tokens,
        "max_token_id": max_token_id if has_tokens else None,
        "num_rows": totals["rows"],
        "num_samples": totals["samples"],
        "num_long_rows": totals["long_rows"],
        "total_tokens": totals["tokens"],
        "shards": shards,
    }
    with open(os.path.join(tmp, META_NAME), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    # install the new store with the previous one intact until the very
    # last rename: rmtree-then-rename would leave NO store at the
    # configured path if the writer dies in between (and silently no-op
    # on a non-directory, making the rename fail confusingly)
    old = None
    if os.path.lexists(out_dir):
        old = out_dir + ".replaced"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.lexists(old):
            os.remove(old)
        os.rename(out_dir, old)
    os.rename(tmp, out_dir)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
        if os.path.lexists(old):
            os.remove(old)
    return out_dir


class _NpyFile:
    """Random row access into a ``.npy`` file via ``os.pread``.

    Deliberately NOT ``np.load(mmap_mode='r')``: measured on this
    kernel, both numpy advanced indexing (materializes the whole array)
    and per-row faults (fault-around maps ~64KB per fault, immune to
    MADV_RANDOM) drive a mapped shard fully resident within a few
    shuffled batches. ``pread`` keeps hot data in the KERNEL page cache
    — re-reads stay memory-speed — while the process RSS holds only the
    destination batch arrays, so training memory is flat at any corpus
    size."""

    def __init__(self, path: str) -> None:
        self._f = open(path, "rb")
        version = np.lib.format.read_magic(self._f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(self._f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(self._f)
        if fortran:
            raise ValueError(f"{path}: fortran-order arrays unsupported")
        self.shape = shape
        self.dtype = dtype
        self._start = self._f.tell()
        self._fd = self._f.fileno()
        self._row_shape = shape[1:]
        self._row_nbytes = (
            int(np.prod(self._row_shape, dtype=np.int64)) * dtype.itemsize
            if len(shape) > 1 else dtype.itemsize
        )

    def row(self, i: int) -> np.ndarray:
        buf = os.pread(
            self._fd, self._row_nbytes, self._start + i * self._row_nbytes
        )
        return np.frombuffer(buf, self.dtype).reshape(self._row_shape)

    def range(self, lo: int, hi: int) -> np.ndarray:
        """Elements [lo, hi) of a 1-D array (the long char streams)."""
        item = self.dtype.itemsize
        buf = os.pread(self._fd, (hi - lo) * item, self._start + lo * item)
        return np.frombuffer(buf, self.dtype)

    def close(self) -> None:
        self._f.close()


class _MemmapStoreBase(_PackedBase):
    """Shared store plumbing: lazy per-shard file handles (LRU-capped),
    pread row gathers."""

    _fields: tuple[str, ...]

    def __init__(self, path: str, max_open_shards: int = 128) -> None:
        import collections

        self.path = path
        with open(os.path.join(path, META_NAME), encoding="utf-8") as f:
            self.meta = json.load(f)
        if self.meta["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"packed store format {self.meta['format_version']} != "
                f"supported {FORMAT_VERSION}"
            )
        self.max_seq_length = int(self.meta["max_seq_length"])
        self.token_separator = int(self.meta["token_separator"])
        self.has_tokens = bool(self.meta["has_tokens"])
        self._rows = np.array(
            [s["rows"] for s in self.meta["shards"]], np.int64
        )
        self._base = np.zeros(len(self._rows) + 1, np.int64)
        np.cumsum(self._rows, out=self._base[1:])
        self.num_rows = int(self._base[-1])
        self._files: collections.OrderedDict[int, dict[str, _NpyFile]] = (
            collections.OrderedDict()
        )
        self._max_open_shards = max_open_shards
        fields = list(self._fields)
        if self.has_tokens:
            fields.append("token_ids")
        self._row_fields = tuple(fields)

    def __len__(self) -> int:
        return self.num_rows

    def _maps(self, s: int) -> dict[str, _NpyFile]:
        got = self._files.get(s)
        if got is None:
            d = os.path.join(self.path, self.meta["shards"][s]["dir"])
            got = {
                name: _NpyFile(os.path.join(d, name + ".npy"))
                for name in self._map_names()
                if os.path.exists(os.path.join(d, name + ".npy"))
            }
            self._files[s] = got
            while len(self._files) > self._max_open_shards:
                _, old = self._files.popitem(last=False)
                for f in old.values():
                    f.close()
        else:
            self._files.move_to_end(s)
        return got

    def _map_names(self) -> tuple[str, ...]:
        return self._row_fields

    def _gather_rows(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        shard_of = np.searchsorted(self._base[1:], idx, side="right")
        first = self._maps(int(shard_of[0]) if len(idx) else 0)
        out = {
            name: np.empty(
                (len(idx),) + tuple(first[name].shape[1:]), first[name].dtype
            )
            for name in self._row_fields
        }
        for j in range(len(idx)):
            s = int(shard_of[j])
            maps = self._maps(s)
            loc = int(idx[j] - self._base[s])
            for name in self._row_fields:
                out[name][j] = maps[name].row(loc)
        return out


class MemmapPackedDataset(_MemmapStoreBase):
    """Reader for ``kind="rows"`` stores — drop-in for
    ``PackedPhonemeDataset`` (same batches bit-for-bit, same Philox
    re-crop stream), but O(metadata) startup and bounded RSS.

    Per-epoch re-cropping of long samples (reference semantics:
    dataloader.py:110-126) slices the stored full char streams at
    Philox-drawn offsets and re-bases the window's word ids — no
    re-packing, no array mutation. Epoch-0 semantics match
    ``PackedPhonemeDataset`` exactly: before any training epoch it is
    the stored head-crop state, and a later epoch-0 request returns the
    LATEST epoch's crops (``_recrop`` leaves the current offsets in
    place) — in practice only validation snapshots use epoch 0, taken
    at Trainer init before training epochs run."""

    _fields = _ROW_FIELDS

    def __init__(
        self, path: str, seed: int = 1, max_open_shards: int = 128,
    ) -> None:
        super().__init__(path, max_open_shards)
        if self.meta["kind"] != "rows":
            raise ValueError(
                f"store at {path} is kind={self.meta['kind']!r}; use "
                "MemmapPackedSequenceDataset for packed_rows"
            )
        self.seed = seed
        # global long-sample index: shard order × ascending local row =
        # ascending global row, matching PackedPhonemeDataset._long_idx
        shard_ids, starts, fulls, rows = [], [], [], []
        for s, sh in enumerate(self.meta["shards"]):
            d = os.path.join(self.path, sh["dir"])
            lr = np.load(os.path.join(d, "long_rows.npy"))
            off = np.load(os.path.join(d, "long_offsets.npy"))
            shard_ids.append(np.full(len(lr), s, np.int32))
            starts.append(off[:-1])
            fulls.append(np.diff(off))
            rows.append(lr + self._base[s])
        self._long_shard = np.concatenate(shard_ids) if shard_ids else np.zeros(0, np.int32)
        self._long_start = np.concatenate(starts) if starts else np.zeros(0, np.int64)
        self._long_full_lens = np.concatenate(fulls) if fulls else np.zeros(0, np.int64)
        long_rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        self._row2long = np.full(self.num_rows, -1, np.int64)
        self._row2long[long_rows] = np.arange(len(long_rows))
        self._crop_epoch = 0
        self._offsets: np.ndarray | None = None  # head-crop state

    def _map_names(self) -> tuple[str, ...]:
        extra = ["long_labels", "long_words"]
        if self.has_tokens:
            extra.append("long_tokens")
        return self._row_fields + tuple(extra)

    def _recrop(self, epoch: int) -> None:
        # same guard + same Philox stream as PackedPhonemeDataset._recrop
        if epoch == self._crop_epoch or epoch == 0 or len(self._long_full_lens) == 0:
            return
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, 1, epoch])
        )
        self._offsets = rng.integers(
            0, self._long_full_lens - self.max_seq_length
        ).astype(np.int32)
        self._crop_epoch = epoch

    def batches(self, batch_size, epoch, seed=1, shuffle=True, drop_last=True,
                indices=None, start_batch=0):
        self._recrop(epoch)
        yield from super().batches(
            batch_size, epoch, seed, shuffle, drop_last, indices, start_batch
        )

    def batch(self, indices: np.ndarray) -> dict:
        out = self._gather_rows(indices)
        if self._offsets is not None:
            idx = np.asarray(indices, np.int64)
            L = self.max_seq_length
            lpos = self._row2long[idx]
            for j in np.flatnonzero(lpos >= 0):
                p = int(lpos[j])
                maps = self._maps(int(self._long_shard[p]))
                lo = int(self._long_start[p]) + int(self._offsets[p])
                out["label_ids"][j] = maps["long_labels"].range(lo, lo + L)
                w = maps["long_words"].range(lo, lo + L)
                visible = w >= 0
                if visible.any():  # re-base to the window's first word
                    w = np.where(visible, w - w[visible][0], -1)
                out["word_ids"][j] = w
                if self.has_tokens:
                    out["token_ids"][j] = maps["long_tokens"].range(lo, lo + L)
        return out


class MemmapPackedSequenceDataset(_MemmapStoreBase):
    """Reader for ``kind="packed_rows"`` stores — drop-in for
    ``PackedSequenceDataset`` over pre-binned on-disk rows."""

    _fields = _SEQ_FIELDS

    def __init__(self, path: str, max_open_shards: int = 128) -> None:
        super().__init__(path, max_open_shards)
        if self.meta["kind"] != "packed_rows":
            raise ValueError(
                f"store at {path} is kind={self.meta['kind']!r}; use "
                "MemmapPackedDataset for rows"
            )

    @property
    def packing_efficiency(self) -> float:
        return float(self.meta["total_tokens"]) / (
            self.num_rows * self.max_seq_length
        )

    def batch(self, indices: np.ndarray) -> dict:
        return self._gather_rows(indices)


def open_packed_store(path: str, seed: int = 1, max_open_shards: int = 128):
    """Open a packed store with the reader matching its kind."""
    with open(os.path.join(path, META_NAME), encoding="utf-8") as f:
        kind = json.load(f)["kind"]
    if kind == "rows":
        return MemmapPackedDataset(path, seed=seed, max_open_shards=max_open_shards)
    return MemmapPackedSequenceDataset(path, max_open_shards=max_open_shards)

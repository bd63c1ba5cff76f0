"""Training entry point.

The counterpart of ``pl_bert_tpu/training/train.py``: the end-to-end
pretraining entry point with the reference's runtime contract
(reference: train.py:133-172 and helpers):

- ``--config_path`` / ``--run_name`` CLI (reference: train.py:27-32),
  plus ``--device`` (``cuda``, the default, or ``cpu``: there is no
  silent fallback when the card is missing);
- run-dir semantics: existing dir + config copy → resume with the saved
  config; dir without config → stale step_* cleaned, fresh start
  (reference: train.py:174-210);
- warm-start from ``model_params.pretrained_model``, then auto-resume
  from the latest ``step_N.pth`` (reference: train.py:261-284);
- step-based loop capped by ``num_steps`` and ``max_epochs`` epochs,
  validation + checkpoint every ``save_interval`` (reference:
  train.py:338-379).

One process a card: the eager train step of ``train_step.py`` with
the hand-written kernels; the host pipeline (host masking, or packed
arrays for on-device masking) prefetched on a thread, which also starts
the host-to-device copy. ``num_token_vocab > 0`` trains the multi-task
model (the grapheme head, its token ids carried to the card and its
``val_token_*`` metrics). ``training_dataset`` is a ``synthetic:N``
spec, a memory-mapped packed store (``data/packed_store.py``, written by
``python -m pl_bert_tpu_torch.preprocess.pipeline --stage pack``), a
``records.jsonl`` directory, an HF ``save_to_disk`` directory or an HF
hub id (``datasets`` is imported only for the last two).
``remat: true`` recomputes each layer application in the backward;
``prng_impl`` is read and ignored.

Several processes (JAX's ``maybe_init_distributed``, :853-888): with
``PLBERT_DISTRIBUTED=1`` each process joins a ``torch.distributed``
world — at ``PLBERT_COORDINATOR`` (host:port, a TCP rendezvous) with
``PLBERT_NUM_PROCESSES`` and ``PLBERT_PROCESS_ID``, or without them from
the launcher's environment (``torchrun``'s ``env://``) — on ``nccl`` on
the card (each rank on ``cuda:<rank % cards>``) and ``gloo`` on the
CPU. ``training_params.data_axis``/``model_axis`` lay the ranks out as a
(data, model) mesh (``parallel/mesh.py``), with ``zero1`` and
``model_params.sequence_parallel`` honoured as JAX honours them. Every
rank builds the same global batch and steps its data slice; rank 0
alone prints, writes ``metrics.jsonl``, clears stale runs and writes
the checkpoints (gathered: the file a single device writes).

Run: ``python -m pl_bert_tpu_torch.training.train --config_path
configs/config.yml --run_name myrun [--device cpu]``; on two CPU
processes, e.g. ``PLBERT_DISTRIBUTED=1 PLBERT_COORDINATOR=localhost:29500
PLBERT_NUM_PROCESSES=2 PLBERT_PROCESS_ID=<0|1> python -m
pl_bert_tpu_torch.training.train ... --device cpu``, one per rank.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.data.packed_store import (
    MemmapPackedDataset,
    _MemmapStoreBase,
    is_packed_store,
    open_packed_store,
)
from pl_bert_tpu_torch.data.pipeline import Waits, build_dataloader, prefetch, to_device
from pl_bert_tpu_torch.models.albert import build_model, init_params
from pl_bert_tpu_torch.ops import masked_ce
from pl_bert_tpu_torch.preprocess.shard_engine import load_processed_dataset
from pl_bert_tpu_torch.parallel import collectives as col
from pl_bert_tpu_torch.parallel.mesh import local_rows, make_mesh, shard_model
from pl_bert_tpu_torch.training.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_path,
    find_latest_checkpoint,
    gather_state,
    load_checkpoint,
    load_params_only,
    save_checkpoint,
)
from pl_bert_tpu_torch.training.metrics import MetricsLogger, is_main_process
from pl_bert_tpu_torch.training.train_step import (
    TrainState,
    batch_to_arrays,
    check_ported,
    make_eval_step,
    make_optimizer,
    make_train_step,
)


def parse_args(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Pretrain phoneme-level BERT on a CUDA card")
    p.add_argument("--config_path", type=str, default="configs/config.yml")
    p.add_argument("--run_name", type=str, default="default")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; a missing card is an error, not a fallback")
    return vars(p.parse_args(argv))


def setup_config_and_directories(args: dict, config_path: str):
    """Resume-vs-fresh run directory handling (reference semantics):
    ``(config, log_dir, resuming)``. The config copy is written under a
    temporary name and renamed, so a crash never leaves half a config.
    Under several processes rank 0's view of the directory decides for
    every rank (JAX :88-94), rank 0 alone clears and copies, and the
    others wait for it."""
    original = Config.load(config_path)
    log_dir = os.path.join(original.training_params.output_dir, args["run_name"])
    config_copy = os.path.join(log_dir, os.path.basename(config_path))

    resuming = os.path.exists(log_dir) and os.path.exists(config_copy)
    if dist.is_initialized():
        flag = [resuming]
        dist.broadcast_object_list(flag, src=0)
        resuming = bool(flag[0])
    if not resuming and is_main_process():
        if os.path.exists(log_dir):
            # stale run without a config copy: clear EVERY artifact the
            # old run left (a surviving metrics.jsonl would append the
            # new run after the old one's records; a .crash_injected
            # marker would silently disarm fault injection)
            for name in os.listdir(log_dir):
                if name.startswith("step_") or name in (
                    "metrics.jsonl", ".crash_injected",
                ):
                    path = os.path.join(log_dir, name)
                    shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        os.makedirs(log_dir, exist_ok=True)
        tmp = config_copy + ".tmp"
        shutil.copy(config_path, tmp)
        os.replace(tmp, config_copy)
    if dist.is_initialized():
        dist.barrier()
    if resuming:
        return Config.load(config_copy), log_dir, True
    return original, log_dir, False


def make_synthetic_corpus(
    n_samples: int, seed: int = 0, token_vocab: int = 0,
    derivable: bool = False, pool_size: int | None = None,
    words_per_sample: tuple[int, int] = (40, 120),
) -> list[dict]:
    """Random phoneme-word corpus — a copy of
    ``pl_bert_tpu/training/train.py::make_synthetic_corpus`` (:120-193),
    the same records for the same arguments: a stand-in for wiki shards
    that needs no file (used by smoke runs and tests). ``token_vocab>0``
    also attaches per-word grapheme token_ids (the multi-task column).

    ``derivable=True`` draws words from a CLOSED pool and labels each
    with ``crc32(word) % token_vocab`` — a fixed phoneme→grapheme
    mapping a grapheme head can learn; word ORDER in derivable samples
    is cyclic over the pool (each sample is a contiguous run starting at
    a random offset), so context determines a masked word.
    ``pool_size`` / ``words_per_sample`` size the task to the model that
    must learn it."""
    rng = np.random.default_rng(seed)
    alphabet = list("ɑɐɒæbdfɡhijklmnopqrstuvwzʃʒθðŋɹɾʔˈˌː")
    make_word = lambda: "".join(  # noqa: E731
        rng.choice(alphabet, size=int(rng.integers(2, 10)))
    )
    pool = None
    if derivable:
        import zlib

        if token_vocab <= 0:
            raise ValueError(
                "synthetic-derivable requires a multi-task model "
                "(num_token_vocab > 0) — its whole point is learnable "
                "grapheme labels"
            )
        # lexicon scaled to the corpus: every word recurs often enough
        # for the head to memorize its mapping
        n_pool = (
            pool_size if pool_size else max(64, min(4096, n_samples))
        )
        pool = [make_word() for _ in range(n_pool)]
        tid = {w: zlib.crc32(w.encode()) % token_vocab for w in pool}
    corpus = []
    for _ in range(n_samples):
        n_words = int(rng.integers(*words_per_sample))
        if derivable:
            start = int(rng.integers(0, len(pool)))
            words = [
                pool[(start + j) % len(pool)] for j in range(n_words)
            ]
            record = {
                "phonemes": words,
                "token_ids": [tid[w] for w in words],
            }
        else:
            words = [make_word() for _ in range(n_words)]
            record = {"phonemes": words}
            if token_vocab > 0:
                record["token_ids"] = rng.integers(
                    5, token_vocab, size=n_words
                ).tolist()
        corpus.append(record)
    return corpus


def load_training_dataset(name: str, split: str, token_vocab: int = 0):
    """Resolve the configured dataset, as JAX's ``load_training_dataset``
    (``pl_bert_tpu/training/train.py:196-242``) does:
    ``synthetic[-derivable]:N[:POOL[:WMIN-WMAX]]`` (POOL sizes the closed
    lexicon, WMIN-WMAX the words per sample), a packed store (opened
    memory-mapped), a ``records.jsonl`` directory, a local
    ``save_to_disk`` directory (its ``split`` where it holds several) or
    an HF hub id (reference: train.py:242-259). For synthetic corpora,
    ``token_vocab`` (the model's num_token_vocab) adds the multi-task
    token_ids column."""
    if name.startswith("synthetic"):
        fields = name.split(":")
        n = int(fields[1]) if len(fields) > 1 else 2048
        derivable = fields[0] in (
            "synthetic-derivable", "synthetic_derivable"
        )
        kwargs: dict = {}
        if len(fields) > 2:
            kwargs["pool_size"] = int(fields[2])
        if len(fields) > 3:
            lo, hi = fields[3].split("-")
            kwargs["words_per_sample"] = (int(lo), int(hi))
        return make_synthetic_corpus(
            n, token_vocab=token_vocab, derivable=derivable, **kwargs
        )
    if os.path.isdir(name):
        if is_packed_store(name):  # output of the pack preprocessing stage
            return open_packed_store(name)
        if os.path.exists(os.path.join(name, "records.jsonl")):
            return load_processed_dataset(name)
        from datasets import load_from_disk

        ds = load_from_disk(name)
        if hasattr(ds, "keys") and split in getattr(ds, "keys", lambda: [])():
            ds = ds[split]
        return ds
    from datasets import load_dataset

    return load_dataset(name, split=split)


def _check_token_vocab(max_tid: int, num_token_vocab: int) -> None:
    if max_tid >= num_token_vocab:
        raise ValueError(
            f"dataset token_ids go up to {max_tid} but num_token_vocab is "
            f"{num_token_vocab} — set model_params.num_token_vocab to at "
            "least max(tokenizer vocab_size, word_separator + 1): separator "
            "positions carry the word_separator id as their grapheme label "
            "(reference: dataloader.py:67-68)"
        )


def _max_token_id(dataset) -> int:
    """The largest grapheme label in a corpus; a record without
    ``token_ids`` is refused. An arrow dataset is scanned by column (one
    pyarrow pass, as JAX's ``train.py:485-515``: a row-by-row read would
    decode every record just to take a max); anything else row by row."""
    missing = (
        "multi-task training needs 'token_ids' in every dataset row, but row {} has "
        "none — run the tokenize preprocessing stage (reference expects this column "
        "at dataloader.py:40)"
    )
    try:
        import pyarrow.compute as pc

        col = dataset.data.column("token_ids")
        lens = pc.list_value_length(col)
        empty = pc.index(lens, 0).as_py()
        if empty != -1 or lens.null_count:
            raise ValueError(missing.format(empty if empty != -1 else "with null"))
        return int(pc.max(pc.list_flatten(col)).as_py())
    except (ImportError, AttributeError, KeyError, TypeError):
        pass
    max_tid = -1
    for i in range(len(dataset)):
        ids = dataset[i].get("token_ids")
        if not ids:
            raise ValueError(missing.format(i))
        max_tid = max(max_tid, max(ids))
    return max_tid


def _adopt_packed_store(store, tp, dp):
    """Hold a memory-mapped packed store to this run's config (JAX
    ``train.py:256-290``): the store was packed with one kind, L and
    separator, and training against another config would silently change
    what it means; its per-epoch crop stream keys off the run's seed."""
    meta = store.meta
    want_kind = "packed_rows" if dp.sequence_packing else "rows"
    if meta["kind"] != want_kind:
        raise ValueError(
            f"packed store kind={meta['kind']!r} but the config asks for "
            f"{want_kind!r} (dataset_params.sequence_packing="
            f"{dp.sequence_packing}) — re-run the pack stage with the "
            "matching config"
        )
    if meta["max_seq_length"] != dp.max_seq_length:
        raise ValueError(
            f"packed store was packed at max_seq_length="
            f"{meta['max_seq_length']} but the config says "
            f"{dp.max_seq_length} — re-run the pack stage"
        )
    if meta["token_separator"] != dp.word_separator:
        raise ValueError(
            f"packed store token_separator={meta['token_separator']} != "
            f"dataset_params.word_separator={dp.word_separator} — re-run "
            "the pack stage"
        )
    if isinstance(store, MemmapPackedDataset):
        store.seed = tp.seed  # the per-epoch crop stream keys off it
    if is_main_process():
        print(
            f"memory-mapped packed store: {meta['num_rows']} rows in "
            f"{len(meta['shards'])} shards from {store.path}"
        )
    return store


# the masked positions a sample holds at word_pred_prob p and length L
# are about 0.75·p·L on average (58 at the defaults 0.15 and 512, with a
# spread of 18); the largest of 8192 samples' counts measured there was
# 135, 2.34 times the mean (pl_bert_tpu/config.py:163-175)
CAPACITY_WARN_FACTOR = 2.4


def real_tokens(batch) -> int:
    """The non-pad tokens of a host batch (a dict of arrays, stacked
    micro-batches too, or a ``Batch``), counted from its lengths."""
    lengths = batch["lengths"] if isinstance(batch, dict) else batch.lengths
    return int(np.asarray(lengths).sum())


def lm_head_capacity_warning(tp, dp) -> str | None:
    """The warning for an ``lm_head_capacity`` small enough that the
    exact full-length fallback fires often, or None. The rule: a gather
    capacity below 2.4 times the expected masked positions a sample
    (0.75·word_pred_prob·max_seq_length) — above the largest count
    measured in 8192 samples at the defaults, 135 — is warned of. At the
    defaults that is 138.2, so it catches 128, the one capacity measured
    slower (3.5% of batches of 96 fell back), and clears the default,
    144. JAX's rule (1.5·word_pred_prob·L, 115 at the defaults) misses
    128. 0 and capacities of at least L (no gather) are never warned of;
    nothing is refused."""
    capacity, L = tp.lm_head_capacity, dp.max_seq_length
    expected = 0.75 * dp.word_pred_prob * L
    if not 0 < capacity < L or capacity >= CAPACITY_WARN_FACTOR * expected:
        return None
    return (
        f"WARNING: lm_head_capacity ({capacity}) is below {CAPACITY_WARN_FACTOR}x the "
        f"expected masked tokens per sample (~{expected:.0f} at word_pred_prob "
        f"{dp.word_pred_prob}, seq {L}); the exact full-length fallback will fire often "
        "and slow the step — raise lm_head_capacity (or set 0 to disable the gather)."
    )


class Trainer:
    """Wires model, optimizer, data and checkpoints together on one device."""

    def __init__(
        self,
        config: Config,
        log_dir: str,
        resuming: bool,
        dataset=None,
        device: str = "cuda",
        eval_only: bool = False,
    ):
        """``eval_only``: the model, the data and the eval step, without
        the AdamW state (twice the parameters in fp32) and the train step
        that a scorer never touches (``training/evaluate.py``)."""
        if eval_only and resuming:
            raise ValueError("eval_only cannot resume a run (no opt state)")
        check_ported(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the trainer runs on the card unless asked for --device cpu"
            )
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.log_dir = log_dir
        self.resuming = resuming
        self.eval_only = eval_only
        tp, mp, dp = (
            config.training_params,
            config.model_params,
            config.dataset_params,
        )

        world = dist.get_world_size() if dist.is_initialized() else 1
        if tp.num_process != world and is_main_process():
            # a reference-compat key: the process count comes from the
            # launch, not the config (JAX :321-329)
            print(f"WARNING: training_params.num_process={tp.num_process} is ignored; "
                  f"the world has {world} processes (launch with PLBERT_DISTRIBUTED=1 to "
                  "change it)", flush=True)
        self.mesh = mesh = make_mesh(tp.data_axis, tp.model_axis)
        if tp.batch_size % mesh.data:
            raise ValueError(f"batch_size {tp.batch_size} must be divisible by the data axis "
                             f"size {mesh.data}")
        mesh = None if mesh.size == 1 else mesh
        # every rank builds the same full parameters, then keeps its shard
        self.model = init_params(build_model(mp, tp.mixed_precision, remat=tp.remat,
                                             mesh=mesh), seed=tp.seed)
        full_shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        if mesh is not None:
            shard_model(self.model, mesh)
        self.model.to(self.device)
        self.tx = make_optimizer(tp)
        self.use_token_ids = mp.num_token_vocab > 0
        if self.use_token_ids and mp.num_token_vocab <= dp.word_separator:
            # separator positions carry word_separator as their grapheme
            # label (reference: dataloader.py:67-68); a head smaller than
            # that id could not predict it
            raise ValueError(
                f"num_token_vocab ({mp.num_token_vocab}) must exceed "
                f"dataset_params.word_separator ({dp.word_separator}): "
                "separator positions use that id as their grapheme label "
                "(reference: dataloader.py:67-68)"
            )
        warning = self.use_token_ids and lm_head_capacity_warning(tp, dp)
        if warning:
            self._print(warning)

        if dataset is None:
            dataset = load_training_dataset(tp.training_dataset, tp.split,
                                            token_vocab=mp.num_token_vocab)
        is_store = isinstance(dataset, _MemmapStoreBase)
        self.ondevice_masking = dp.ondevice_masking
        self.masking_params = None
        if dp.sequence_packing and not dp.ondevice_masking:
            raise ValueError("sequence_packing requires ondevice_masking")
        if is_store and not dp.ondevice_masking:
            raise ValueError(
                "a packed store holds pre-encoded arrays, which only the "
                "on-device masking path consumes — set "
                "dataset_params.ondevice_masking: true (or point "
                "training_dataset at the un-packed jsonl dataset)"
            )
        if self.ondevice_masking:
            from pl_bert_tpu_torch.data.masking import MaskingParams
            from pl_bert_tpu_torch.data.packed import (
                PackedPhonemeDataset,
                PackedSequenceDataset,
            )
            from pl_bert_tpu_torch.data.pipeline import split_train_val

            self.masking_params = MaskingParams(
                word_pred_prob=dp.word_pred_prob,
                phoneme_mask_prob=dp.phoneme_mask_prob,
                replace_prob=dp.replace_prob,
                max_seq_length=dp.max_seq_length,
                word_separator=dp.word_separator,
            )
            if is_store:
                self.packed = _adopt_packed_store(dataset, tp, dp)
            else:
                packed_cls = (
                    PackedSequenceDataset if dp.sequence_packing
                    else PackedPhonemeDataset
                )
                # FFD packing is deterministic; crop RNG keys off the seed.
                # token_separator: the grapheme label id at separator
                # positions (reference: dataloader.py:67-68)
                kwargs = {"token_separator": dp.word_separator}
                if not dp.sequence_packing:
                    kwargs["seed"] = tp.seed
                self.packed = packed_cls(dataset, dp.max_seq_length, **kwargs)
            if self.use_token_ids:
                if not self.packed.has_tokens:
                    raise ValueError(
                        "multi-task training with ondevice_masking needs 'token_ids' in "
                        "every dataset row (per-word grapheme ids, reference: "
                        "dataloader.py:40)"
                    )
                # the store records the max over RAW ids; the separator id
                # written at separator positions is folded in, as the
                # in-RAM arrays' max already holds it
                max_tid = (
                    max(int(self.packed.meta["max_token_id"]), dp.word_separator)
                    if is_store else int(self.packed.token_ids.max())
                )
                _check_token_vocab(max_tid, mp.num_token_vocab)
            if dp.sequence_packing:
                n_samples = self.packed.meta["num_samples"] if is_store else len(dataset)
                self._print(
                    f"sequence packing: {n_samples} samples → "
                    f"{len(self.packed)} rows "
                    f"({self.packed.packing_efficiency:.0%} token occupancy)"
                )
            self.train_idx, self.val_idx = split_train_val(
                len(self.packed), seed=tp.seed
            )
            # snapshot validation rows NOW (epoch-0 head-crop state):
            # validation must not trigger re-cropping of the shared train
            # arrays mid-epoch, and the val set stays identical across
            # epochs and across resumed runs
            self._val_cache = [
                {k: v.copy() for k, v in b.items()}
                for b in self.packed.batches(
                    tp.batch_size, epoch=0, shuffle=False, drop_last=False,
                    indices=self.val_idx,
                )
            ]
            self.train_data = self.val_data = None
        else:
            self.train_data, self.val_data = build_dataloader(
                dataset,
                batch_size=tp.batch_size,
                dataset_config={
                    "word_pred_prob": dp.word_pred_prob,
                    "phoneme_mask_prob": dp.phoneme_mask_prob,
                    "replace_prob": dp.replace_prob,
                    "word_separator": dp.word_separator,
                    "max_seq_length": dp.max_seq_length,
                },
                use_token_ids=self.use_token_ids,
                seed=tp.seed,
            )
            if self.use_token_ids:
                _check_token_vocab(_max_token_id(dataset), mp.num_token_vocab)

        opt_state = None if eval_only else self.tx.init(self.model, mesh, tp.zero1, full_shapes)
        self.state = TrainState(self.model, opt_state, 0)
        self.start_epoch = 0
        self.start_batch = 0
        self.current_step = 0

        if mp.pretrained_model:
            self._print(f"Loading pretrained model from: {mp.pretrained_model}")
            load_params_only(mp.pretrained_model, self.model, mesh)

        found, latest = find_latest_checkpoint(log_dir)
        if found and resuming:
            path = checkpoint_path(log_dir, latest)
            meta = load_checkpoint(path, self.model, self.state.opt_state, mesh)
            self.state.step = meta["step"]
            self.current_step = meta["step"]
            self.start_epoch = meta["epoch"]
            self.start_batch = meta["batch_in_epoch"]
            self._print(f"Checkpoint {path} loaded.")

        self.train_step = None if eval_only else make_train_step(
            self.model, self.tx, grad_accum=tp.grad_accum_steps, seed=tp.seed,
            masking_params=self.masking_params, fused_lm_head=tp.fused_lm_head,
            lm_head_capacity=tp.lm_head_capacity,
        )
        self.eval_step = make_eval_step(self.model, masking_params=self.masking_params,
                                        lm_head_capacity=tp.lm_head_capacity)
        self.ckpt_writer = AsyncCheckpointWriter() if tp.async_save else None
        self.metrics = MetricsLogger(
            log_dir, tp.log_interval, tp.wandb_project, config.to_dict()
        )
        from pl_bert_tpu_torch.utils.profiler import maybe_profile

        self.profiler = maybe_profile()

    @staticmethod
    def _print(*args) -> None:
        if is_main_process():
            print(*args, flush=True)

    def _put(self, batch, axis: int = 0) -> dict:
        """This rank's data slice (``axis``: the batch axis) of the global
        batch's arrays, on the device (the grapheme ``token_ids`` only for
        the multi-task model); called inside the prefetch thread, so the
        copy overlaps the previous step."""
        arrays = batch if isinstance(batch, dict) else batch_to_arrays(batch)
        return to_device(
            {k: local_rows(v, self.mesh, axis) for k, v in arrays.items()
             if k != "token_ids" or self.use_token_ids},
            self.device,
        )

    @staticmethod
    def _group_micro(it, accum: int):
        """Group ``accum`` consecutive loader batches into one stacked
        [accum, B, ...] super-batch for the accumulation step; a ragged
        final group is padded with EMPTY micro-batches (all-zero rows,
        length 0), which contribute zero weight to the accumulated
        gradient. Yields (stacked_arrays, loader_batches_consumed)."""
        group: list[dict] = []

        def stacked():
            out = {}
            for k in group[0]:
                arrs = [np.asarray(g[k]) for g in group]
                arrs += [np.zeros_like(arrs[0])] * (accum - len(arrs))
                out[k] = np.stack(arrs)
            return out

        for b in it:
            group.append(b if isinstance(b, dict) else batch_to_arrays(b))
            if len(group) == accum:
                yield stacked(), accum
                group = []
        if group:
            yield stacked(), len(group)

    def _train_batches(self, epoch: int, start_batch: int = 0):
        if self.ondevice_masking:
            return self.packed.batches(
                self.config.training_params.batch_size, epoch,
                seed=self.config.training_params.seed,
                indices=self.train_idx, start_batch=start_batch,
            )
        return self.train_data.batches(epoch=epoch, start_batch=start_batch)

    def _val_batches(self):
        if self.ondevice_masking:
            return iter(self._val_cache)
        return self.val_data.batches(epoch=0)

    @staticmethod
    def _pad_batch(arrays: dict, bs: int) -> dict:
        """Zero-pad a ragged tail batch to the static batch size; dummy
        rows have length 0 and no masks, contributing nothing."""
        n = len(arrays["lengths"])
        if n == bs:
            return arrays
        pad = lambda a: np.concatenate(  # noqa: E731
            [a, np.zeros((bs - n, *a.shape[1:]), a.dtype)]
        )
        return {k: pad(v) for k, v in arrays.items()}

    def validate(self) -> tuple[float, float] | None:
        """→ (mean val phoneme loss, mean masked accuracy) or None on an
        empty split; also records the batch count in _last_val_batches.
        For the multi-task model the grapheme head's means land in
        ``last_val_extras`` ({val_token_loss, val_token_accuracy}).

        The mean is UNWEIGHTED over per-batch means — deliberately the
        reference's exact validation statistic (reference:
        train.py:288-304 appends loss.item() per batch and np.mean's),
        so a ragged final batch carries the same per-batch weight there
        and here. Padded rows contribute nothing to a batch's own mean
        (ops/masked_ce.py). One deliberate divergence: a batch in which
        masking selected ZERO positions (possible on tiny validation
        splits) is excluded from the mean — our masked CE returns a
        vacuous 0.0 for it (which would dilute the mean toward zero)
        and the reference's torch CE returns NaN (which poisons it)."""
        losses, accs = [], []
        t_losses, t_accs = [], []
        tp = self.config.training_params
        for i, batch in enumerate(self._val_batches()):
            arrays = batch if isinstance(batch, dict) else batch_to_arrays(batch)
            arrays = self._pad_batch(arrays, tp.batch_size)
            # a fixed masking seed per batch index: validation masking
            # patterns are independent across batches and the same
            # across runs
            out = self.eval_step(self._put(arrays), (tp.seed + 1) * 2**32 + i)
            loss, acc, n_masked = out[:3]
            if int(n_masked) == 0:
                continue
            losses.append(float(loss))
            accs.append(float(acc))
            if len(out) == 5:  # multi-task: the grapheme head's metrics too
                t_losses.append(float(out[3]))
                t_accs.append(float(out[4]))
        self._last_val_batches = len(losses)
        self.last_val_extras = (
            {"val_token_loss": float(np.mean(t_losses)),
             "val_token_accuracy": float(np.mean(t_accs))}
            if t_losses else None
        )
        if not losses:
            return None
        return float(np.mean(losses)), float(np.mean(accs))

    def _maybe_inject_fault(self) -> None:
        """Fault injection for elasticity testing: with
        PLBERT_CRASH_AT_STEP=N set, the process hard-exits (rc 17,
        simulating a preemption) the first time step N completes — once
        per run dir, so the relaunched process resumes past it."""
        crash_at = int(os.environ.get("PLBERT_CRASH_AT_STEP", "0") or 0)
        if not crash_at or self.current_step != crash_at:
            return
        marker = os.path.join(self.log_dir, ".crash_injected")
        fired = os.path.exists(marker)
        if dist.is_initialized():
            dist.barrier()  # every rank reads the marker before rank 0 writes it
        if fired:
            return
        if is_main_process():
            with open(marker, "w"):
                pass
        print(f"fault injection: dying at step {crash_at}", flush=True)
        os._exit(17)

    def train(self) -> int:
        """Run the loop; ALWAYS join the async checkpoint writer on the
        way out — an exception escaping the loop must not orphan an
        in-flight daemon write (the checkpoint would silently truncate
        at interpreter exit) or swallow a stored write error."""
        loop_error: BaseException | None = None
        try:
            return self._train_loop()
        except BaseException as e:
            # captured explicitly — sys.exc_info() in the finally would
            # also be truthy when train() is CALLED from an except block,
            # spuriously downgrading a failed write to a printed warning
            loop_error = e
            raise
        finally:
            # a profiler window still open (run ended/crashed inside it)
            # must stop — the trace is written only on stop
            self.profiler.close()
            if self.ckpt_writer is not None:
                try:
                    self.ckpt_writer.wait()
                except BaseException:
                    if loop_error is None:
                        raise
                    # don't mask the original exception; still surface it
                    import traceback

                    traceback.print_exc()

    def _train_loop(self) -> int:
        tp = self.config.training_params

        if self.current_step >= tp.num_steps:
            # already complete — never train past the configured budget on
            # relaunch (an elastic launcher restarts unconditionally)
            return self.current_step

        val = self.validate()
        if val is None:
            self._print(
                "Validation skipped: no usable validation batches "
                "(95/5 split smaller than a batch, or masking "
                "selected zero positions in every batch)",
            )
        else:
            self.metrics.log_validation(self.current_step, self.start_epoch, *val,
                                        extras=self.last_val_extras)

        # resume CONTINUES the checkpointed epoch from its saved batch
        # position; a fresh run starts at epoch 1, batch 0
        epoch = max(self.start_epoch, 1)
        start_batch = self.start_batch if self.start_epoch > 0 else 0
        # the operator's counter of the step's wait for its batch
        waits = Waits()
        waited = 0.0
        while epoch <= tp.max_epochs:
            self._print(f"Starting epoch {epoch}")
            batch_idx = start_batch
            it = self._train_batches(epoch=epoch, start_batch=start_batch)
            start_batch = 0
            accum = tp.grad_accum_steps
            # each step's real (non-pad) tokens, from the host batches'
            # lengths: a ragged final accum group's empty micro-batches add 0
            if accum > 1:
                feed = (
                    (self._put(b, axis=1), c, real_tokens(b))
                    for b, c in self._group_micro(it, accum)
                )
            else:
                feed = ((self._put(b), 1, real_tokens(b)) for b in it)
            # the host-to-device copy starts inside the prefetch thread,
            # so it overlaps the previous step's device compute
            for device_batch, consumed, tokens in prefetch(feed, size=2, waits=waits):
                # the grapheme head's full-length fallbacks in this step
                # alone: validation never runs inside it
                fell = masked_ce.FALLBACKS.count
                self.state, metrics = self.train_step(self.state, device_batch)
                fallbacks = masked_ce.FALLBACKS.count - fell if self.use_token_ids else None
                self.current_step += 1
                batch_idx += consumed
                self.profiler.tick(self.current_step)
                self.metrics.log_step(
                    self.current_step, epoch, metrics, tokens,
                    feed_wait_s=waits.seconds - waited, lm_head_fallbacks=fallbacks,
                )
                waited = waits.seconds
                if self.current_step % tp.save_interval == 0:
                    self._save(epoch, batch_idx)
                self._maybe_inject_fault()
                val_every = tp.val_interval or tp.save_interval
                if self.current_step % val_every == 0:
                    val = self.validate()
                    if val is not None:
                        self.metrics.log_validation(self.current_step, epoch, *val,
                                                    extras=self.last_val_extras)
                if self.current_step >= tp.num_steps:
                    if self.current_step % tp.save_interval != 0:
                        # final-step checkpoint (improvement over the
                        # reference, which loses the post-save tail)
                        self._save(epoch, batch_idx)
                    # (the train() wrapper joins the async writer)
                    self.metrics.flush()
                    return self.current_step
            epoch += 1
        # epoch-cap exit (reference hardcodes max_epochs=10, train.py:145):
        # persist the tail exactly like the num_steps exit does — without
        # this, up to save_interval-1 final steps were silently lost and
        # a relaunch re-trained them forever. Saved epoch is max_epochs+1
        # so a resume sees the run as COMPLETE instead of replaying the
        # final epoch.
        if self.current_step and self.current_step % tp.save_interval != 0:
            self._save(tp.max_epochs + 1, 0)
        self.metrics.flush()
        return self.current_step

    def _save(self, epoch: int, batch_idx: int) -> None:
        """Write step_N.pth; on a mesh every rank gathers the full tensors,
        rank 0 writes them, and every rank waits for the file."""
        tp = self.config.training_params
        save = save_checkpoint if self.ckpt_writer is None else self.ckpt_writer.submit
        params, opt_state = self.model.state_dict(), self.state.opt_state
        if self.mesh.size > 1:
            params, opt_state = gather_state(self.model, opt_state, self.mesh)
        if is_main_process():
            save(self.log_dir, self.current_step, params, opt_state, epoch, batch_idx,
                 keep=tp.keep_checkpoints)
        if self.mesh.size > 1:
            if self.ckpt_writer is not None:
                self.ckpt_writer.wait()
            dist.barrier()


def maybe_init_distributed(device: str = "cuda") -> None:
    """Join a ``torch.distributed`` world when ``PLBERT_DISTRIBUTED=1``
    (JAX :853-888): at ``PLBERT_COORDINATOR`` (host:port) with
    ``PLBERT_NUM_PROCESSES`` and ``PLBERT_PROCESS_ID`` (all three, or
    JAX's error), else from the launcher's ``env://`` variables. The
    backend is ``nccl`` on the card and ``gloo`` on the CPU;
    ``PLBERT_DIST_BACKEND`` overrides it, for one case only: several
    ranks sharing one card, where NCCL refuses and ``gloo`` (through
    host memory) checks the sharded step. On the card each rank takes
    ``cuda:<rank % cards>``."""
    if os.environ.get("PLBERT_DISTRIBUTED") != "1" or dist.is_initialized():
        return
    kwargs: dict = {"init_method": "env://"}
    if os.environ.get("PLBERT_COORDINATOR"):
        missing = [k for k in ("PLBERT_NUM_PROCESSES", "PLBERT_PROCESS_ID")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"PLBERT_COORDINATOR is set but {' and '.join(missing)} is not — an "
                "explicit coordinator needs all of PLBERT_COORDINATOR, "
                "PLBERT_NUM_PROCESSES, PLBERT_PROCESS_ID"
            )
        kwargs = dict(init_method=f"tcp://{os.environ['PLBERT_COORDINATOR']}",
                      world_size=int(os.environ["PLBERT_NUM_PROCESSES"]),
                      rank=int(os.environ["PLBERT_PROCESS_ID"]))
    cuda = torch.device(device).type == "cuda"
    backend = os.environ.get("PLBERT_DIST_BACKEND") or ("nccl" if cuda else "gloo")
    dist.init_process_group(backend, **kwargs)
    if cuda:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    if is_main_process():
        print(f"torch.distributed: {dist.get_world_size()} processes over {backend}",
              flush=True)


def train(args: dict | None = None, dataset=None) -> int:
    if args is None:
        args = parse_args()
    maybe_init_distributed(args.get("device", "cuda"))
    config, log_dir, resuming = setup_config_and_directories(
        args, args["config_path"]
    )
    verb = "Resuming" if resuming else "Starting new"
    if is_main_process():
        print(f"{verb} training run in '{log_dir}'.", flush=True)
    trainer = Trainer(config, log_dir, resuming, dataset=dataset,
                      device=args.get("device", "cuda"))
    t0 = time.perf_counter()
    try:
        final_step = trainer.train()
    finally:
        # close even when the loop raises: wandb runs must finalize and
        # the jsonl handle must flush (Trainer.train already joins the
        # async checkpoint writer on its own way out)
        trainer.metrics.close()
    if is_main_process():
        print(f"Training completed at step {final_step} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return final_step


if __name__ == "__main__":
    train()

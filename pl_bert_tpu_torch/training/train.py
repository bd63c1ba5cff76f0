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

One process, one card: the eager train step of ``train_step.py`` with
the hand-written kernels; the host pipeline (host masking, or packed
arrays for on-device masking) prefetched on a thread, which also starts
the host-to-device copy. The mesh, ZeRO-1, multi-host initialisation,
packed stores, remat and the multi-task head are not ported yet and raise
(``train_step.check_ported``); ``prng_impl`` is read and ignored.

Run: ``python -m pl_bert_tpu_torch.training.train --config_path
configs/config.yml --run_name myrun [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np
import torch

from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.data.pipeline import build_dataloader, prefetch, to_device
from pl_bert_tpu_torch.models.albert import build_model, init_params
from pl_bert_tpu_torch.training.checkpoint import (
    AsyncCheckpointWriter,
    checkpoint_path,
    find_latest_checkpoint,
    load_checkpoint,
    load_params_only,
    save_checkpoint,
)
from pl_bert_tpu_torch.training.metrics import MetricsLogger
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
    temporary name and renamed, so a crash never leaves half a config."""
    original = Config.load(config_path)
    log_dir = os.path.join(original.training_params.output_dir, args["run_name"])
    config_copy = os.path.join(log_dir, os.path.basename(config_path))

    resuming = os.path.exists(log_dir) and os.path.exists(config_copy)
    if not resuming:
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


def load_processed_dataset(path: str) -> list[dict]:
    """The records of a ``records.jsonl`` directory, as
    ``pl_bert_tpu.preprocess`` writes one (a JSON object with a
    ``phonemes`` list per line); the counterpart of
    ``pl_bert_tpu/preprocess/shard_engine.py::load_processed_dataset``."""
    import json

    with open(os.path.join(path, "records.jsonl"), "r", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def load_training_dataset(name: str, split: str, token_vocab: int = 0):
    """Resolve the configured dataset: ``synthetic[-derivable]:N[:POOL
    [:WMIN-WMAX]]`` (POOL sizes the closed lexicon, WMIN-WMAX the words
    per sample) or a directory holding ``records.jsonl``. A packed store,
    an HF ``save_to_disk`` directory and a hub id are not ported yet."""
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
        if os.path.exists(os.path.join(name, "packed_meta.json")):
            raise NotImplementedError(
                f"training_dataset {name!r} is a packed store, which is not yet ported to "
                "pl_bert_tpu_torch"
            )
        if os.path.exists(os.path.join(name, "records.jsonl")):
            return load_processed_dataset(name)
    raise NotImplementedError(
        f"training_dataset {name!r}: only synthetic:N specs and records.jsonl directories "
        "are ported to pl_bert_tpu_torch (HF datasets are not yet ported)"
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
    ):
        check_ported(config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the trainer runs on the card unless asked for --device cpu"
            )
        self.config = config
        self.log_dir = log_dir
        self.resuming = resuming
        tp, mp, dp = (
            config.training_params,
            config.model_params,
            config.dataset_params,
        )

        self.model = init_params(build_model(mp, tp.mixed_precision), seed=tp.seed)
        self.model.to(self.device)
        self.tx = make_optimizer(tp)

        if dataset is None:
            dataset = load_training_dataset(tp.training_dataset, tp.split)
        self.ondevice_masking = dp.ondevice_masking
        self.masking_params = None
        if dp.sequence_packing and not dp.ondevice_masking:
            raise ValueError("sequence_packing requires ondevice_masking")
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
            if dp.sequence_packing:
                print(
                    f"sequence packing: {len(dataset)} samples → "
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
                seed=tp.seed,
            )

        self.state = TrainState(self.model, self.tx.init(self.model), 0)
        self.start_epoch = 0
        self.start_batch = 0
        self.current_step = 0

        if mp.pretrained_model:
            print(f"Loading pretrained model from: {mp.pretrained_model}")
            load_params_only(mp.pretrained_model, self.model)

        found, latest = find_latest_checkpoint(log_dir)
        if found and resuming:
            path = checkpoint_path(log_dir, latest)
            meta = load_checkpoint(path, self.model, self.state.opt_state)
            self.state.step = meta["step"]
            self.current_step = meta["step"]
            self.start_epoch = meta["epoch"]
            self.start_batch = meta["batch_in_epoch"]
            print(f"Checkpoint {path} loaded.")

        self.train_step = make_train_step(
            self.model, self.tx, grad_accum=tp.grad_accum_steps, seed=tp.seed,
            masking_params=self.masking_params,
        )
        self.eval_step = make_eval_step(self.model, masking_params=self.masking_params)
        self.ckpt_writer = AsyncCheckpointWriter() if tp.async_save else None
        self.metrics = MetricsLogger(
            log_dir, tp.log_interval, tp.wandb_project, config.to_dict()
        )
        from pl_bert_tpu_torch.utils.profiler import maybe_profile

        self.profiler = maybe_profile()

    def _put(self, batch) -> dict:
        """The batch's arrays on the device (a corpus's grapheme
        ``token_ids`` stay behind: the multi-task head is not ported);
        called inside the prefetch thread, so the copy overlaps the
        previous step."""
        arrays = batch if isinstance(batch, dict) else batch_to_arrays(batch)
        return to_device(
            {k: v for k, v in arrays.items() if k != "token_ids"}, self.device
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
        tp = self.config.training_params
        for i, batch in enumerate(self._val_batches()):
            arrays = batch if isinstance(batch, dict) else batch_to_arrays(batch)
            arrays = self._pad_batch(arrays, tp.batch_size)
            # a fixed masking seed per batch index: validation masking
            # patterns are independent across batches and the same
            # across runs
            loss, acc, n_masked = self.eval_step(
                self._put(arrays), (tp.seed + 1) * 2**32 + i
            )
            if int(n_masked) == 0:
                continue
            losses.append(float(loss))
            accs.append(float(acc))
        self._last_val_batches = len(losses)
        self.last_val_extras = None  # the multi-task head's metrics: not ported yet
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
        if os.path.exists(marker):
            return
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
        dp = self.config.dataset_params
        tokens_per_batch = tp.batch_size * dp.max_seq_length * tp.grad_accum_steps

        if self.current_step >= tp.num_steps:
            # already complete — never train past the configured budget on
            # relaunch (an elastic launcher restarts unconditionally)
            return self.current_step

        val = self.validate()
        if val is None:
            print(
                "Validation skipped: no usable validation batches "
                "(95/5 split smaller than a batch, or masking "
                "selected zero positions in every batch)",
                flush=True,
            )
        else:
            self.metrics.log_validation(self.current_step, self.start_epoch, *val)

        # resume CONTINUES the checkpointed epoch from its saved batch
        # position; a fresh run starts at epoch 1, batch 0
        epoch = max(self.start_epoch, 1)
        start_batch = self.start_batch if self.start_epoch > 0 else 0
        while epoch <= tp.max_epochs:
            print(f"Starting epoch {epoch}", flush=True)
            batch_idx = start_batch
            it = self._train_batches(epoch=epoch, start_batch=start_batch)
            start_batch = 0
            accum = tp.grad_accum_steps
            if accum > 1:
                feed = (
                    (self._put(b), c)
                    for b, c in self._group_micro(it, accum)
                )
            else:
                feed = ((self._put(b), 1) for b in it)
            # the host-to-device copy starts inside the prefetch thread,
            # so it overlaps the previous step's device compute
            for device_batch, consumed in prefetch(feed, size=2):
                self.state, metrics = self.train_step(self.state, device_batch)
                self.current_step += 1
                batch_idx += consumed
                self.profiler.tick(self.current_step)
                # a ragged final accum group consumed fewer loader
                # batches — credit only the tokens actually stepped
                step_tokens = tokens_per_batch * consumed // tp.grad_accum_steps
                self.metrics.log_step(
                    self.current_step, epoch, metrics, step_tokens
                )
                if self.current_step % tp.save_interval == 0:
                    self._save(epoch, batch_idx)
                self._maybe_inject_fault()
                val_every = tp.val_interval or tp.save_interval
                if self.current_step % val_every == 0:
                    val = self.validate()
                    if val is not None:
                        self.metrics.log_validation(self.current_step, epoch, *val)
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
        tp = self.config.training_params
        save = save_checkpoint if self.ckpt_writer is None else self.ckpt_writer.submit
        save(
            self.log_dir, self.current_step, self.model.state_dict(),
            self.state.opt_state, epoch, batch_idx, keep=tp.keep_checkpoints,
        )


def train(args: dict | None = None, dataset=None) -> int:
    if args is None:
        args = parse_args()
    config, log_dir, resuming = setup_config_and_directories(
        args, args["config_path"]
    )
    verb = "Resuming" if resuming else "Starting new"
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
    print(
        f"Training completed at step {final_step} "
        f"({time.perf_counter() - t0:.1f}s)",
        flush=True,
    )
    return final_step


if __name__ == "__main__":
    train()

"""Typed, schema-validated configuration.

A copy of ``pl_bert_tpu/config.py``: the same sections, keys, defaults and
checks. ``yaml`` is imported only where a file is read or written.

Keeps the reference's YAML contract — four sections
``preprocess_params`` / ``training_params`` / ``dataset_params`` /
``model_params`` (reference: configs/config.yml:1-39) — but validates
keys instead of silently forwarding unknowns into the model config
(the reference passes ``dropout``/``pretrained_model`` into
``AlbertConfig`` as inert attributes, train.py:263).

TPU-specific knobs (mesh shape, precision, packing) live in the same
sections with defaults that reproduce reference behavior.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


class ConfigError(ValueError):
    pass


def _build(cls, section: str, raw: dict[str, Any]):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - known
    if unknown:
        raise ConfigError(
            f"unknown keys in '{section}': {sorted(unknown)}; known: {sorted(known)}"
        )
    return cls(**raw)


@dataclass
class PreprocessParams:
    """Corpus preprocessing (reference: configs/config.yml:1-11)."""

    tokenizer: str = "aubmindlab/bert-base-arabertv2"
    num_shards: int = 10000
    max_workers: int = 25
    max_try_count: int = 3
    timeout: int = 300
    phonemizer_language: str = "ar"
    preprocess_dir: str = "data/pl_bert"
    hf_dataset_name: str = "wikimedia/wikipedia"
    hf_dataset_split: str = "20231101.ar"
    cleaned_output_dir: str = "wikipedia_20231101.ar.cleaned"
    # TPU build extensions
    g2p_backend: str = "espeak"  # espeak | identity (test fallback)
    with_stress: bool = True
    preserve_punctuation: bool = True
    # Clean-stage normalization language. "ar" reproduces the reference's
    # live path exactly (numbers→Arabic words, Arabic-only filter —
    # reference: preprocess.py:18-30). "en" routes through the English
    # converter registry (normalize.py::normalize_text — upstream
    # PL-BERT's language; DEAD code in the reference at
    # text_normalize.py:282, implemented working here) with no
    # script filter.
    clean_language: str = "ar"

    def __post_init__(self) -> None:
        if self.clean_language not in ("ar", "en"):
            raise ConfigError(
                f"preprocess_params.clean_language must be 'ar' or 'en', "
                f"got {self.clean_language!r}"
            )


@dataclass
class TrainingParams:
    """Training runtime (reference: configs/config.yml:13-22)."""

    output_dir: str = "checkpoints"
    mixed_precision: str = "bf16"  # fp32 | bf16 (TPU-native; ref used fp16)
    batch_size: int = 96
    save_interval: int = 1000
    log_interval: int = 10
    # Accepted for reference-config compatibility ONLY (reference:
    # configs/config.yml:19 'number of GPUs'). Under JAX the process
    # count comes from the launch environment (jax.distributed /
    # JAX_PROCESS_COUNT), never from config; Trainer warns when this
    # disagrees with the actual jax.process_count().
    num_process: int = 1
    num_steps: int = 1_000_000
    learning_rate: float = 7e-5
    training_dataset: str = ""
    split: str = "train"
    # TPU build extensions
    max_epochs: int = 10  # reference hardcodes 10 (train.py:145)
    seed: int = 1
    data_axis: int = -1  # -1 → all devices on the data axis
    model_axis: int = 1  # tensor-parallel degree (1 = pure DP, as reference)
    weight_decay: float = 0.01  # torch AdamW default, as the reference uses
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    keep_checkpoints: int = 0  # 0 → keep all (reference keeps all)
    val_interval: int = 0  # 0 → validate at save_interval (reference behavior)
    wandb_project: str = ""  # "" → stdout metrics only
    remat: bool = False  # jax.checkpoint the encoder scan body
    donate_state: bool = True
    # PRNG for dropout/masking keys: 'rbg' is ~20% faster end-to-end on
    # TPU than threefry (hardware-friendly generator), statistically fine
    # for dropout; set 'threefry2x32' for jax-default streams
    prng_impl: str = "rbg"
    # TPU build extension: accumulate gradients over N micro-batches of
    # ``batch_size`` inside one jitted step (lax.scan), then apply ONE
    # optimizer update — effective batch = batch_size * grad_accum_steps
    # with the activation memory of a single micro-batch. Weighted by
    # samples-with-masks per micro-batch, so the update is numerically
    # identical to a single large batch (tests/test_grad_accum.py).
    grad_accum_steps: int = 1
    # TPU build extension: learning-rate schedule over num_steps. The
    # reference trains at a constant 7e-5 (reference: train.py:272);
    # 'constant' + warmup_steps 0 reproduces that exactly. 'linear' and
    # 'cosine' decay from learning_rate to learning_rate * lr_min_ratio
    # by num_steps; warmup_steps > 0 prepends a linear 0 → peak ramp.
    # The schedule is driven by the optimizer's own update count, so it
    # survives checkpoint resume (tests/test_lr_schedule.py).
    lr_schedule: str = "constant"  # constant | linear | cosine
    warmup_steps: int = 0
    lr_min_ratio: float = 0.0
    # TPU build extension: write checkpoints from a background thread
    # (device-side state snapshot first, so the training loop's donated
    # buffers can advance immediately) instead of blocking the step loop
    # on the device→host transfer + disk IO every save_interval
    async_save: bool = False
    # TPU build extension: ZeRO-1 optimizer-state sharding — partition
    # the AdamW moments over the data axis (each leaf's first evenly
    # divisible, not-already-model-sharded dim). The reference
    # replicates optimizer state per DDP rank; this drops it to
    # ~1/data_axis per chip and runs the elementwise update sharded,
    # with the step math unchanged (tests/test_zero1.py asserts step
    # parity). No effect on a single-device (or model-only) mesh.
    zero1: bool = False
    # TPU build extension: clip the global gradient norm to this value
    # before the AdamW update (optax.clip_by_global_norm). 0 disables —
    # the reference applies no clipping (reference: train.py:272), so
    # the default reproduces its update exactly. The per-step norm is
    # already reported as the ``grad_norm`` metric either way.
    grad_clip_norm: float = 0.0
    # TPU build extension (multi-task only): compute the 60k grapheme
    # head's masked CE with forward-computed gradients
    # (ops/masked_ce.py::masked_lm_loss_fused) — one fewer pass of the
    # dominant [rows,H]x[H,V] matmul per step than the remat'd chunked
    # scan. Loss values are bitwise-identical to the default path;
    # gradients agree to compute-dtype rounding (the update trajectory
    # is NOT bitwise). Default ON since round 4: chip-measured +5.4%
    # multitask step throughput (190.9k vs 181.2k tok/s, BENCH_LEDGER
    # mtbase/mtfused); set false to reproduce the reference-exact
    # chunked trajectory.
    fused_lm_head: bool = True
    # TPU build extension (multi-task only): per-sample masked-position
    # gather capacity for the 60k grapheme head
    # (ops/masked_ce.py::masked_lm_loss). The head projection runs on at
    # most this many gathered positions per sample; a lax.cond falls
    # back to the exact full-length path if any sample in the batch
    # overflows, so EVERY value is exact — capacity only trades the
    # dominant [rows,H]x[H,V] matmul's FLOPs against fallback frequency.
    # At the reference masking setup (word_pred_prob 0.15, seq 512 —
    # reference: dataloader.py:83-108) the measured masked-count
    # distribution is mean 58 / sigma 18 / max-of-8192 = 135: the
    # default 144 is ~4.8 sigma (zero exceedances in 8192 draws) and
    # was chip-measured at 201.0k vs 190.9k multitask tok/s (+5.2%)
    # against the previous 192 (~7.4 sigma; BENCH_LEDGER mtcap144).
    # 128 measured SLOWER (186.5k): ~3.5% of batches overflow and take
    # the 2.7x-FLOPs exact fallback. Raise this if a corpus/masking
    # config masks well past 144 tokens per sample (the fallback keeps
    # every value exact either way — capacity only trades speed).
    # 0 = disable the gather (always run the full-length path).
    lm_head_capacity: int = 144

    def __post_init__(self) -> None:
        # coerce EVERY float field: PyYAML parses dot-less scientific
        # notation ('1e-8', '7e-5') as strings, which would otherwise
        # reach optax and die inside the first jitted step
        for field in (
            "learning_rate", "lr_min_ratio", "grad_clip_norm",
            "weight_decay", "adam_b1", "adam_b2", "adam_eps",
        ):
            setattr(self, field, float(getattr(self, field)))
        if self.grad_clip_norm < 0:
            raise ConfigError(
                f"grad_clip_norm must be >= 0, got {self.grad_clip_norm}"
            )
        if self.mixed_precision not in ("fp32", "bf16", "fp16", "no"):
            raise ConfigError(f"bad mixed_precision: {self.mixed_precision}")
        if self.grad_accum_steps < 1:
            raise ConfigError(
                f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}"
            )
        if self.lm_head_capacity < 0:
            raise ConfigError(
                f"lm_head_capacity must be >= 0 (0 = full-length path), "
                f"got {self.lm_head_capacity}"
            )
        if self.lr_schedule not in ("constant", "linear", "cosine"):
            raise ConfigError(
                f"lr_schedule must be constant|linear|cosine, got "
                f"{self.lr_schedule!r}"
            )
        if self.warmup_steps < 0:
            raise ConfigError(f"warmup_steps must be >= 0, got {self.warmup_steps}")
        if not 0.0 <= self.lr_min_ratio <= 1.0:
            raise ConfigError(
                f"lr_min_ratio must be in [0, 1], got {self.lr_min_ratio}"
            )
        if self.save_interval < 1 or self.log_interval < 1:
            # fail HERE, not as a ZeroDivisionError after the first
            # (minutes-long on the remote TPU) compile + train step
            raise ConfigError(
                f"save_interval/log_interval must be >= 1, got "
                f"{self.save_interval}/{self.log_interval}"
            )
        if self.val_interval < 0:
            raise ConfigError(
                f"val_interval must be >= 0 (0 = validate at "
                f"save_interval), got {self.val_interval}"
            )
        if self.max_epochs < 1 or self.num_steps < 1:
            raise ConfigError(
                f"max_epochs/num_steps must be >= 1, got "
                f"{self.max_epochs}/{self.num_steps}"
            )


@dataclass
class DatasetParams:
    """Masking distribution (reference: configs/config.yml:24-31)."""

    word_separator: int = 87
    max_seq_length: int = 512
    word_pred_prob: float = 0.15
    phoneme_mask_prob: float = 0.8
    replace_prob: float = 0.1
    # TPU build extension: fuse whole-word masking into the jitted train
    # step (ops/ondevice_masking.py) instead of the host collate
    ondevice_masking: bool = False
    # pack multiple short samples per row with block-diagonal attention
    # (segment-aware flash kernel); requires ondevice_masking
    sequence_packing: bool = False

    def __post_init__(self) -> None:
        for field in ("word_pred_prob", "phoneme_mask_prob", "replace_prob"):
            value = float(getattr(self, field))
            setattr(self, field, value)
            if not 0.0 <= value <= 1.0:
                raise ConfigError(f"{field} must be in [0, 1], got {value}")
        if not 0.0 <= self.phoneme_mask_prob + self.replace_prob <= 1.0:
            raise ConfigError("phoneme_mask_prob + replace_prob must be in [0,1]")


@dataclass
class ModelParams:
    """ALBERT shape (reference: configs/config.yml:33-39 + train.py:263)."""

    pretrained_model: str = ""
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    num_hidden_layers: int = 12
    dropout: float = 0.1
    # HF AlbertConfig defaults the reference inherits implicitly:
    embedding_size: int = 128
    vocab_size: int = 188
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    hidden_act: str = "gelu_new"
    # TPU build extensions
    attention_impl: str = "auto"  # auto | xla | pallas
    num_token_vocab: int = 0  # >0 enables the grapheme (token) head
    # Megatron-style sequence parallelism (with model_axis > 1): the
    # attention out-projection reduce-scatters over the sequence instead
    # of all-reducing, the dropout+add+LayerNorm kernels run on L/m
    # sequence shards, and activations re-gather going into the TP FFN —
    # same communication volume as plain TP, 1/m the LN-region activation
    # memory and compute per chip. Requires max_seq_length % model_axis
    # == 0; no effect when model_axis == 1.
    sequence_parallel: bool = False

    def __post_init__(self) -> None:
        # same YAML-string-float coercion as TrainingParams
        for f in ("dropout", "layer_norm_eps", "initializer_range"):
            setattr(self, f, float(getattr(self, f)))


@dataclass
class Config:
    preprocess_params: PreprocessParams = field(default_factory=PreprocessParams)
    training_params: TrainingParams = field(default_factory=TrainingParams)
    dataset_params: DatasetParams = field(default_factory=DatasetParams)
    model_params: ModelParams = field(default_factory=ModelParams)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        sections = {
            "preprocess_params": PreprocessParams,
            "training_params": TrainingParams,
            "dataset_params": DatasetParams,
            "model_params": ModelParams,
        }
        unknown = set(raw) - set(sections)
        if unknown:
            raise ConfigError(f"unknown config sections: {sorted(unknown)}")
        kwargs = {
            name: _build(sec_cls, name, raw.get(name) or {})
            for name, sec_cls in sections.items()
        }
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str) -> "Config":
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        import yaml

        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

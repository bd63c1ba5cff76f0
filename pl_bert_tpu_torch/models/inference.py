"""Inference API: phoneme strings → contextual embeddings, in PyTorch.

The counterpart of ``pl_bert_tpu/models/inference.py``: the same
surface (fixed batch padding, ``seq_buckets``, ``swap_params``,
``clone_to``, split ``dispatch``/``fetch``), running the port's
``AlbertModel`` on one device. The forward goes through the
hand-written attention-block and fused-LN kernels on a CUDA device; on
the CPU it runs their plain versions.

Weights come from a reference ``.pth`` (``export/bridge.py``), never
from orbax or an HF directory.
"""

from __future__ import annotations

import numpy as np
import torch

from pl_bert_tpu.text.symbols import encode
from pl_bert_tpu_torch.export.bridge import load_reference_pth
from pl_bert_tpu_torch.models.albert import AlbertConfig, AlbertModel, move_weights


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "PhonemeEncoder: CUDA is not available; pass device='cpu' to "
            "run the plain path on the CPU"
        )
    return dev


class PhonemeEncoder:
    def __init__(
        self,
        state_dict: dict,
        model_params,
        max_seq_length: int = 512,
        mixed_precision: str = "bf16",
        batch_size: int | None = None,
        quantize: str | None = None,
        seq_buckets: tuple[int, ...] | None = None,
        device="cuda",
    ) -> None:
        """``state_dict``: the encoder's fp32 state dict in HF names (see
        ``export/bridge.py``). ``model_params``: anything with
        ``ModelParams``' attribute names. ``batch_size``: pad every call's
        batch to this size, so every forward has one of a few shapes.
        ``seq_buckets``: ascending sequence-length buckets; a call pads to
        the smallest bucket covering its longest input (valid-prefix
        hidden states are the same either way). ``device``: where the
        weights live and the forward runs; CUDA by default, and there is
        no silent fall back to the CPU."""
        if quantize is not None:
            raise NotImplementedError(
                f"quantize={quantize!r}: int8 serving is not yet ported "
                "to pl_bert_tpu_torch"
            )
        self.device = _device(device)
        dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
        self.cfg = AlbertConfig.from_params(model_params, dtype=dtype)
        self.model = AlbertModel.from_state_dict(self.cfg, state_dict)
        self._spec = {
            k: (tuple(v.shape), v.dtype) for k, v in self.model.state_dict().items()
        }
        self.weights = self.model.compute_weights(self.device)
        self.max_seq_length = max_seq_length
        self.batch_size = batch_size
        if seq_buckets is not None:
            buckets = sorted(int(b) for b in seq_buckets)
            if not buckets:
                raise ValueError("seq_buckets must not be empty (pass None "
                                 "for a single full-length shape)")
            if buckets != sorted(set(buckets)):
                raise ValueError(f"seq_buckets must be unique: {seq_buckets}")
            if buckets[0] < 1 or buckets[-1] > max_seq_length:
                raise ValueError(
                    f"seq_buckets must lie in [1, {max_seq_length}]: "
                    f"{seq_buckets}"
                )
            if buckets[-1] != max_seq_length:
                buckets.append(max_seq_length)
            seq_buckets = tuple(buckets)
        self.seq_buckets = seq_buckets

    def swap_params(self, new_state_dict: dict) -> None:
        """Adopt ``new_state_dict`` for every forward AFTER this call —
        zero-downtime weight rollout. Keys, shapes and dtypes must match
        the current weights exactly; anything else is a different model.

        The new weight set is built beside the old one and then bound in
        one attribute assignment: a forward reads ``self.weights`` once,
        so in-flight forwards (pipelined dispatches included) finish on
        the old weights, which nothing writes to."""
        new = dict(new_state_dict)
        missing = sorted(set(self._spec) - set(new))
        extra = sorted(set(new) - set(self._spec))
        if missing or extra:
            raise ValueError(
                f"param tree mismatch: missing {missing}, unexpected {extra}"
            )
        for k, (shape, dtype) in self._spec.items():
            t = new[k]
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(
                    f"param tree mismatch at {k}: have {shape}/{dtype}, "
                    f"reload has {tuple(t.shape)}/{t.dtype} — reloads must "
                    "keep the model shape"
                )
        model = AlbertModel.from_state_dict(self.cfg, new)
        weights = model.compute_weights(self.device)
        self.model = model
        self.weights = weights

    def clone_to(self, device) -> "PhonemeEncoder":
        """A replica of this encoder whose weights live on ``device``
        (the replica-per-device building block of serving/pool.py)."""
        c = object.__new__(PhonemeEncoder)
        c.__dict__.update(self.__dict__)
        c.device = _device(device)
        c.weights = move_weights(self.weights, c.device)
        return c

    # --- constructors ------------------------------------------------------
    @staticmethod
    def checkpoint_encoder_params(checkpoint_path: str) -> dict:
        """The encoder's state dict from a reference ``.pth`` — what
        :meth:`from_checkpoint` builds from and :meth:`swap_params`
        reloads."""
        return load_reference_pth(checkpoint_path)

    @classmethod
    def from_checkpoint(
        cls, checkpoint_path: str, config=None, **kwargs
    ) -> "PhonemeEncoder":
        """Load from a reference ``.pth``. ``config``: a training config
        (``pl_bert_tpu.config.Config``), a path to one (needs pyyaml), or
        None for the flagship shape (``AlbertConfig()`` defaults,
        ``max_seq_length`` = its position count)."""
        if isinstance(config, str):
            from pl_bert_tpu.config import Config

            config = Config.load(config)
        if config is None:
            model_params = AlbertConfig()
            max_seq_length = model_params.max_position_embeddings
        else:
            model_params = config.model_params
            max_seq_length = config.dataset_params.max_seq_length
        return cls(
            cls.checkpoint_encoder_params(checkpoint_path), model_params,
            max_seq_length, **kwargs,
        )

    # --- inference ----------------------------------------------------------
    def encode_batch(
        self, phoneme_strings: list[str]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host side: phoneme strings → (ids [B, L], mask [B, L],
        lengths [B]) int32 arrays, cropped/padded to max_seq_length (or
        the smallest covering bucket when ``seq_buckets`` is set).
        With a fixed ``batch_size``, B is padded up to it (extra rows are
        empty; lengths stays len(phoneme_strings) long)."""
        n = len(phoneme_strings)
        b = n if self.batch_size is None else self.batch_size
        if n > b:
            raise ValueError(
                f"{n} strings exceed the encoder's fixed batch_size {b}"
            )
        rows = [encode(t)[: self.max_seq_length] for t in phoneme_strings]
        L = self.max_seq_length
        if self.seq_buckets is not None:
            needed = max((len(r) for r in rows), default=1)
            L = next(bk for bk in self.seq_buckets if bk >= needed)
        ids = np.zeros((b, L), np.int32)
        lengths = np.zeros(b, np.int32)
        for i, row in enumerate(rows):
            ids[i, : len(row)] = row
            lengths[i] = len(row)
        mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
        return ids, mask, lengths[:n]

    def forward(self, ids, mask) -> torch.Tensor:
        """Device side: the encoder forward → hidden states [B, L, H] in
        the compute dtype, on the device and NOT synchronised. Inference
        mode is entered here because it is thread-local: the serving
        batcher calls this from its own worker thread."""
        weights = self.weights  # read once: a concurrent swap rebinds it
        with torch.inference_mode():
            ids_t = torch.as_tensor(np.asarray(ids)).to(self.device)
            mask_t = torch.as_tensor(np.asarray(mask)).to(self.device)
            hidden, _ = self.model(ids_t, mask_t, weights=weights)
        return hidden

    def dispatch(self, phoneme_strings: list[str]):
        """Host encode + launch the forward WITHOUT waiting for it:
        kernels are queued on the current stream and this returns.
        Pair with :meth:`fetch` — the split lets a serving loop overlap
        batch N+1's forward with batch N's device→host copy
        (serving/batcher.py ``pipeline_depth``)."""
        ids, mask, lengths = self.encode_batch(phoneme_strings)
        return self.forward(ids, mask), lengths, len(phoneme_strings)

    @staticmethod
    def fetch(handle) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`dispatch` handle's forward and return
        ``(hidden [B, L, H] fp32, lengths [B])`` on the host."""
        hidden, lengths, n = handle
        return hidden[:n].float().cpu().numpy(), lengths

    def __call__(self, phoneme_strings: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """→ (hidden_states [B, L, H] fp32, lengths [B]); B is the number
        of input strings regardless of any fixed batch padding. L is
        max_seq_length, or the call's chosen bucket under seq_buckets —
        row i's valid prefix is hidden[i, :lengths[i]] either way."""
        return self.fetch(self.dispatch(phoneme_strings))


def main(argv=None) -> None:
    """Batch CLI: phoneme strings → contextual embeddings on disk::

        python -m pl_bert_tpu_torch.models.inference \\
            --checkpoint step_1000.pth --input phonemes.txt --output hidden.npz

    ``--input`` is one phoneme string per line (``-`` = stdin). The
    output ``.npz`` holds ``hidden`` [N, L, H] plus ``lengths`` [N]
    (row i's valid prefix is ``hidden[i, :lengths[i]]``).
    """
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        description="Encode phoneme strings to PL-BERT hidden states"
    )
    parser.add_argument("--checkpoint", required=True,
                        help="reference .pth (training save or state dict)")
    parser.add_argument("--config_path",
                        help="training config (default: the flagship shape)")
    parser.add_argument("--input", required=True,
                        help="phoneme strings, one per line ('-' = stdin)")
    parser.add_argument("--output", required=True, help="output .npz path")
    parser.add_argument("--batch_size", type=int, default=64,
                        help="fixed batch (streamed in chunks)")
    parser.add_argument("--dtype", choices=["float32", "float16"],
                        default="float32", help="stored hidden dtype")
    parser.add_argument("--int8", action="store_true",
                        help="int8 dense projections (not yet ported: raises)")
    parser.add_argument("--buckets", default="",
                        help="comma-separated sequence-length buckets "
                        "(e.g. 64,128,256): each chunk runs at the "
                        "smallest covering length")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                        "plain path)")
    args = parser.parse_args(argv)

    enc = PhonemeEncoder.from_checkpoint(
        args.checkpoint, args.config_path,
        batch_size=args.batch_size,
        quantize="int8" if args.int8 else None,
        seq_buckets=tuple(int(x) for x in args.buckets.split(",") if x) or None,
        device=args.device,
    )

    fh = sys.stdin if args.input == "-" else open(args.input, encoding="utf-8")
    with fh:
        # rstrip \r too: a CRLF-authored file would otherwise append a
        # silent UNKNOWN symbol to every utterance via encode()'s OOV map
        lines = [line.rstrip("\r\n") for line in fh if line.strip()]
    if not lines:
        parser.error("no non-empty input lines")

    out_dtype = np.float16 if args.dtype == "float16" else np.float32
    # with buckets on, group similar lengths into the same chunk (and
    # restore input order after)
    order = (
        sorted(range(len(lines)), key=lambda i: len(lines[i]))
        if enc.seq_buckets is not None else range(len(lines))
    )
    ordered = [lines[i] for i in order]
    chunks, lens = [], []
    for lo in range(0, len(ordered), args.batch_size):
        hidden, lengths = enc(ordered[lo:lo + args.batch_size])
        if hidden.shape[1] < enc.max_seq_length:  # bucketed chunk:
            hidden = np.pad(  # keep the [N, max_L, H] output contract
                hidden,
                ((0, 0), (0, enc.max_seq_length - hidden.shape[1]), (0, 0)),
            )
        chunks.append(hidden.astype(out_dtype))
        lens.append(lengths)
    hidden_all = np.concatenate(chunks)
    lens_all = np.concatenate(lens).astype(np.int32)
    unsort = np.argsort(np.asarray(list(order)))
    np.savez(args.output, hidden=hidden_all[unsort], lengths=lens_all[unsort])
    print(
        f"encoded {len(lines)} strings -> {args.output} "
        f"(hidden [{len(lines)}, {enc.max_seq_length}, "
        f"{enc.cfg.hidden_size}] {args.dtype})"
    )


if __name__ == "__main__":
    main()

"""Checkpoint → HF export CLI, the counterpart of ``pl_bert_tpu/export/cli.py``::

    python -m pl_bert_tpu_torch.export.cli --checkpoint_path step_N.pth \\
        --config_path cfg.yml --output_dir DIR

The equivalent of the reference's ``python convert_to_hf.py
--checkpoint_path ... --config_path ... --output_dir ...``
(convert_to_hf.py:9-64): reads a ``.pth`` of the port's Trainer (or of
``pl_bert_tpu.export.to_torch``, or a bare state dict) and writes the HF
``AlbertModel`` directory, the full model's state, the metadata and the
config copy (``export/to_hf.py::export_checkpoint``). The step and epoch
come from the ``.pth``'s own ``step``/``epoch`` keys, or else the step
from the file name (``step_N``) and epoch 0.

The export only converts files on the host, so it takes no ``--device``
and touches no card.
"""

from __future__ import annotations

import argparse
import os
import re

import torch

from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.export.to_hf import export_checkpoint


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="Convert a PL-BERT checkpoint (.pth) to the HuggingFace format")
    parser.add_argument("--checkpoint_path", required=True,
                        help="step_N.pth (a training save with 'net', or a state dict)")
    parser.add_argument("--config_path", required=True, help="the run's training config")
    parser.add_argument("--output_dir", required=True)
    args = parser.parse_args(argv)

    config = Config.load(args.config_path)
    ckpt = torch.load(args.checkpoint_path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        parser.error(f"{args.checkpoint_path}: not a state dict or a training save")
    net = ckpt["net"] if "net" in ckpt else ckpt
    m = re.search(r"step_(\d+)", os.path.basename(args.checkpoint_path))
    step = int(ckpt.get("step", int(m.group(1)) if m else 0))
    epoch = int(ckpt.get("epoch", 0))
    export_checkpoint(net, config.to_dict(), args.output_dir, step=step, epoch=epoch,
                      checkpoint_path=args.checkpoint_path)
    print(f"Model successfully converted and saved to {args.output_dir}")
    return args.output_dir


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, its training step, its Trainer
entry point, its multi-task pretraining run (from memory, then from a
packed store under restart supervision), its deployment path (HF export,
``--hf_dir`` loading, int8 serving), remat, its sharded step (data,
tensor and sequence parallelism, ZeRO-1, the vocabulary-parallel
grapheme head) and its text stages from raw Arabic text to a
production-shape run once on one CUDA card.

    python3 chip_smoke.py

At the full width of the flagship model (configs/config.yml: hidden 768,
12 heads of 64, FFN 2048, 12 layers, embedding 128, vocab 188, L 512)
with random weights made from a fixed seed, in order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels from the sources in this checkout, and shows that
   the bf16 attention kernels, forward and backward, run on the tensor
   cores: ``cuobjdump -sass`` counts the HGMMA (wgmma) and HMMA
   (mma.sync) instructions of the projection GEMM (``gemm_bias_sm90``),
   the attention pass (``attention_fwd_sm90``) and the backward's dq and
   dk/dv kernels (``attention_bwd_dq_sm90``, ``attention_bwd_dkdv_sm90``)
   in both libraries, and raises if any has no HGMMA; it prints what
   ``ptxas -v`` said of their registers, shared memory and spills, and of
   the fused LN library's (K5 and K6 at three slices a lane, bf16 and
   fp32, with and without dropout; K9: ``csrc/fused_ln.cu``), and counts
   the IMAD and LOP3 instructions one Philox draw of K5 and of K6 issues
   (the SASS with dropout less without, over the 24 draws a lane makes a
   row);
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes, in bf16 and fp32 (TF32 off); the block also
   at head_dim 128 (6 heads, L 200); K5 also at dropout 0.1, the plain
   version fed the mask of Triton's own ``tl.rand``;
4. runs the 12-layer encoder on the kernel path against the plain path;
5. writes the weights as a reference .pth and starts the port's HTTP
   server through its normal entry, in a thread;
6. answers 32 requests of 5-500 phonemes from 4 client threads and holds
   each answer against a direct PhonemeEncoder call; the same again from a
   server at ``--pipeline_depth 1``; then prints the pipeline line: how
   long a second ``dispatch`` holds its thread, how long before the end of
   batch N+1's forward ``fetch(N)`` returns, and the request latency at
   depth 1 and 2;
7. checks from the launch counters that every forward of that run went
   through the kernels (12 attention blocks, 24 fused LNs a forward);
8. times each kernel against its plain version, and the encoder forward
   at B=8, L=512 on both paths; K5 at [4096, 768] and [49152, 768] (past
   the L2), dropout 0 and 0.1, beside the library call (``F.dropout``,
   the add, ``F.layer_norm``) and its bound with the integer term of its
   draws (the kernels line takes [49152, 768] at dropout 0.1, where the
   bytes bound holds; the serving shape stays in L2); K1's projection
   GEMMs and attention pass
   each against its own bound (``torch.profiler``), and K2 (the fp32
   light forward) against its plain version and stock fp32 PyTorch;
9. holds the attention block's training forward (K3) against its plain
   version at [8, 512, 768] in bf16 and fp32 (output, qkv, context,
   softmax statistics), and checks the light forward (K1) returns K3's
   output bitwise, with attention dropout 0 and 0.1; the flash
   backward's (K8's) recomputed row max and denominator on views of
   K3's qkv must equal K3's saved ones bit for bit (bf16: the tensor-core
   kernels; fp32: the CUDA-core delta pass against the fp32 forward);
10. holds its backward (K4) against the plain backward on the same saved
   tensors (dx, dW, db), dropout 0 and 0.1 — at 0.1 the plain version
   gets the mask the kernels' Philox code writes, which must equal the
   plain Philox bit for bit; K4's ``do`` must equal the plain ``do`` bit
   for bit in bf16, and its delta and ds scratch are held against their
   plain versions fed K4's own ``do``;
11. holds the fused LN backward (K6) against its plain version, dropout
   0 and 0.1 (the mask from Triton's ``tl.rand``), and K5's and K6's masks
   against Triton's bit for bit at [49152, 768] for seeds 0, 1, 2^31 - 2
   and one the training step draws (K5's output against its plain version
   fed that mask, under the bf16 gate; K6's dx is zero exactly where the
   mask drops), with the plain ``tl_rand`` against Triton's uniform floats;
12. checks the keep rate of every dropout site at the training shape
   (0.9 ± 1e-3; the fused LN's read from K5's own output too, which must
   equal Triton's mask) and that a seed gives the same mask twice;
13. runs the train step (hidden 768, 12 heads, FFN 2048, 12 layers,
   L 512): 3 steps at B=8, dropout 0, on the kernel path against the
   plain path from the same weights and batches (loss and grad_norm per
   step), then bench.py's workload — B=96, bf16, dropout 0.1, AdamW at
   7e-5 — on the kernel path, 3 warm-up and 5 timed steps, with the
   launch counters read over the timed steps (per step: K3 12, K4 12,
   K5 24, K6 24, K1 0); then times K3, K4 and K6 at that shape against
   their plain versions and the library calls (K3 and K6 also at dropout
   0, K3's two parts against their bounds, K6's bound with its bytes,
   fp32 and integer terms), checks that two K6 calls give the same bits
   and holds each against
   its plain version there (K4 on K3's saved tensors, dropout 0.1 with
   the kernels' mask), as phases 9-11 do at B=8, K8's statistics bitwise
   K3's there too, and splits K4 into its projections and its delta,
   dk/dv and dq kernels (``torch.profiler``), each CUDA-core part beside
   the products it forms at the fp32 rate. The B=8 comparison also
   runs the per-head flash path (``attention_impl: pallas``) against the
   plain path;
14. holds the per-head flash attention kernels (K7 forward, K8 backward)
   against their plain versions at [8, 512, 12, 64] in bf16 and fp32 —
   padded rows, packed segments, dropout 0 and 0.1 (the kernels' mask,
   bit for bit the plain Philox), views of one fused projection — at
   L = 200, at head_dim 128 ([8, 200, 6, 128]), and at the training shape
   [96, 512, 12, 64]; holds the copy anchor (K9) bitwise against its
   plain version, also on a ragged count and an unaligned view; times
   K7, K8 and K9 against their plain versions and one library call each
   (K7 also at dropout 0), and splits K8 into its
   dq and dk/dv kernels;
15. runs the 12-layer encoder on the flash path against the plain path
   and the block path (in phase 4), and serves 8 HTTP requests from a
   server started with an ``attention_impl: pallas`` config: 12 K7 and
   24 K5 launches a forward, no block launch;
16. the packed run: ``pl_bert_tpu_torch.training.train.train()`` through
   its normal entry on ``synthetic:4096`` — flagship model,
   ``attention_impl: pallas``, on-device masking and sequence packing,
   B=96, bf16, dropout 0.1 — 8 steps with a checkpoint every 4, then
   the same call again with ``num_steps`` 12, which resumes from
   ``step_8.pth``; checks the losses, the packing line, the launch
   counters (12 K7, 12 K8, 24 K5, 24 K6 a training step, 12 K7 and 24 K5
   a validation forward, no block launch), the three checkpoints, and
   that ``step_12.pth`` loads strictly into a fresh model;
17. runs the fused-LN microbench (``tools/bench_fused_ln.py``: the copy
   anchor, K5, K5+K6 and the plain version over a 24-call chain at
   [49152, 768]) and prints its table;
18. the multi-task model (the 60,000-word grapheme head):
   a. at the production shape (B=96, L=512, bf16, capacity 144) holds
      ``masked_lm_loss_fused``'s value bit for bit to
      ``masked_lm_loss_chunked``'s and its gradients to theirs (rel-L2
      1e-2), and the gathered loss to the full-length one (rel 1e-5);
      times the fused, the chunked and the full-length head forward and
      backward, and splits the fused one into its parts;
   b. runs the multi-task train step at B=8 (head of 60,000, capacity
      set so one batch gathers and two fall back) on the block path
      (K3, K4, K5, K6) and the flash path (K7, K8, K5, K6) against the
      plain path within phase 13's gates;
   c. runs bench.py's production configuration through
      ``training.train.train()``: packed short samples with grapheme ids,
      masked on the device, ``attention_impl: pallas``, the fused head at
      capacity 144, gradient accumulation 2 of B=96, bf16, dropout 0.1,
      6 steps; prints ms a step, real tokens/s, occupancy, peak memory,
      the gather's fallbacks and the validation's ``val_token_*``; checks
      the launch counters (the ``multitask`` path of the kernels line);
      then ``training/evaluate.py`` on its ``step_6.pth`` (the run's own
      validation numbers) and ``training/profile.py --multitask`` (the
      step by group, the head by part, the capacity read's cost);
19. the production run from a packed store (the data plane at scale):
   a. writes 18 c's corpus as a ``records.jsonl`` dataset and packs it with
      ``python -m pl_bert_tpu_torch.preprocess.pipeline --stage pack`` in
      a subprocess (one shard of ``packed_rows`` with tokens); the stage's
      route counter must show the native packer; the store's batches (train
      epochs 0 and 1, the validation snapshot) must equal, bit for bit,
      those of the in-RAM ``PackedSequenceDataset`` 18 c trained from;
   b. ``python -m pl_bert_tpu_torch.data.verify_store`` passes the store
      and fails a copy with one shard file cut short;
   c. ``training.train.train()`` on the store, 6 steps of 18 c's
      configuration: its launch counters must equal 18 c's and its losses
      18 c's within phase 13's loss gate (it prints whether bitwise);
   d. ``python -m pl_bert_tpu_torch.training.orchestrate --max_restarts 2
      --restart_delay 0`` on the store with ``save_interval`` 3 and
      ``PLBERT_CRASH_AT_STEP=4``: the first child exits 17 after
      ``step_3.pth``, the second resumes and ends at ``step_6.pth``, the
      launcher exits 0 with a restart count of 1, steps 1-6 match c's
      losses under the same gate, and ``step_6.pth`` loads strictly into a
      fresh ``MultiTaskModel``;
   e. bench.py's store feed (``run_store_feed``) on the port: 50,000
      samples of 40-120 words packed as rows, 400 shuffled batches of
      96 × 512 after a 20-batch warm-up; prints the store's bytes, its open
      time, rows/s and tokens/s and the VmRSS growth over the read pass,
      and fails unless the feed meets the production step's demand (2 × 96
      rows at 18 c's ms a step) and the growth stays under a quarter of the
      store's bytes. Nothing of it imports ``datasets`` or ``transformers``;
20. the deployment path:
   a. ``python -m pl_bert_tpu_torch.export.cli`` in a subprocess on 18 c's
      ``step_6.pth`` (the multi-task model): the HF directory, with
      ``token_predictor`` in ``pl_bert_full_model.pt``;
   b. ``PhonemeEncoder.from_hf_export`` on it gives the hidden states of
      ``from_checkpoint(step_6.pth)`` bit for bit at B=8, L=512;
   c. the same checkpoint exported for the block path (``attention_impl:
      auto``) and served in int8 at B=8, L=512: each of the forward's 26
      int8 sites (the embedding mapping, the FFN's two layers a layer
      application, the pooler; K1 keeps its bf16 weights) gives
      ``torch._int_mm`` accumulators equal to the fp64 product's bit for
      bit; the int8 encoder is held to its plain version (the eager path
      on the same weight set) under ``INT8_ENCODER_TOL``, and to the bf16
      encoder by per-token cosine (≥ 0.99);
   d. the server started through its entry with ``--hf_dir DIR --int8``
      answers 16 requests of 5-500 phonemes from 4 client threads through
      the port's ``ServingClient``, each bit for bit a direct int8 call;
      the launch counters show K1 12, K5 24 and 26 ``_int_mm`` a forward
      and nothing else; ``/reload`` to a second export changes the
      answers to a direct call's on its weights;
   e. times the int8 forward against the bf16 one at B=8 and B=64, and
      one FFN layer's int8 dense by part (quantize pass, ``_int_mm``,
      rescale) against ``F.linear`` in bf16;
21. remat: bench.py's workload (B=96, L=512, bf16, dropout 0.1, block
   path), 3 warm-up and 5 timed steps with ``remat`` off and on from the
   same weights, batches and seeds: losses and grad norms within phase
   13's gates (it prints whether bitwise), launches a step with remat K3
   24, K4 12, K5 48, K6 24, peak device memory and ms a step of both; then
   2 steps on the flash path with remat (K7 24 a step) against 2 without;
22. the sharded step (``parallel/``):
   a. K1/K3 writing a tensor-parallel shard's fp32 partial output at
      [8, 512, 768] with 6 heads of 64 (P = 384), bf16, dropout 0 and
      0.1, against their plain versions (K1 bitwise K3, and K3's fp32
      output rounding to its bf16 one bit for bit); K4 from K3's saved
      tensors; K3 at P = 192 (3 heads); K7/K8 on a rank's 6 heads
      ([8, 512, 6, 64]) and K5/K6 on its rows under SP ([2048, 768]), with
      rank 1's shard seeds, dropout 0 and 0.1, then each timed at dropout
      0.1 with CUDA events beside its plain version, its library call (SDPA
      with the mask and dropout; ``F.dropout`` + add + ``F.layer_norm``;
      each's backward) and its bound; K1/K3/K4 each timed at P =
      384 beside its plain version, a library call and its bound; the
      FFN's row-parallel layer (one bf16 GEMM writing fp32) at M = 4096
      and 49152 against the fp32 GEMM and its bound;
   b. the Trainer in a NCCL world of one (``PLBERT_DISTRIBUTED=1``) on
      bench.py's workload (B 96, L 512, bf16, dropout 0.1, block path), 4
      steps, against the run without: losses within phase 13's gates, ms
      a step of both;
   c. two ranks on the one card over gloo (``PLBERT_DIST_BACKEND=gloo``:
      NCCL refuses two ranks on one device), each a process running
      ``training.train.train()`` at the flagship width, L 512, global
      batch 8, bf16, dropout 0, 4 steps: data 2, data 2 with zero1, model
      2 on the block path, with SP, and on the flash path, each within
      phase 13's gates of one rank on the same weights and batches (zero1
      also against data 2, printed whether bitwise); each rank's launches
      (K3 12, K4 12, K5 24, K6 24 a step on the block path; K7 12, K8 12
      on the flash path), local heads, ms a step, peak memory and the
      replicated parameters bitwise equal across the model ranks; the
      one-rank runs' ms a step, timed alike (each step between two
      synchronisations), beside them;
   d. the multi-task model at model 2, its head of 60,000 split over the
      vocabulary (fused, capacity 144, dropout 0, 4 steps, global batch
      8), within phase 13's gates of a one-rank run of the same config:
      each rank holds at most 30,000 rows of the head and of its moments,
      the head gathered whole is bitwise equal on both ranks, the
      replicated parameters too; each rank's peak memory beside the
      prediction, the head's collectives a step and their cost over gloo;
23. from raw Arabic text to a production-shape training run: a seeded
   corpus (10,000 lines of about 20 words from a generated lexicon of
   80,000 Arabic words, with digits, dates and punctuation) through the
   port's pipeline CLI in subprocesses — clean (4 shards, 4 workers),
   diacritize (no CATT checkout: the identity fall-back, then phonemize
   with ``g2p_backend: espeak`` through ``tests/espeak_stub/espeak_stub.c``,
   built with the host compiler), tokenize (the 60,000-word cap) and
   pack — then ``data.verify_store`` on the store and 4 steps of
   bench.py's production shape from it, the head the tokenizer's
   vocabulary: ms a step, real tokens/s, peak memory, finite losses, and
   K5-K8 launched as the production path predicts.

Any failure raises and exits non-zero. The line before the last is a
JSON record of the kernels (its ``launches_by_path`` also counts them on
the deployment and the remat path, and on rank 0 of 22 c's model 2 + SP
run); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"  # cuda:0 — the one card this script needs

# tolerances, kernel against plain version on the same inputs:
# fp32 — the same arithmetic in another summation order (768/2048-deep
#   dot products, 512-key softmax sums): ~1e-6 relative;
# bf16 — both round q/k/v, the normalised probabilities, context and
#   outputs to bf16 at the same points, but after differently ordered fp32
#   sums, so a value near a rounding boundary lands one bf16 ulp (2^-8
#   relative; 1.6e-2 at the LN's outputs of magnitude ~4) apart. Few do:
#   rel-L2 ~3e-4 for the block (its tensor-core projections round ~1.6e-4
#   of qkv one ulp from the fp32 plain GEMM's, and the flips carry into
#   the probabilities), ~2e-5 for the LN on the card.
TOL = {
    "float32": {"max_abs": 1e-3, "rel_l2": 1e-5},
    "bfloat16": {"max_abs": 5e-2, "rel_l2": 1e-3},
}
# fp32 weight and bias gradients contracted over B·L = 4096 (or 49152)
# rows from the kernels' and the plain versions' compute-dtype dqkv (or
# ctx): sums of thousands of terms, each of which may carry a one-ulp bf16
# flip (the card read max-abs 1.4e-2 for dWo in bf16 at 4096 rows, 5.0e-3
# at 49152 on phase 13's inputs)
TOL_GRAD = {
    "float32": TOL["float32"],
    "bfloat16": {"max_abs": 1e-1, "rel_l2": 1e-3},
}
# the 12-layer encoder, kernel path against plain path (valid positions):
# each one-ulp flip feeds the next layer's bf16 roundings, so over 12
# layers the hidden states drift to about one bf16 ulp apart (rel-L2
# ~4e-3 on the card)
ENCODER_TOL = {
    "float32": {"max_abs": 1e-2, "rel_l2": 1e-4},
    "bfloat16": {"max_abs": 2e-1, "rel_l2": 1.5e-2},
}
# the train step, kernel path against plain path (3 steps, B=8, bf16,
# dropout 0, same weights and batches): loss and grad_norm relative
# differences per step. Both paths round to bf16 at the same points but
# sum in other orders, and the flips grow through 12 layers and 3
# updates; the card read at most 4.2e-5 (loss) and 3.1e-4 (grad_norm)
# (NVIDIA H100 80GB HBM3, 700 W), and the gates sit about 10x above.
TRAIN_TOL = {"loss": 5e-4, "grad_norm": 5e-3}
# dropout sites' keep rate at the training shape (0.9 ± 1e-3)
KEEP_TOL = 1e-3
# the H100's peak rates (NVIDIA's data sheet, SXM, dense) for the bounds
PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_INT8_OPS = 1979e12
# 32-bit integer results a clock an SM at compute capability 9.0, for
# multiply-adds (IMAD, IMAD.HI, IMAD.WIDE) and for logic ops (LOP3) alike,
# on two pipes (CUDA C++ Programming Guide, "Arithmetic Instructions",
# throughput table); times the SMs and the card's max SM clock
# (nvidia-smi clocks.max.sm) for the integer term of K5's and K6's bounds
INT_OPS_PER_SM_CLOCK = 64
# K5's and K6's element draws a row per lane at H = 768: three slices of 8
DRAWS_PER_LANE_ROW = 24
SEED = 0
BUCKETS = (64, 128, 256)
# name → (route, source, TPU kernel replaced, the path whose run counts it)
KERNELS = {
    "attention_block": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                        "pl_bert_tpu/ops/attention_block.py:253", "serving"),
    "dropout_add_layernorm": ("cuda", "pl_bert_tpu_torch/csrc/fused_ln.cu",
                              "pl_bert_tpu/ops/fused_ln.py:72", "serving"),
    "attention_block_train": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                              "pl_bert_tpu/ops/attention_block.py:116", "training"),
    "attention_block_bwd": ("cuda", "pl_bert_tpu_torch/csrc/attention_block.cu",
                            "pl_bert_tpu/ops/attention_block.py:315", "training"),
    "dropout_add_layernorm_bwd": ("cuda", "pl_bert_tpu_torch/csrc/fused_ln.cu",
                                  "pl_bert_tpu/ops/fused_ln.py:88", "training"),
    "flash_attention": ("cuda", "pl_bert_tpu_torch/csrc/flash_attention.cu",
                        "pl_bert_tpu/ops/flash_attention.py:47", "packed_run"),
    "flash_attention_bwd": ("cuda", "pl_bert_tpu_torch/csrc/flash_attention.cu",
                            "pl_bert_tpu/ops/flash_attention.py:73", "packed_run"),
    "add_copy": ("cuda", "pl_bert_tpu_torch/csrc/fused_ln.cu",
                 "tools/bench_fused_ln.py:110", "microbench"),
}
# the config of the packed run (phase 16), at the flagship width of
# configs/config.yml; {out} and {steps} are filled in
RUN_CONFIG = """\
training_params:
  output_dir: {out}
  mixed_precision: bf16
  batch_size: 96
  save_interval: 4
  log_interval: 1
  num_steps: {steps}
  learning_rate: 7.0e-5
  training_dataset: "synthetic:4096"
dataset_params:
  max_seq_length: 512
  ondevice_masking: true
  sequence_packing: true
model_params:
  hidden_size: 768
  num_attention_heads: 12
  intermediate_size: 2048
  max_position_embeddings: 512
  num_hidden_layers: 12
  dropout: 0.1
  attention_impl: pallas
"""
# the grapheme head, fused against chunked (phase 18 a), bf16 at the
# production shape: both take the same bf16 logits and form softmax −
# onehot in fp32, but the fused path sums dW and db over all rows in fp32
# while the chunked path's autograd rounds each chunk's product to bf16
# and sums the chunks in bf16, and their fp32 cotangents differ in the
# order of one product: a bf16 ulp (2^-8) or so apart
HEAD_GRAD_TOL = {"rel_l2": 1e-2, "max_abs_rel": 5e-2}
# the gathered loss against the full-length loss: the same positions'
# losses summed per sample in another order (fp32)
GATHER_TOL = 1e-5
# the production run (phase 18 c): bench.py::run_production's
# configuration at the flagship width; {out}, {steps}, {save} and
# {dataset} are filled in (phase 19 trains on the packed store of the
# corpus that 18 c's spec makes)
MT_CONFIG = """\
training_params:
  output_dir: {out}
  mixed_precision: bf16
  batch_size: 96
  grad_accum_steps: 2
  fused_lm_head: true
  lm_head_capacity: 144
  save_interval: {save}
  log_interval: 1
  num_steps: {steps}
  learning_rate: 7.0e-5
  training_dataset: "{dataset}"
dataset_params:
  max_seq_length: 512
  ondevice_masking: true
  sequence_packing: true
model_params:
  hidden_size: 768
  num_attention_heads: 12
  intermediate_size: 2048
  max_position_embeddings: 512
  num_hidden_layers: 12
  dropout: 0.1
  attention_impl: pallas
  num_token_vocab: 60000
"""
MT_STEPS = 6
MT_DATASET = "synthetic:6000:0:8-30"
# the store feed (phase 19 e): bench.py::run_store_feed's own settings
FEED_SAMPLES, FEED_BATCHES, FEED_WARMUP = 50_000, 400, 20
# the int8 encoder on the block path against its plain version (phase
# 20 c), bf16, valid positions. Its int8 sites are bitwise their plain
# version (20 c checks each), so the two differ where K1 and K5 round a
# value one bf16 ulp away from the plain version, as in phase 4 (~4e-3
# rel-L2 over 12 layers on the card). A flip in front of a quantizer
# crosses one of its rounding boundaries with a chance of about ulp/step
# and then moves the value by a whole step; a step (the row's abs-max /
# 127) is about 10 ulps of a typical element (|x| ~ abs-max / 4, an ulp
# |x|·2^-8), so the squared change a flip makes grows about 10x and the
# drift about √10 ≈ 3.2x: phase 4's bf16 gate times 3.2, rounded up
INT8_ENCODER_TOL = {"max_abs": 6.4e-1, "rel_l2": 5e-2}
# int8 against bf16, per valid token: JAX's gate (tests/test_quant.py)
INT8_COSINE = 0.99
DEPLOY_REQUESTS, DEPLOY_CLIENTS = 16, 4
MAX_BATCH = 8
N_CLIENTS, PER_CLIENT = 4, 8


def log(msg: str) -> None:
    print(msg, flush=True)


class Tee(io.StringIO):
    """Captures what is printed while passing it on to the real stdout."""

    def write(self, text):
        sys.__stdout__.write(text)
        sys.__stdout__.flush()
        return super().write(text)


def max_sm_clock_mhz() -> float:
    """The card's max SM clock, MHz (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return float(out.splitlines()[0])


def all_counters() -> tuple:
    """Every kernel wrapper's launch counter, in ``KERNELS``' order."""
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import flash_attention as fa
    from pl_bert_tpu_torch.ops import fused_ln

    return (ab.LAUNCHES, fused_ln.LAUNCHES, ab.LAUNCHES_TRAIN, ab.LAUNCHES_BWD,
            fused_ln.LAUNCHES_BWD, fa.LAUNCHES, fa.LAUNCHES_BWD, fused_ln.LAUNCHES_COPY)


def reset_counters() -> tuple:
    counters = all_counters()
    for c in counters:
        c.reset()
    return counters


def read_counters(counters) -> dict:
    return {c.name: c.count for c in counters}


def errors(out, ref) -> dict:
    o, r = out.float(), ref.float()
    return {
        "max_abs": float((o - r).abs().max()),
        "rel_l2": float((o - r).norm() / r.norm().clamp_min(1e-30)),
    }


def gate(name: str, err: dict, tol: dict) -> None:
    ok = err["max_abs"] <= tol["max_abs"] and err["rel_l2"] <= tol["rel_l2"]
    log(f"  {name}: max_abs {err['max_abs']:.3e} rel_l2 {err['rel_l2']:.3e} "
        f"(tol {tol['max_abs']:.1e}/{tol['rel_l2']:.1e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside tolerance: {err} vs {tol}")


def hold(results: dict, kernel: str, label: str, out, ref, tol: dict) -> None:
    """Gate a kernel's output against its plain version's and keep the
    error for the kernels line."""
    if not out.isfinite().all():
        raise AssertionError(f"{label}: non-finite")
    err = errors(out, ref)
    results[kernel].append(err["max_abs"])
    gate(label, err, tol)


def hold_ulp(results: dict, kernel: str, label: str, out, ref, tol: dict) -> None:
    """``hold`` for a bf16 output whose plain version may round it one ulp
    the other way at any magnitude (K4's dx and dqkv, each one rounding of
    differently ordered fp32 sums): every element within ``tol``'s
    max_abs or one bf16 ulp of the reference (2^-7 of its magnitude),
    whichever is larger, and rel-L2 within ``tol``'s."""
    if not out.isfinite().all():
        raise AssertionError(f"{label}: non-finite")
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    err = errors(out, ref)
    results[kernel].append(err["max_abs"])
    ulp = r.abs() * 2.0**-7
    beyond = diff > tol["max_abs"]
    ulps = float((diff[beyond] / ulp[beyond]).max()) if beyond.any() else 0.0
    ok = bool((diff <= ulp.clamp_min(tol["max_abs"])).all()) and err["rel_l2"] <= tol["rel_l2"]
    log(f"  {label}: max_abs {err['max_abs']:.3e} rel_l2 {err['rel_l2']:.3e} (tol "
        f"{tol['max_abs']:.1e} or one bf16 ulp / {tol['rel_l2']:.1e}; {int(beyond.sum())} "
        f"elements past {tol['max_abs']:.1e}, the largest {ulps:.2f} ulp of its value) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} outside tolerance: {err} vs {tol} or one ulp")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Time per call over ``iters`` back-to-back calls (CUDA events).
    Where the host launches slower than the device runs, this is the
    host's launch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed and timed with CUDA events, so host launch cost is out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    ms = time_ms(torch, graph.replay, 5, warmup=1) / iters
    del graph
    return ms


def a_b(torch, plain, kernel, iters: int, timer=time_ms) -> tuple[float, float]:
    """Plain, kernel, kernel, plain on the same card; mean of each pair."""
    p1 = timer(torch, plain, iters)
    k1 = timer(torch, kernel, iters)
    k2 = timer(torch, kernel, iters)
    p2 = timer(torch, plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def random_state_dict(torch, cfg, seed: int) -> dict:
    """Encoder weights at the config's width from a numpy seed: matrices
    and embeddings N(0, initializer_range), biases N(0, 0.02), LayerNorm
    gamma 1 + N(0, 0.1) and beta N(0, 0.1)."""
    import numpy as np

    from pl_bert_tpu_torch.models.albert import AlbertModel

    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in AlbertModel(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        noise = rng.standard_normal(shape, dtype=np.float32)
        if "LayerNorm" in k or "layer_norm" in k:
            arr = 1.0 + 0.1 * noise if k.endswith("weight") else 0.1 * noise
        elif k.endswith("bias"):
            arr = 0.02 * noise
        else:
            arr = cfg.initializer_range * noise
        sd[k] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return sd


def phoneme_text(rng, n: int) -> str:
    letters = "abdfhiklmnqrstuwzθðʃʕħɣχːˈ"
    words = []
    while sum(len(w) + 1 for w in words) < n:
        words.append("".join(rng.choice(list(letters), size=int(rng.integers(2, 9)))))
    return " ".join(words)[:n]


def http_json(conn, method: str, path: str, payload: dict | None = None) -> dict:
    """One request on an open ``http.client`` connection; the JSON answer,
    or an AssertionError for any status but 200."""
    body = None if payload is None else json.dumps(payload).encode()
    headers = {} if body is None else {"Content-Type": "application/json"}
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise AssertionError(f"{method} {path}: HTTP {resp.status} {data[:300]!r}")
    return json.loads(data)


def encode_b64(conn, text: str):
    """POST /encode with the binary payload → (hidden [n, H] fp32, n)."""
    import numpy as np

    r = http_json(conn, "POST", "/encode",
                  {"phonemes": text, "encoding": "b64", "dtype": "float32"})
    hidden = np.frombuffer(base64.b64decode(r["hidden_b64"]), dtype=r["dtype"])
    return hidden.reshape(r["shape"]), int(r["length"])


def phase_tensor_cores(build) -> None:
    """2. the bf16 kernels that run on the tensor cores (the block's and
    the flash path's forward, the block backward's dx projection, the flash
    backward) have HGMMA (wgmma) instructions in their SASS; and what
    ptxas said of their registers, shared memory and spills."""
    import re

    def label(mangled: str) -> str:  # gemm_bias_sm90<1>, attention_bwd_dq_sm90<64, 1>, ...
        found = re.search(r"(gemm_bias_sm90|attention_\w+?_sm90)((?:I?L[ib]\d+E)*)", mangled)
        args = re.findall(r"L[ib](\d+)E", found.group(2))
        return found.group(1) + (f"<{', '.join(args)}>" if args else "")

    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    for lib in ("attention_block", "flash_attention"):
        sass = subprocess.run([cuobjdump, "-sass", str(build.build(lib))], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts, func = {}, None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                func = found.group(1)
                counts[func] = {"HGMMA": 0, "HMMA": 0}
            elif func and "HGMMA" in line:
                counts[func]["HGMMA"] += 1
            elif func and "HMMA" in line:
                counts[func]["HMMA"] += 1
        # the bf16 forward of both paths, K4's dx projection and K8 run wgmma
        kernels = (["attention_fwd_sm90", "gemm_bias_sm90"] if lib == "attention_block" else
                   ["attention_fwd_sm90", "attention_bwd_dq_sm90", "attention_bwd_dkdv_sm90"])
        for key in kernels:
            names = [f for f in counts if key in f]
            for f in names:
                log(f"  {lib}: {label(f)}: {counts[f]['HGMMA']} HGMMA, {counts[f]['HMMA']} HMMA")
            if not names or any(not counts[f]["HGMMA"] for f in names):
                raise AssertionError(f"{lib}: {key} has no wgmma (HGMMA) instructions")
        func = None
        for line in build.ptxas_report(lib).splitlines():
            found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
            if found:
                func = found.group(1)
            elif func and "sm90" in func and ("Used" in line or "spill" in line):
                log(f"  ptxas {lib}: {label(func)}: {line.split(':', 1)[-1].strip()}")


def ln_label(mangled: str) -> str:
    """ln_fwd<bf16, 3, 1> or ln_bwd<f32, 3, 0> (dtype, slices, dropout),
    add_copy<f32> or ln_bwd_reduce from a mangled name of csrc/fused_ln.cu."""
    import re

    found = re.search(r"\d(ln_bwd_reduce|ln_fwd|ln_bwd|add_copy)[EI]", mangled)
    if not found:
        return mangled
    name = found.group(1)
    if name == "ln_bwd_reduce":
        return name
    args = ["bf16" if "__nv_bfloat16" in mangled else "f32"]
    if name in ("ln_fwd", "ln_bwd"):
        args += re.findall(r"Li(\d+)E", mangled)[:1] + re.findall(r"Lb([01])E", mangled)[:1]
    return f"{name}<{', '.join(args)}>"


def phase_fused_ln_build(build) -> dict:
    """2. the fused LN library (K5, K6, K9): what ptxas said of each
    kernel's registers, shared memory and spills (K5 and K6 at the
    flagship's three slices a lane, H = 768, and at their widest, eight
    slices, H = 2048, where K6's partials live in shared memory); and the
    integer instructions one Philox draw of K5 and of K6 issues, from the
    SASS: IMAD (with IMAD.HI, IMAD.WIDE) and LOP3 in the bf16 H = 768
    kernel with dropout, less the one without, over the 24 draws a lane
    makes a row.
    → {"ln_fwd": {"imad": .., "lop3": ..}, "ln_bwd": {...}} a draw."""
    import re

    func = None
    for line in build.ptxas_report("fused_ln").splitlines():
        found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if found:
            func = found.group(1)
        elif func and ("Used" in line or "spill" in line):
            name = ln_label(func)
            if (not name.startswith("ln_") or name == "ln_bwd_reduce" or ", 3, " in name
                    or ", 8, " in name):
                log(f"  ptxas fused_ln: {name}: {line.split(':', 1)[-1].strip()}")
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.build("fused_ln"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            func = found.group(1)
            counts[func] = {"imad": 0, "lop3": 0}
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if func and op:
            if op.group(1) == "IMAD":
                counts[func]["imad"] += 1
            elif op.group(1) == "LOP3":
                counts[func]["lop3"] += 1
    labelled = {ln_label(f): c for f, c in counts.items()}
    per_draw = {}
    for kernel in ("ln_fwd", "ln_bwd"):
        with_, without = (labelled.get(f"{kernel}<bf16, 3, {d}>") for d in (1, 0))
        if with_ is None or without is None:
            raise AssertionError(f"fused_ln: no bf16 H=768 {kernel} pair in the SASS: "
                                 f"{sorted(labelled)}")
        per_draw[kernel] = {k: (with_[k] - without[k]) / DRAWS_PER_LANE_ROW
                            for k in ("imad", "lop3")}
        log(f"  SASS {kernel}<bf16, 3>: with dropout {with_}, without {without}: "
            f"{per_draw[kernel]['imad']:.2f} IMAD and {per_draw[kernel]['lop3']:.2f} LOP3 "
            f"a Philox draw")
        if per_draw[kernel]["imad"] <= 0:
            raise AssertionError(f"fused_ln: {kernel} with dropout issues no more IMAD than "
                                 f"without")
    return per_draw


def phase_kernels(torch, cfg, results: dict) -> None:
    """3. each kernel against its plain version on the card."""
    import numpy as np

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln

    log("phase 3: kernels against their plain versions")
    rng = np.random.default_rng(SEED + 1)
    E, H, dev = cfg.hidden_size, cfg.num_attention_heads, DEV
    w = {n: torch.from_numpy(rng.standard_normal((E, E), dtype=np.float32) * 0.05)
         for n in "qkvo"}
    b = {n: torch.from_numpy(rng.standard_normal(E, dtype=np.float32) * 0.02)
         for n in "qkvo"}
    cases = [  # (name, B, L, valid lengths per row, segments, heads)
        ("L512", 8, 512, [512, 480, 384, 256, 128, 64, 5, 0], False, H),
        ("L64", 8, 64, [64, 63, 50, 33, 17, 8, 1, 0], False, H),
        ("L200_seg", 8, 200, [200, 199, 150, 101, 100, 64, 3, 0], True, H),
        # head_dim 128, which the block takes too
        ("L200_seg_d128", 8, 200, [200, 199, 150, 101, 100, 64, 3, 0], True, E // 128),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        packed = ab.pack_weights(
            *(t.to(dev) for n in "qkvo" for t in (w[n], b[n])), dtype
        )
        for name, B, L, lengths, segments, heads in cases:
            x = torch.from_numpy(rng.standard_normal((B, L, E), dtype=np.float32) * 0.5)
            mask = torch.from_numpy(
                (np.arange(L)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
            )
            seg = None
            if segments:
                seg = torch.from_numpy(
                    (np.arange(L)[None, :] >= np.asarray(lengths)[:, None] // 2)
                    .astype(np.int32)
                ).to(dev)
            x = x.to(dev, dtype)
            bias = attention_bias_from_mask(mask.to(dev))
            out = ab.attention_block_packed(x, *packed, heads, bias=bias, segment_ids=seg)
            ref = ab.attention_block_plain(x, *packed, heads, bias=bias, segment_ids=seg)
            torch.cuda.synchronize()
            if out.shape != (B, L, E) or out.dtype != dtype:
                raise AssertionError(f"attention_block {name}: {out.shape} {out.dtype}")
            if not torch.isfinite(out).all():
                raise AssertionError(f"attention_block {name} {dname}: non-finite output")
            err = errors(out, ref)
            results["attention_block"].append(err["max_abs"])
            gate(f"attention_block {name} {dname}", err, TOL[dname])

        N = 8 * 512
        xs = [torch.from_numpy(rng.standard_normal((N, E), dtype=np.float32)).to(dev, dtype)
              for _ in range(2)]
        gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(E, dtype=np.float32)).to(dev)
        beta = torch.from_numpy(0.1 * rng.standard_normal(E, dtype=np.float32)).to(dev)
        # with dropout the plain version gets Triton's own tl.rand mask
        for rate, seed in ((0.0, None), (0.1, 4321)):
            keep = fused_ln.dropout_mask((N, E), seed, rate, dev) if rate else None
            out = fused_ln.dropout_add_layernorm(xs[0], xs[1], gamma, beta, seed, rate)
            ref = fused_ln.dropout_add_layernorm_plain(xs[0], xs[1], gamma, beta, seed, rate,
                                                       keep=keep)
            torch.cuda.synchronize()
            if out.dtype != dtype:
                raise AssertionError(f"dropout_add_layernorm {dname}: {out.dtype} output")
            hold(results, "dropout_add_layernorm",
                 f"dropout_add_layernorm [{N}, {E}] {dname} dropout {rate}", out, ref, TOL[dname])

    # dropout inside the LN kernel (the training slice's path): with
    # x = 1 and residual = 0 a row holds two values, kept 1/(1-rate) and
    # dropped 0; after normalisation the dropped ones are the negative ones
    rate = 0.25
    ones = torch.ones(N, E, device=dev)
    y = fused_ln.dropout_add_layernorm(
        ones, torch.zeros_like(ones), torch.ones(E, device=dev),
        torch.zeros(E, device=dev), seed=1234, rate=rate,
    )
    dropped = float((y < 0).float().mean())
    same = fused_ln.dropout_add_layernorm(
        ones, torch.zeros_like(ones), torch.ones(E, device=dev),
        torch.zeros(E, device=dev), seed=1234, rate=rate,
    )
    log(f"  dropout_add_layernorm dropout: rate {rate} dropped {dropped:.4f}, "
        f"same seed same mask {bool(torch.equal(y, same))}")
    if abs(dropped - rate) > 0.01 or not torch.equal(y, same):
        raise AssertionError("dropout_add_layernorm: dropout mask is off")


def phase_encoder(torch, cfg, sd) -> dict:
    """4. the full encoder forward on the kernel path against the plain path."""
    import numpy as np

    from pl_bert_tpu_torch.models.inference import PhonemeEncoder

    log(f"phase 4: {cfg.num_hidden_layers}-layer encoder, kernel path against "
        f"plain path, B={MAX_BATCH} L={cfg.max_position_embeddings}")
    rng = np.random.default_rng(SEED + 2)
    texts = [phoneme_text(rng, n) for n in (512, 500, 384, 256, 128, 64, 5)]
    encoders = {}
    for mp in ("bf16", "fp32"):
        for impl in ("auto", "eager", "pallas"):
            params = dataclasses.replace(cfg, attention_impl=impl)
            encoders[mp, impl] = PhonemeEncoder(
                sd, params, cfg.max_position_embeddings, mixed_precision=mp,
                batch_size=MAX_BATCH, device=DEV,
            )
        enc, plain = encoders[mp, "auto"], encoders[mp, "eager"]
        ids, mask, lengths = enc.encode_batch(texts)
        out = enc.forward(ids, mask)
        ref = plain.forward(ids, mask)
        torch.cuda.synchronize()
        dname = str(enc.cfg.dtype).removeprefix("torch.")
        if out.shape != (MAX_BATCH, 512, cfg.hidden_size) or out.dtype != enc.cfg.dtype:
            raise AssertionError(f"encoder output {out.shape} {out.dtype}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"encoder {dname}: non-finite hidden states")
        valid = torch.from_numpy(mask.astype(bool)).to(out.device)
        gate(f"encoder {dname}", errors(out[valid], ref[valid]), ENCODER_TOL[dname])
        # phase 15: the per-head flash path, against the plain and the block path
        flash = encoders[mp, "pallas"].forward(ids, mask)
        torch.cuda.synchronize()
        if flash.shape != out.shape or not torch.isfinite(flash).all():
            raise AssertionError(f"flash-path encoder {dname}: bad hidden states")
        gate(f"encoder {dname}, flash path against plain path",
             errors(flash[valid], ref[valid]), ENCODER_TOL[dname])
        gate(f"encoder {dname}, flash path against block path",
             errors(flash[valid], out[valid]), ENCODER_TOL[dname])
    return encoders


def phase_serve(torch, cfg, sd, workdir: str, impl: str = "auto",
                per_client: int = PER_CLIENT, depth: int = 2) -> tuple[dict, dict]:
    """5-7. serve through the port's entry, check answers and counters.
    ``impl`` "pallas" (phase 15) starts the server with a config that
    asks for the per-head flash path; ``depth`` is its
    ``--pipeline_depth`` (2, the server's default, or 1)."""
    import numpy as np

    from pl_bert_tpu_torch.models.inference import PhonemeEncoder
    from pl_bert_tpu_torch.serving.server import build_server, serve_in_thread

    log(f"phase 5: reference .pth + the port's HTTP server in a thread "
        f"(attention_impl {impl}, pipeline_depth {depth})")
    ckpt = os.path.join(workdir, "step_0.pth")
    torch.save({"net": {f"encoder.{k}": v for k, v in sd.items()}, "step": 0,
                "epoch": 0}, ckpt)
    argv = ["--checkpoint", ckpt, "--port", "0", "--max_batch", str(MAX_BATCH),
            "--buckets", ",".join(map(str, BUCKETS)), "--device", DEV,
            "--pipeline_depth", str(depth)]
    config_path = None
    if impl != "auto":  # the default config is the flagship model on the block path
        config_path = os.path.join(workdir, f"serve_{impl}.yml")
        with open(config_path, "w", encoding="utf-8") as f:
            f.write(f"model_params:\n  attention_impl: {impl}\n")
        argv += ["--config_path", config_path]
    counters = reset_counters()  # the serving path's run starts here
    server = build_server(argv)
    warm = len(BUCKETS) + 1  # build_server warms every bucket and 512
    serve_in_thread(server)
    port = server.server_address[1]
    log(f"  {server.banner}")
    try:
        rng = np.random.default_rng(SEED + 3)
        sizes = [5, 500, *rng.integers(5, 501, N_CLIENTS * per_client - 2)]
        texts = [phoneme_text(rng, int(n)) for n in sizes]
        answers: dict[int, tuple] = {}
        failures: list[BaseException] = []

        def client_loop(c: int) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            try:
                for i in range(c, len(texts), N_CLIENTS):
                    answers[i] = encode_b64(conn, texts[i])
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                failures.append(exc)
            finally:
                conn.close()

        log(f"phase 6: {len(texts)} requests of {min(map(len, texts))}-"
            f"{max(map(len, texts))} phonemes from {N_CLIENTS} client threads")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client_loop, args=(c,)) for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if failures:
            raise failures[0]
        if any(t.is_alive() for t in threads) or len(answers) != len(texts):
            raise AssertionError(f"{len(answers)} of {len(texts)} requests answered")
        probe = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        stats = http_json(probe, "GET", "/stats")
        launches = read_counters(counters)  # the serving path's run ends here
        health = http_json(probe, "GET", "/healthz")
        probe.close()
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
    forwards = warm + stats["batches"]
    stats["wall_s"] = wall
    log(f"  answered {len(answers)} in {wall:.2f} s: {stats['batches']} batches, "
        f"mean batch {stats['mean_batch_size']:.2f}, p50 "
        f"{stats['latency_ms']['p50']:.1f} ms, p95 {stats['latency_ms']['p95']:.1f} ms; "
        f"healthz hidden_size {health['hidden_size']}")

    direct = PhonemeEncoder.from_checkpoint(
        ckpt, config_path, batch_size=MAX_BATCH, seq_buckets=BUCKETS, device=DEV
    )
    worst = 0.0
    for i, text in enumerate(texts):
        hidden, n = answers[i]
        ref, lengths = direct([text])
        if n != int(lengths[0]) or hidden.shape != (n, cfg.hidden_size):
            raise AssertionError(f"request {i}: length {n} vs {lengths[0]}")
        if not np.isfinite(hidden).all():
            raise AssertionError(f"request {i}: non-finite hidden states")
        worst = max(worst, float(np.abs(hidden - ref[0, :n]).max()))
    log(f"  every answer against a direct PhonemeEncoder call: max_abs {worst:.3e}")
    if worst > 2e-2:
        raise AssertionError(f"served answers differ from direct calls by {worst}")

    log(f"phase 7: launch counters over {forwards} forwards "
        f"({warm} warm-up + {stats['batches']} batches): {launches}")
    expect = dict.fromkeys(launches, 0)
    expect["flash_attention" if impl == "pallas" else "attention_block"] = (
        cfg.num_hidden_layers * forwards)
    expect["dropout_add_layernorm"] = 2 * cfg.num_hidden_layers * forwards
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    return launches, stats


def pipeline_probe(torch, enc, texts, rounds: int = 10) -> dict:
    """6. the serving pipeline's stream order on ``enc``: batch N
    dispatched, then N+1, then N fetched. Medians over ``rounds``
    of: how long the second ``dispatch`` held the calling thread; how long
    before the end of N+1's forward (an event recorded right after its
    dispatch) ``fetch(N)`` returned (0: not before; it waited for N+1); and
    the share of rounds in which N+1's forward was still running when it
    did."""
    import statistics

    for _ in range(3):
        enc(texts)
    torch.cuda.synchronize()
    blocked, early, running = [], [], []
    for _ in range(rounds):
        first = enc.dispatch(texts)
        t0 = time.perf_counter()
        second = enc.dispatch(texts)
        t1 = time.perf_counter()
        end = torch.cuda.Event()
        end.record()  # the end of N+1's forward on the compute stream
        enc.fetch(first)
        t2 = time.perf_counter()
        running.append(not end.query())
        end.synchronize()
        t3 = time.perf_counter()
        enc.fetch(second)
        blocked.append((t1 - t0) * 1e3)
        early.append((t3 - t2) * 1e3)
    return {"dispatch_blocked_ms": statistics.median(blocked),
            "fetch_before_next_end_ms": statistics.median(early),
            "fetch_returned_while_next_ran": sum(running) / rounds}


def phase_pipeline(torch, cfg, sd, enc, by_depth: dict) -> dict:
    """6. the pipeline probe on the block-path bf16 encoder at B=8, where
    the host's enqueue of a forward outlasts its kernels, and at B=64,
    where the kernels outlast the enqueue and the stream order shows;
    beside the request latency of phase 6's 32 requests at depth 1 and 2."""
    import numpy as np

    from pl_bert_tpu_torch.models.inference import PhonemeEncoder

    rng = np.random.default_rng(SEED + 8)
    big = PhonemeEncoder(sd, cfg, 512, mixed_precision="bf16", batch_size=64, device=DEV)
    probes = {}
    for B, encoder in ((MAX_BATCH, enc), (64, big)):
        probes[B] = pipeline_probe(torch, encoder, [phoneme_text(rng, 512) for _ in range(B)])
    del big
    lat = {d: (st["latency_ms"]["p50"], st["latency_ms"]["p95"], st["wall_s"])
           for d, st in by_depth.items()}
    for B, probe in probes.items():
        log(f"phase 6: pipeline, B={B} L=512 bf16: the second dispatch held its thread "
            f"{probe['dispatch_blocked_ms']:.3f} ms; fetch(N) returned "
            f"{probe['fetch_before_next_end_ms']:.3f} ms before N+1's forward ended (N+1 still "
            f"running at {probe['fetch_returned_while_next_ran']:.0%} of returns)")
    log("phase 6: request latency over the 32 requests, "
        + "; ".join(f"depth {d}: p50 {p50:.1f} ms, p95 {p95:.1f} ms, all in {w:.2f} s"
                    for d, (p50, p95, w) in sorted(lat.items())))
    return {"probes": probes, "latency": lat}


def phase_timing(torch, cfg, encoders, per_draw: dict, clock_mhz: float) -> dict:
    """8. kernel against plain version, and the encoder forward, timed;
    the library yardsticks and the bounds beside the kernels; K5 at the
    serving and the training shape, dropout 0 and 0.1, beside its library
    call and its bound with the integer term of its draws."""
    import numpy as np

    import torch.nn.functional as F

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln
    from pl_bert_tpu_torch.ops.attention import NEG

    log("phase 8: time per call, bf16, B=8 L=512 — kernels: device time from a "
        "replayed CUDA graph; encoder forward: CUDA events around the serving "
        "call, host-to-device copy of the ids included")
    enc, plain = encoders["bf16", "auto"], encoders["bf16", "eager"]
    w = enc.weights["encoder"]["layer"]
    att = w["attention"]
    rng = np.random.default_rng(SEED + 4)
    B, L, E = MAX_BATCH, 512, cfg.hidden_size
    x = torch.from_numpy(rng.standard_normal((B, L, E), dtype=np.float32)).to(DEV, torch.bfloat16)
    lengths = np.array([512, 480, 384, 256, 128, 64, 5, 0])
    bias = attention_bias_from_mask(
        torch.from_numpy((np.arange(L)[None] < lengths[:, None]).astype(np.int32)).to(DEV)
    )
    args = (x, att["wqkv"], att["bqkv"], att["wo"], att["bo"], cfg.num_attention_heads)
    times = {}
    times["attention_block"] = a_b(
        torch, lambda: ab.attention_block_plain(*args, bias=bias),
        lambda: ab.attention_block_packed(*args, bias=bias), iters=20,
        timer=graph_ms,
    )
    # speed reference only: the same block on library kernels in bf16
    # (cuBLAS tensor-core GEMMs, SDPA), as stock PyTorch would run it; it
    # rounds at other points, so it is not what the kernel is checked against
    H = cfg.num_attention_heads
    stock_bias = bias.clamp(min=NEG).to(torch.bfloat16)
    bqkv16, bo16 = att["bqkv"].to(torch.bfloat16), att["bo"].to(torch.bfloat16)

    def stock_block():
        qkv = torch.addmm(bqkv16, x.reshape(B * L, E), att["wqkv"])
        q, k, v = qkv.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=stock_bias)
        return torch.addmm(bo16, ctx.transpose(1, 2).reshape(B * L, E), att["wo"])

    library = {"attention_block": graph_ms(torch, stock_block, 20)}
    bounds = {"attention_block": block_bound(block_cost(B, L, E, E, 2))}
    log_parts("attention_block (K1)", part_times(
        torch, lambda: ab.attention_block_packed(*args, bias=bias)), block_cost(B, L, E, E, 2))

    # K2, the fp32 light forward (CUDA cores), against its plain version and
    # the same block in stock fp32 PyTorch (TF32 off); bound at 67 TFLOP/s
    att32 = encoders["fp32", "auto"].weights["encoder"]["layer"]["attention"]
    x32 = x.float()
    args32 = (x32, att32["wqkv"], att32["bqkv"], att32["wo"], att32["bo"], H)
    k2, p2 = a_b(torch, lambda: ab.attention_block_plain(*args32, bias=bias),
                 lambda: ab.attention_block_packed(*args32, bias=bias), iters=10, timer=graph_ms)

    def stock_block32():
        qkv = torch.addmm(att32["bqkv"], x32.reshape(B * L, E), att32["wqkv"])
        q, k, v = qkv.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.clamp(min=NEG))
        return torch.addmm(att32["bo"], ctx.transpose(1, 2).reshape(B * L, E), att32["wo"])

    lib2 = graph_ms(torch, stock_block32, 10)
    bound2 = block_bound(block_cost(B, L, E, E, 4), PEAK_FP32_FLOPS)
    log(f"  attention_block fp32 (K2) [{B}, {L}, {E}]: kernel {k2:.4f} ms, plain {p2:.4f} ms, "
        f"library {lib2:.4f} ms, bound {bound2[0]:.4f} ms ({bound2[1]}, fp32 at 67 TFLOP/s)")
    res = torch.from_numpy(rng.standard_normal((B * L, E), dtype=np.float32)).to(DEV, torch.bfloat16)
    x2 = x.reshape(B * L, E)
    ln = att["ln"]
    # K5's library yardstick: the add and F.layer_norm; with dropout,
    # F.dropout before them
    g16, b16 = ln["g"].to(torch.bfloat16), ln["b"].to(torch.bfloat16)

    def library_ln(xa, ra, rate):
        return lambda: F.layer_norm((F.dropout(xa, rate) if rate else xa) + ra, (E,), g16, b16,
                                    cfg.layer_norm_eps)

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bound5(N, rate):  # x and the residual read, the output written, ~10 fp32 flops an element
        return ln_bound(N, E, 2, 3, 10.0, N * E if rate else 0, per_draw["ln_fwd"], sms,
                        clock_mhz)

    texts = [phoneme_text(rng, 512) for _ in range(B)]
    ids, mask, _ = enc.encode_batch(texts)
    times["encoder_forward"] = a_b(
        torch, lambda: plain.forward(ids, mask), lambda: enc.forward(ids, mask), iters=5,
    )
    for name, (k, p) in times.items():
        extra = (f", library {library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms "
                 f"({bounds[name][1]})" if name in library else "")
        log(f"  {name}: kernel {k:.4f} ms, plain {p:.4f} ms{extra}")
    # K5 at both shapes and rates: the training shape's 226 MB do not fit in
    # the 50 MB L2, so its share of the bytes bound is one of device memory
    # (the serving shape's 18.9 MB stay in L2 under graph replay, where the
    # bytes bound at the memory rate is no bound). The kernels line takes
    # the training shape at the training step's rate, 0.1.
    Nt = 96 * 512
    xt, rt = (torch.from_numpy(rng.standard_normal((Nt, E), dtype=np.float32)).to(
        DEV, torch.bfloat16) for _ in range(2))
    for N, xa, ra, iters in ((B * L, x2, res, 200), (Nt, xt, rt, 20)):
        for rate in (0.0, 0.1):
            seed = 7 if rate else None
            k5 = graph_ms(torch, lambda: fused_ln.dropout_add_layernorm(
                xa, ra, ln["g"], ln["b"], seed, rate), iters)
            lib5 = graph_ms(torch, library_ln(xa, ra, rate), iters)
            b5, by, terms = bound5(N, rate)
            at = (f"[{N}, {E}] dropout {rate}: kernel {k5:.4f} ms, library {lib5:.4f} ms, "
                  f"bound {b5:.4f} ms ({by}; " + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
                  + ")")
            if N == Nt:
                log(f"  dropout_add_layernorm {at}, {b5 / k5:.1%} of it")
            else:
                log(f"  dropout_add_layernorm {at}; L2-resident, so no share of it is read")
            if N == Nt and rate:
                # the plain version draws its own mask with the same rate (event-timed:
                # its generator is not captured in a graph; ~1 ms a call, so the host's
                # launches are out of the way)
                plain5 = time_ms(torch, lambda: fused_ln.dropout_add_layernorm_plain(
                    xa, ra, ln["g"], ln["b"], seed, rate), iters)
                times["dropout_add_layernorm"] = (k5, plain5)
                library["dropout_add_layernorm"] = lib5
                bounds["dropout_add_layernorm"] = (b5, by)
    # the draws alone, which bound K5 with dropout: Triton's mask kernel,
    # the same tl.rand an element and one byte out
    draws = graph_ms(torch, lambda: fused_ln.dropout_mask((Nt, E), 7, 0.1, DEV), 20)
    log(f"  the dropout draws alone at [{Nt}, {E}] (Triton's tl.rand mask kernel, one byte "
        f"out an element): {draws:.4f} ms")
    return {"times": times, "library": library, "bounds": bounds}


def bound_ms(flops: float, nbytes: float, flops_peak: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_cost(B, L, E, P, itemsize, kind="light") -> dict:
    """FLOPs and bytes of the attention block's kernels, ``kind`` "light"
    (K1/K2), "train" (K3), "backward" (K4) or "backward_simt" (K4, with
    ``formed``: the products each of its CUDA-core kernels forms at
    head_dim 64 -- do = dout·Woᵀ 2·M·E·P; the delta pass's q·k and do·vᵀ
    4·M·L·P; the dk/dv kernel's q·k, do·vᵀ, pdᵀ·do and dsᵀ·q 8·M·L·P; dq =
    ds·k 2·M·L·P: seven L²·D products a head where the gradient needs
    five), split into the projection
    GEMMs and the attention pass. With M = B·L: forward GEMMs x·Wqkv and
    ctx·Wo, 8·M·E·P; attention q·k and p·v, 4·M·L·P. Backward GEMMs
    do = dout·Woᵀ and dx = dqkv·Wqkvᵀ, 8·M·E·P; attention q·k, do·v, pᵀ·do,
    ds·k, dsᵀ·q, 10·M·L·P. ``bytes``: the block's inputs read and outputs
    written once (x and the weights read, the output written, and for K3
    also qkv, ctx and the statistics; for K4 dout, qkv, the weights and the
    statistics read, dqkv and dx written). ``gemm_bytes`` and
    ``attention_bytes``: what each part moves on its own (the projections
    read x, ctx and the weights and write qkv and the output; the
    attention reads qkv and writes ctx, and the statistics for K3; K4's
    projections read dout, dqkv and the weights and write do and dx, its
    attention reads qkv, do and the statistics and writes dqkv)."""
    M, H = B * L, P // 64
    weights = 4 * E * P * itemsize
    stats = 2 * B * H * L * 4
    if kind == "backward_simt":
        cost = block_cost(B, L, E, P, itemsize, "backward")
        cost["formed"] = {"do": 2 * M * E * P, "delta": 4 * M * L * P, "dkdv": 8 * M * L * P,
                          "dq": 2 * M * L * P}
        return cost
    if kind == "backward":
        return {"gemm": 8 * M * E * P, "attention": 10 * M * L * P,
                "bytes": 2 * M * (E + 3 * P) * itemsize + weights + stats,
                "gemm_bytes": (2 * M * E + 4 * M * P) * itemsize + weights,
                "attention_bytes": 7 * M * P * itemsize + stats}
    nbytes = 2 * M * E * itemsize + weights
    saved = stats if kind == "train" else 0
    if kind == "train":
        nbytes += M * 4 * P * itemsize + stats
    return {"gemm": 8 * M * E * P, "attention": 4 * M * L * P, "bytes": nbytes,
            "gemm_bytes": (2 * M * E + 4 * M * P) * itemsize + weights,
            "attention_bytes": 4 * M * P * itemsize + saved}


def block_bound(cost: dict, flops_peak: float = PEAK_BF16_FLOPS):
    """The bound of the whole block: all its products against its bytes."""
    return bound_ms(cost["gemm"] + cost["attention"], cost["bytes"], flops_peak)


# the parts of a bf16 block or flash call: {part: (kernel name, launches a call)}
FORWARD_PARTS = {"gemm": ("gemm_bias_sm90", 2), "attention": ("attention_fwd_sm90", 1)}
# K4: do = dout·Woᵀ and the attention (delta pass, dk/dv with the ds
# scratch, dq = ds·k) on the CUDA cores, dx on wgmma
BACKWARD_PARTS = {"do": ("gemm_bias<", 1), "dx": ("gemm_bias_sm90", 1),
                  "delta": ("attention_bwd_delta<", 1), "dkdv": ("attention_bwd_dkdv<", 1),
                  "dq": ("attention_bwd_dq<", 1)}
FLASH_BACKWARD_PARTS = {"dq": ("attention_bwd_dq_sm90", 1),
                        "dkdv": ("attention_bwd_dkdv_sm90", 1)}


def part_times(torch, fn, iters: int = 5, keys: dict = FORWARD_PARTS) -> dict:
    """Device ms a call of ``fn`` by part, from ``torch.profiler`` over
    ``iters`` calls: ``keys`` names each part's kernel and its launches a
    call (the forward's projection GEMMs and attention pass by default;
    the backward's GEMMs, dq and dk/dv kernels). The trace can drop a
    kernel record (seen on the card: 9 of 10 GEMMs), so each part is its
    mean over the records it has times its launches a call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    records = {part: [] for part in keys}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part, (key, _) in keys.items():
            if key in evt.name:
                records[part].append(evt.time_range.elapsed_us() / 1e3)
    return {part: sum(ms) / len(ms) * keys[part][1] if ms else 0.0
            for part, ms in records.items()}


def log_parts(label: str, parts: dict, cost: dict) -> None:
    """Print each part's device time; then the projections (gemm, or do
    and dx) and the attention (attention, or delta, dk/dv and dq) each
    against its own bound. With a "backward_simt" cost, each CUDA-core
    part of K4 also beside the products it forms at the fp32 rate, and the
    attention beside the CUDA-core bound of the products it needs."""
    if set(parts) - {"gemm", "attention"}:
        log(f"  {label}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts.items()))
    groups = {"gemm": ("gemm", "do", "dx"), "attention": ("attention", "delta", "dkdv", "dq")}
    for part, keys in groups.items():
        ms = sum(parts.get(k, 0.0) for k in keys)
        bound, by = bound_ms(cost[part], cost[f"{part}_bytes"])
        log(f"  {label} {part}: {ms:.4f} ms a call, bound {bound:.4f} ms ({by}; "
            f"{cost[part] / 1e9:.1f} GFLOP), {bound / ms if ms else 0:.1%} of it")
    if "formed" not in cost:
        return
    for part, flops in cost["formed"].items():
        ms = parts.get(part, 0.0)
        bound = flops / PEAK_FP32_FLOPS * 1e3
        log(f"  {label} {part} on the CUDA cores: {ms:.4f} ms, forms {flops / 1e9:.1f} GFLOP, "
            f"{bound:.4f} ms at 67 TFLOP/s, {bound / ms if ms else 0:.1%} of it")
    ms = sum(parts.get(k, 0.0) for k in groups["attention"])
    bound, by = bound_ms(cost["attention"], cost["attention_bytes"], PEAK_FP32_FLOPS)
    log(f"  {label} attention: {ms:.4f} ms a call, CUDA-core bound {bound:.4f} ms ({by}; the "
        f"{cost['attention'] / 1e9:.1f} GFLOP it needs at 67 TFLOP/s), "
        f"{bound / ms if ms else 0:.1%} of it")


def hold_flash_stats(torch, saved, heads: int, bias_row, label: str) -> None:
    """K8's first pass on views of K3's qkv recomputes the row max and
    denominator with the forward's own functions: they must equal K3's
    saved ones bit for bit (dO is not read by that pass)."""
    from pl_bert_tpu_torch.ops import flash_attention as fa

    qkv, _, m, l = saved
    B, _, L = m.shape
    P = qkv.shape[1] // 3
    q, k, v = (t.reshape(B, L, heads, P // heads)
               for t in qkv.reshape(B, L, 3 * P).split(P, dim=-1))
    *_, m8, l8 = fa._launch_bwd(torch.zeros_like(q), q, k, v, bias_row, None, 0.0, None)
    torch.cuda.synchronize()
    same = torch.equal(m8, m) and torch.equal(l8, l)
    log(f"  K8's recomputed row max and denominator equal K3's saved ones bit for bit "
        f"({label}): {same}")
    if not same:
        raise AssertionError(
            f"K8's statistics differ from K3's ({label}): row max by "
            f"{float((m8 - m).abs().max()):.3e}, denominator by "
            f"{float((l8 - l).abs().max()):.3e}")


def hold_k4_stages(torch, results, dout, wo, saved, heads, bias_row, rate, seed, keep, scratch,
                   tag) -> None:
    """K4's CUDA-core stages against their plain versions: ``do`` must be
    the plain ``do`` bit for bit in bf16 (one fmaf chain an output over the
    768 inputs in order, as cuBLAS fp32 sums them), delta (the delta pass)
    and the ds scratch (the dk/dv kernel) are held fed K4's own ``do``
    and delta."""
    from pl_bert_tpu_torch.ops import attention_block as ab

    do, delta, ds = scratch
    B, _, L = delta.shape
    plain_do = (dout.reshape(B * L, -1).float() @ wo.float().T).to(dout.dtype)
    same = bool(torch.equal(do, plain_do))
    share = float((do != plain_do).float().mean())
    log(f"  K4 do == plain do bitwise ({tag}): {same} ({share:.2e} of the elements differ)")
    if dout.dtype == torch.bfloat16 and not same:
        raise AssertionError(f"K4's do is not the plain do bit for bit ({tag})")
    args = (heads, bias_row, None, rate, seed, keep)
    hold(results, "attention_block_bwd", f"K4 delta {tag}", delta,
         ab.attention_delta_plain(do, saved, *args), TOL["float32"])
    dname = str(dout.dtype).removeprefix("torch.")
    hold(results, "attention_block_bwd", f"K4 ds {tag}", ds[:, :, :L, :L],
         ab.attention_dkdv_plain(do, saved, delta, *args)[2], TOL[dname])


def phase_train_kernels(torch, cfg, results: dict) -> None:
    """9-12. the training kernels against their plain versions, and the
    dropout statistics."""
    import numpy as np

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask, _dropout
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln

    rng = np.random.default_rng(SEED + 5)
    B, L, E, H, dev = 8, 512, cfg.hidden_size, cfg.num_attention_heads, DEV
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    wqkv32, bqkv = f32(rng.standard_normal((E, 3 * E)) * 0.05), f32(rng.standard_normal(3 * E) * 0.02)
    wo32, bo = f32(rng.standard_normal((E, E)) * 0.05), f32(rng.standard_normal(E) * 0.02)
    lengths = np.array([512, 480, 384, 256, 128, 64, 5, 0])
    mask = f32(np.arange(L)[None, :] < lengths[:, None])
    bias_row, _ = ab.rows(attention_bias_from_mask(mask), None, B, L)
    x32 = f32(rng.standard_normal((B, L, E)) * 0.5)
    dout32 = f32(rng.standard_normal((B, L, E)))

    log("phase 9: attention block training forward (K3) against its plain version, "
        f"[{B}, {L}, {E}]")
    log("phase 10: its backward (K4) against the plain backward on the same saved tensors")
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        x, dout = x32.to(dtype), dout32.to(dtype)
        wqkv, wo = wqkv32.to(dtype).contiguous(), wo32.to(dtype).contiguous()
        for rate in (0.0, 0.1):
            seed = 4321 if rate else None
            keep = None
            if rate:
                keep = ab.dropout_mask(seed, rate, B, H, L, dev)
                if not torch.equal(keep.bool(), ab.dropout_keep(seed, rate, B, H, L, dev)):
                    raise AssertionError("the kernels' dropout mask is not the plain Philox")
            out, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed)
            light, _ = ab._launch_fwd(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed,
                                      save=False)
            ref, ref_saved = ab.train_forward_plain(x, wqkv, bqkv, wo, bo, H, bias_row, None,
                                                    rate, seed, keep=keep)
            torch.cuda.synchronize()
            if not torch.equal(out, light):
                raise AssertionError(f"K1 and K3 outputs differ ({dname}, dropout {rate})")
            if not all(torch.isfinite(t).all() for t in (out, *saved)):
                raise AssertionError(f"K3 {dname}: non-finite output")
            tag = f"{dname} dropout {rate}"
            for name, a, r in [("out", out, ref), ("qkv", saved[0], ref_saved[0]),
                               ("ctx", saved[1], ref_saved[1])]:
                err = errors(a, r)
                results["attention_block_train"].append(err["max_abs"])
                gate(f"K3 {name} {tag}", err, TOL[dname])
            # the statistics on the q and k K3 read: the bf16 projection
            # rounds qkv on the tensor cores (qkv is held above)
            stats = ab.softmax_stats_plain(saved[0], H, B, L, bias_row)
            for name, a, r in [("row max", saved[2], stats[0]),
                               ("denominator", saved[3], stats[1])]:
                gate(f"K3 {name} {tag}", errors(a, r), TOL["float32"])
            log(f"  K1 output == K3 output bitwise ({tag})")
            hold_flash_stats(torch, saved, H, bias_row, f"[{B}, {L}, {E}] {tag}")

            dx, dqkv, (do, delta, ds) = ab._launch_bwd(dout, x, wqkv, wo, saved, H, bias_row,
                                                       None, rate, seed, scratch=True)
            rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None,
                                                 rate, seed, keep=keep)
            hold_k4_stages(torch, results, dout, wo, saved, H, bias_row, rate, seed, keep,
                           (do, delta, ds), tag)
            del do, delta, ds
            x2, d2 = x.reshape(B * L, E).float(), dout.reshape(B * L, E).float()
            grads = {"dx": (dx, rdx), "dqkv": (dqkv, rdqkv),
                     "dWqkv": (x2.T @ dqkv.float(), x2.T @ rdqkv.float()),
                     "dbqkv": (dqkv.float().sum(0), rdqkv.float().sum(0)),
                     "dWo": (saved[1].float().T @ d2, ref_saved[1].float().T @ d2),
                     "dbo": (d2.sum(0), d2.sum(0))}
            torch.cuda.synchronize()
            for name, (a, r) in grads.items():
                if not torch.isfinite(a).all():
                    raise AssertionError(f"K4 {name} {tag}: non-finite")
                err = errors(a, r)
                results["attention_block_bwd"].append(err["max_abs"])
                gate(f"K4 {name} {tag}", err, TOL[dname] if a.dtype == dtype else TOL_GRAD[dname])
            del saved, ref_saved, grads

    log("phase 11: fused LN backward (K6) against its plain backward, [4096, 768]")
    N = 4096
    xs = [f32(rng.standard_normal((N, E))) for _ in range(3)]
    gamma = f32(1 + 0.1 * rng.standard_normal(E))
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        x, res, dy = (t.to(dtype) for t in xs)
        for rate in (0.0, 0.1):
            seed = 99 if rate else None
            keep = fused_ln.dropout_mask((N, E), 99, rate, dev) if rate else None
            got = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate)
            ref = fused_ln.dropout_add_layernorm_bwd_plain(dy, x, res, gamma, seed, rate,
                                                           keep=keep)
            torch.cuda.synchronize()
            for name, a, r in zip(("dx", "dres", "dgamma", "dbeta"), got, ref):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"K6 {name}: non-finite")
                err = errors(a, r)
                results["dropout_add_layernorm_bwd"].append(err["max_abs"])
                gate(f"K6 {name} {dname} dropout {rate}", err,
                     TOL[dname] if a.dtype == dtype else TOL_GRAD[dname])

    hold_ln_masks(torch, results, dev)

    Bt = 96
    log(f"phase 12: dropout keep rates at the training shape (B={Bt}, rate 0.1)")
    rate = 0.1
    ones = torch.ones(Bt * L, E, device=dev, dtype=torch.bfloat16)
    g1, b0 = torch.ones(E, device=dev), torch.zeros(E, device=dev)

    def k5_kept(s):
        # x = 1, residual = 0: a row holds kept 1/(1-rate) and dropped 0, and
        # after normalisation the dropped ones are the negative ones
        return fused_ln.dropout_add_layernorm(ones, torch.zeros_like(ones), g1, b0, s, rate) >= 0

    sites = {
        "attention (Philox, CUDA)": lambda s: ab.dropout_mask(s, rate, Bt, H, L, dev),
        "fused LN (K5's output, CUDA)": k5_kept,
        "fused LN (tl.rand, Triton)": lambda s: fused_ln.dropout_mask((Bt * L, E), s, rate, dev),
        "embedding (torch.Generator)": lambda s: _dropout(
            torch.ones(Bt, L, cfg.embedding_size, device=dev), s, rate) != 0,
    }
    for name, make in sites.items():
        first, again, other = make(17), make(17), make(18)
        kept = float(first.float().mean())
        same = bool(torch.equal(first, again))
        log(f"  {name}: kept {kept:.5f} over {first.numel()} elements, "
            f"same seed same mask {same}, other seed other mask {not torch.equal(first, other)}")
        if abs(kept - (1 - rate)) > KEEP_TOL or not same or torch.equal(first, other):
            raise AssertionError(f"dropout at {name} is off")
        del first, again, other
    same = torch.equal(k5_kept(17), fused_ln.dropout_mask((Bt * L, E), 17, rate, dev).bool())
    log(f"  fused LN: K5's kept elements are Triton's tl.rand mask, bit for bit: {same}")
    if not same:
        raise AssertionError("K5's dropout mask is not Triton's")


def hold_ln_masks(torch, results: dict, dev) -> None:
    """11. K5 and K6 draw Triton's ``tl.rand`` mask bit for bit: at
    [49152, 768], rate 0.1, for seeds 0, 1, 2^31 - 2 and one the training
    step draws, K5's output is held against its plain version fed the mask
    of a Triton kernel that calls ``tl.rand`` (one element dropped
    otherwise moves its output past the bf16 gate), K6's dx is zero
    exactly where that mask drops or dres is zero; and the plain
    ``tl_rand`` equals Triton's uniform floats at the first 4096 offsets,
    bitwise."""
    from pl_bert_tpu_torch.models.albert import draw_dropout_seeds
    from pl_bert_tpu_torch.ops import fused_ln

    shape, rate = (96 * 512, 768), 0.1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, res, dy = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
    gamma = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    beta = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    drawn = draw_dropout_seeds(torch.Generator().manual_seed(SEED), 1)[1]
    for seed in (0, 1, fused_ln.SEED_MAX, drawn):
        mask = fused_ln.dropout_mask(shape, seed, rate, dev).bool()
        out = fused_ln.dropout_add_layernorm(x, res, gamma, beta, seed, rate)
        ref = fused_ln.dropout_add_layernorm_plain(x, res, gamma, beta, seed, rate, keep=mask)
        hold(results, "dropout_add_layernorm",
             f"K5 against plain fed Triton's mask, seed {seed}, {list(shape)}", out, ref,
             TOL["bfloat16"])
        del out, ref
        dx, dres, _, _ = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate)
        same = torch.equal(dx != 0, mask & (dres != 0))
        u = fused_ln.triton_rand(4096, seed, dev).cpu()
        plain = fused_ln.tl_rand(seed, torch.arange(4096))
        log(f"  K6's dx is zero where Triton's tl.rand mask drops, seed {seed}, {list(shape)}: "
            f"{same} (kept {float(mask.float().mean()):.5f}); plain tl_rand == Triton's at "
            f"offsets 0-4095: {torch.equal(u, plain)}; tl.rand at offsets 0-3: "
            f"{[float(v) for v in u[:4]]}")
        if not same or not torch.equal(u, plain):
            raise AssertionError(f"K6's dropout mask is not Triton's at seed {seed}")
        del dx, dres, mask


def ln_bound(N: int, H: int, itemsize: int, passes: int, flops: float, draws: int,
             per_draw: dict, sms: int, clock_mhz: float):
    """K5's or K6's bound → (ms, "bytes" or "operations", {term: ms}): the
    largest of the bytes it must move (``passes`` of [N, H]: K5 reads x and
    the residual and writes the output, 3; K6 reads x, the residual and dy
    and writes dx and dres, 5) over 3.35 TB/s; its ``flops`` fp32
    operations an element (~10, ~20) over 67 TFLOP/s; and its ``draws``
    Philox draws' integer instructions, the busier of the IMAD and LOP3
    pipes (``per_draw``, counted in its SASS), over
    ``INT_OPS_PER_SM_CLOCK`` × ``sms`` × the max SM clock."""
    terms = {
        "bytes": passes * N * H * itemsize / PEAK_BYTES * 1e3,
        "fp32": flops * N * H / PEAK_FP32_FLOPS * 1e3,
        "integer": draws * max(per_draw.values())
        / (INT_OPS_PER_SM_CLOCK * sms * clock_mhz * 1e6) * 1e3,
    }
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def phase_train(torch, results: dict, per_draw: dict,
                clock_mhz: float) -> tuple[dict, dict, dict]:
    """13. the train step: kernel path against plain path, then bench.py's
    workload on the kernel path, with the launch counters; then K3, K4
    and K6 timed at that workload's shapes and held against their plain
    versions there."""
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.data.synthetic import full_length_batches
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import fused_ln
    from pl_bert_tpu_torch.ops.attention import NEG
    from pl_bert_tpu_torch.training import train_step as ts

    config = Config()  # configs/config.yml's values: bf16, B 96, L 512, AdamW 7e-5
    mp, tp = config.model_params, config.training_params
    L = config.dataset_params.max_seq_length
    log("phase 13: train step, block path (auto) and flash path (pallas) against the plain "
        "path: 3 steps, B=8, bf16, dropout 0")
    pool8 = full_length_batches(3, 8, L)
    losses = {}
    for impl in ("auto", "pallas", "eager"):
        model = init_params(build_model(dataclasses.replace(mp, dropout=0.0, attention_impl=impl),
                                        tp.mixed_precision), seed=SEED).to(DEV)
        tx = ts.make_optimizer(tp)
        state = ts.TrainState(model, tx.init(model))
        step = ts.make_train_step(model, tx, seed=tp.seed)
        losses[impl] = [{k: float(v) for k, v in step(state, b)[1].items()} for b in pool8]
        del model, state, tx
        torch.cuda.empty_cache()
    for impl in ("auto", "pallas"):
        for s, (k, p) in enumerate(zip(losses[impl], losses["eager"])):
            rel = {m: abs(k[m] - p[m]) / abs(p[m]) for m in ("loss", "grad_norm")}
            ok = all(rel[m] <= TRAIN_TOL[m] for m in rel) and all(
                np.isfinite(k[m]) for m in ("loss", "grad_norm"))
            log(f"  {impl} step {s}: loss {k['loss']:.6f} vs {p['loss']:.6f} "
                f"(rel {rel['loss']:.2e}), grad_norm {k['grad_norm']:.6f} vs "
                f"{p['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"train step {s}: {impl} path off the plain path: {rel}")

    B = tp.batch_size
    log(f"phase 13: bench.py's workload on the kernel path: B={B}, L={L}, "
        f"{tp.mixed_precision}, dropout {mp.dropout}, AdamW lr {tp.learning_rate}")
    model = init_params(build_model(mp, tp.mixed_precision), seed=SEED).to(DEV)
    tx = ts.make_optimizer(tp)
    state = ts.TrainState(model, tx.init(model))
    step = ts.make_train_step(model, tx, seed=tp.seed)
    pool = full_length_batches(4, B, L)
    warm, timed = 3, 5
    for i in range(warm):
        _, m = step(state, pool[i % len(pool)])
    float(m["loss"])
    counters = reset_counters()  # the training path's run starts here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_losses = []
    for i in range(timed):
        _, m = step(state, pool[(warm + i) % len(pool)])
        step_losses.append(float(m["loss"]))  # a host read: the step has finished
    wall = time.perf_counter() - t0
    launches = read_counters(counters)  # the training path's run ends here
    step_ms = wall / timed * 1e3
    tokens = sum(int(pool[(warm + i) % len(pool)]["lengths"].sum()) for i in range(timed))
    log(f"  losses {[round(v, 5) for v in step_losses]}; {step_ms:.1f} ms a step, "
        f"{tokens / wall:.0f} phoneme tokens/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if not all(np.isfinite(step_losses)):
        raise AssertionError(f"non-finite training loss: {step_losses}")
    n = mp.num_hidden_layers
    expect = dict.fromkeys(launches, 0)
    expect.update({"attention_block_train": n * timed, "attention_block_bwd": n * timed,
                   "dropout_add_layernorm": 2 * n * timed,
                   "dropout_add_layernorm_bwd": 2 * n * timed})
    log(f"  launch counters over {timed} steps: {launches}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    train = {"step_ms": step_ms, "tokens_per_s": tokens / wall, "losses": step_losses}
    del state, model, tx
    torch.cuda.empty_cache()

    log(f"phase 13: K3, K4, K6 timed at the workload's shapes (B={B}, L={L}, bf16, "
        "dropout 0.1; CUDA events over back-to-back calls), and held against their "
        "plain versions there")
    rng = np.random.default_rng(SEED + 6)
    E, H, dt, rate, seed = mp.hidden_size, mp.num_attention_heads, torch.bfloat16, mp.dropout, 7
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(DEV)  # noqa: E731
    x = f32(rng.standard_normal((B, L, E)) * 0.5).to(dt)
    dout = f32(rng.standard_normal((B, L, E))).to(dt)
    wqkv, bqkv = f32(rng.standard_normal((E, 3 * E)) * 0.05).to(dt), f32(np.zeros(3 * E))
    wo, bo = f32(rng.standard_normal((E, E)) * 0.05).to(dt), f32(np.zeros(E))
    bias_row = torch.zeros(B, L, device=DEV)
    times, bounds = {}, {}
    # the plain versions get the kernels' mask made once (its Philox in
    # int64 PyTorch ops would need tens of GB at this shape)
    keep = ab.dropout_mask(seed, rate, B, H, L, DEV)
    times["attention_block_train"] = a_b(
        torch,
        lambda: ab.train_forward_plain(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed,
                                       keep=keep),
        lambda: ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed), iters=3,
    )
    # K3 again at dropout 0 (no Philox draws), and each part of it timed
    k3 = {r: (lambda r=r: ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, r,
                                           seed if r else None)) for r in (0.0, rate)}
    log(f"  attention_block_train [{B}, {L}, {E}]: kernel {time_ms(torch, k3[0.0], 3):.4f} ms "
        f"at dropout 0, {times['attention_block_train'][0]:.4f} ms at dropout {rate}")
    for r, fn in k3.items():
        log_parts(f"attention_block_train (K3) dropout {r}", part_times(torch, fn, 3),
                  block_cost(B, L, E, E, 2, "train"))
    _, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed)

    def k4():
        return ab.train_backward(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed)

    times["attention_block_bwd"] = a_b(
        torch,
        lambda: ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed,
                                        keep=keep),
        k4, iters=3,
    )
    log_parts(f"attention_block_bwd (K4) dropout {rate}", part_times(torch, k4, 3, BACKWARD_PARTS),
              block_cost(B, L, E, E, 2, "backward_simt"))
    # the same calls held against each other at this shape, as phases 9-10
    # do at B=8: K3 (out, qkv, ctx, statistics), then K4 on K3's saved
    # tensors (dx, dqkv, and the fp32 weight and bias gradients)
    tag = f"[{B}, {L}, {E}] bf16 dropout {rate}"
    out, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate, seed)
    ref, ref_saved = ab.train_forward_plain(x, wqkv, bqkv, wo, bo, H, bias_row, None, rate,
                                            seed, keep=keep)
    for name, a, r in [("out", out, ref), ("qkv", saved[0], ref_saved[0]),
                       ("ctx", saved[1], ref_saved[1])]:
        hold(results, "attention_block_train", f"K3 {name} {tag}", a, r, TOL["bfloat16"])
    stats = ab.softmax_stats_plain(saved[0], H, B, L, bias_row)  # K3's own q and k
    for name, a, r in [("row max", saved[2], stats[0]), ("denominator", saved[3], stats[1])]:
        hold(results, "attention_block_train", f"K3 {name} {tag}", a, r, TOL["float32"])
    del stats
    hold_flash_stats(torch, saved, H, bias_row, tag)
    del out, ref
    dx, dqkv = ab.train_backward(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed)
    rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None, rate,
                                         seed, keep=keep)
    x2, d2 = x.reshape(B * L, E).float(), dout.reshape(B * L, E).float()
    for name, a, r, tol in [
        ("dx", dx, rdx, TOL["bfloat16"]), ("dqkv", dqkv, rdqkv, TOL["bfloat16"]),
        ("dWqkv", x2.T @ dqkv.float(), x2.T @ rdqkv.float(), TOL_GRAD["bfloat16"]),
        ("dbqkv", dqkv.float().sum(0), rdqkv.float().sum(0), TOL_GRAD["bfloat16"]),
        ("dWo", saved[1].float().T @ d2, ref_saved[1].float().T @ d2, TOL_GRAD["bfloat16"]),
    ]:
        hold(results, "attention_block_bwd", f"K4 {name} {tag}", a, r, tol)
    del saved, ref_saved, keep, dx, dqkv, rdx, rdqkv, x2, d2
    bounds["attention_block_train"] = block_bound(block_cost(B, L, E, E, 2, "train"))
    bounds["attention_block_bwd"] = block_bound(block_cost(B, L, E, E, 2, "backward"))

    # library yardsticks, timed only: the same block on cuBLAS and SDPA in
    # bf16 under autograd (forward; then its backward), and F.layer_norm's
    # backward; they round at other points than the kernels
    xg = x.detach().requires_grad_()
    ws = [t.detach().requires_grad_() for t in (wqkv, bqkv.to(dt), wo, bo.to(dt))]
    attn_bias = bias_row.clamp(min=NEG).to(dt)[:, None, None, :]

    def stock_block():
        qkv = F.linear(xg, ws[0].T, ws[1])
        q, k, v = qkv.view(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_bias, dropout_p=rate)
        return F.linear(ctx.transpose(1, 2).reshape(B, L, E), ws[2].T, ws[3])

    library = {"attention_block_train": time_ms(torch, stock_block, 3)}
    stock_out = stock_block()
    library["attention_block_bwd"] = time_ms(
        torch, lambda: torch.autograd.grad(stock_out, [xg, *ws], dout, retain_graph=True), 3)
    del stock_out

    N = B * L
    xl, res, dy = (f32(rng.standard_normal((N, E))).to(dt) for _ in range(3))
    gamma, beta = f32(1 + 0.1 * rng.standard_normal(E)), f32(0.1 * rng.standard_normal(E))
    times["dropout_add_layernorm_bwd"] = a_b(
        torch, lambda: fused_ln.dropout_add_layernorm_bwd_plain(dy, xl, res, gamma, seed, rate),
        lambda: fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma, seed, rate), iters=10,
    )
    # K6 again at dropout 0 (no Philox draws), beside its library call,
    # which does no dropout either
    k6_0 = time_ms(torch, lambda: fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma), 10)
    keep = fused_ln.dropout_mask((N, E), seed, rate, DEV)
    got = fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma, seed, rate)
    ref = fused_ln.dropout_add_layernorm_bwd_plain(dy, xl, res, gamma, seed, rate, keep=keep)
    for name, a, r in zip(("dx", "dres", "dgamma", "dbeta"), got, ref):
        hold(results, "dropout_add_layernorm_bwd", f"K6 {name} [{N}, {E}] bf16 dropout {rate}",
             a, r, TOL["bfloat16"] if a.dtype == dt else TOL_GRAD["bfloat16"])
    # no float atomics in the dgamma/dbeta sums: a second call, same bits
    again = fused_ln.dropout_add_layernorm_bwd(dy, xl, res, gamma, seed, rate)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  K6 [{N}, {E}] dropout {rate}: a second call gives the same dx, dres, dgamma "
        f"and dbeta bits: {same}")
    if not same:
        raise AssertionError("K6: two calls on the same inputs differ")
    del keep, got, ref, again
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k6_per_draw = per_draw["ln_bwd"]
    bound6 = ln_bound(N, E, 2, 5, 20.0, N * E, k6_per_draw, sms, clock_mhz)
    bound6_0 = ln_bound(N, E, 2, 5, 20.0, 0, k6_per_draw, sms, clock_mhz)
    bounds["dropout_add_layernorm_bwd"] = bound6[:2]
    log(f"  dropout_add_layernorm_bwd [{N}, {E}] bound terms: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in bound6[2].items())
        + f" ({N * E} draws, {max(k6_per_draw.values()):.2f} integer instructions a draw on "
        f"the busier pipe, {INT_OPS_PER_SM_CLOCK} a clock an SM x {sms} SMs x {clock_mhz:.0f} MHz)")
    yg = (xl + res).requires_grad_()
    gg, bg = gamma.to(dt).requires_grad_(), beta.to(dt).requires_grad_()
    ln_out = F.layer_norm(yg, (E,), gg, bg, mp.layer_norm_eps)
    library["dropout_add_layernorm_bwd"] = time_ms(
        torch, lambda: torch.autograd.grad(ln_out, [yg, gg, bg], dy, retain_graph=True), 10)
    k6_1 = times["dropout_add_layernorm_bwd"][0]
    log(f"  dropout_add_layernorm_bwd [{N}, {E}]: kernel {k6_0:.4f} ms at dropout 0 (bound "
        f"{bound6_0[0]:.4f} ms, {bound6_0[0] / k6_0:.1%} of it; library "
        f"{library['dropout_add_layernorm_bwd']:.4f} ms), {k6_1:.4f} ms at dropout {rate} "
        f"(bound {bound6[0]:.4f} ms, {bound6[0] / k6_1:.1%} of it)")
    for name, (k, p) in times.items():
        log(f"  {name}: kernel {k:.4f} ms, plain {p:.4f} ms, library {library[name]:.4f} ms, "
            f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    return train, launches, {"times": times, "library": library, "bounds": bounds}


def flash_cost(B, L, H, D, itemsize, backward=False):
    """(FLOPs, bytes) of K7 or K8 on dense rows: the forward's q.k and
    p.v, 4·L²·D a (batch, head), with q, k, v read and o written; the
    backward's five products, 10·L²·D, with q, k, v, do read and dq, dk,
    dv written."""
    tensors, products = (7, 10) if backward else (4, 4)
    return products * L * L * D * B * H, tensors * B * L * H * D * itemsize


def phase_flash_kernels(torch, cfg, results: dict) -> dict:
    """14. K7, K8 and K9 against their plain versions, then timed."""
    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import flash_attention as fa
    from pl_bert_tpu_torch.ops import fused_ln
    from pl_bert_tpu_torch.ops.attention import NEG

    log("phase 14: flash attention forward (K7) and backward (K8) against their plain versions")
    rng = np.random.default_rng(SEED + 7)
    H, D, E, dev = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size, DEV
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731

    def case(B, L, lengths, segments, dtype, heads=H, hd=D):
        """q, k, v as views of one fused [B, L, 3·heads·hd] projection (the
        model's layout), dout, and the bias and segment rows: rows padded
        to ``lengths``, and with ``segments`` two or three packed samples a
        row."""
        width = heads * hd
        qkv = f32(rng.standard_normal((B, L, 3 * width)) * 0.7).to(dtype)
        q, k, v = (t.reshape(B, L, heads, hd) for t in qkv.split(width, dim=-1))
        dout = f32(rng.standard_normal((B, L, heads, hd))).to(dtype)
        valid = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
        seg = None
        if segments:
            cuts = np.asarray(lengths)[:, None] * np.array([[0.3, 0.55]])
            seg_np = (np.arange(L)[None, :, None] >= cuts[:, None, :]).sum(-1)
            seg = torch.from_numpy(np.where(valid, seg_np, -1).astype(np.int32)).to(dev)
        bias_row, seg_row = ab.rows(attention_bias_from_mask(f32(valid)), seg, B, L)
        return q, k, v, dout, bias_row, seg_row

    def check(tag, B, L, lengths, segments, dtype, rate, heads=H, hd=D):
        dname = str(dtype).removeprefix("torch.")
        q, k, v, dout, bias_row, seg_row = case(B, L, lengths, segments, dtype, heads, hd)
        seed = 977 if rate else None
        keep = ab.dropout_mask(seed, rate, B, heads, L, dev) if rate else None
        out = fa.flash_attention_fwd(q, k, v, bias_row, seg_row, rate, seed)
        grads = fa.flash_attention_bwd(dout, q, k, v, bias_row, seg_row, rate, seed)
        ref = fa.flash_attention_plain(q, k, v, bias_row, seg_row, rate, seed, keep=keep)
        refs = fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, seg_row, rate, seed,
                                            keep=keep)
        torch.cuda.synchronize()
        if out.shape != (B, L, heads, hd) or out.dtype != dtype:
            raise AssertionError(f"K7 {tag}: {out.shape} {out.dtype}")
        label = f"{tag} {dname} dropout {rate}"
        hold(results, "flash_attention", f"K7 out {label}", out, ref, TOL[dname])
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            hold(results, "flash_attention_bwd", f"K8 {name} {label}", a, r, TOL[dname])

    padded = [512, 480, 384, 256, 128, 64, 5, 0]
    mask = ab.dropout_mask(977, 0.1, 8, H, 512, dev)
    if not torch.equal(mask.bool(), ab.dropout_keep(977, 0.1, 8, H, 512, dev)):
        raise AssertionError("the kernels' dropout mask is not the plain Philox")
    log("  the kernels' dropout mask equals the plain Philox bit for bit")
    del mask
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (0.0, 0.1):
            check("[8, 512, 12, 64] padded", 8, 512, padded, False, dtype, rate)
            check("[8, 512, 12, 64] packed", 8, 512, padded, True, dtype, rate)
        check("[8, 200, 12, 64] packed", 8, 200, [200, 199, 150, 101, 100, 64, 3, 0], True,
              dtype, 0.1)
        # head_dim 128, which the flash kernels take too
        check("[8, 200, 6, 128] packed", 8, 200, [200, 199, 150, 101, 100, 64, 5, 0], True,
              dtype, 0.1, heads=E // 128, hd=128)
    Bt = 96
    check(f"[{Bt}, 512, 12, 64] packed", Bt, 512, rng.integers(300, 513, Bt), True,
          torch.bfloat16, 0.1)
    torch.cuda.empty_cache()

    N = Bt * 512
    for dtype in (torch.bfloat16, torch.float32):
        x, res = (f32(rng.standard_normal((N, E))).to(dtype) for _ in range(2))
        got, want = fused_ln.add_copy(x, res), fused_ln.add_copy_plain(x, res)
        torch.cuda.synchronize()
        results["add_copy"].append(float((got.float() - want.float()).abs().max()))
        log(f"  K9 add_copy [{N}, {E}] {dtype}: bitwise {bool(torch.equal(got, want))}")
        if got.dtype != dtype or not torch.equal(got, want):
            raise AssertionError(f"K9 add_copy {dtype} differs from its plain version")
        # a count that is no whole number of 16-byte vectors (1001 x 769),
        # and views one element past an aligned base (the scalar loop)
        n = 1001 * 769
        flat = [f32(rng.standard_normal(n + 1)).to(dtype) for _ in range(2)]
        for label, xv, rv in (("ragged", flat[0][:n], flat[1][:n]),
                              ("unaligned view", flat[0][1:], flat[1][1:])):
            xv, rv = xv.view(1001, 769), rv.view(1001, 769)
            got = fused_ln.add_copy(xv, rv)
            want = fused_ln.add_copy_plain(xv, rv)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            log(f"  K9 add_copy [1001, 769] {label} {dtype}: bitwise {same}")
            if not same:
                raise AssertionError(f"K9 add_copy {label} {dtype} differs from its plain version")

    log("phase 14: K7 and K8 timed, bf16, dropout 0.1, full-length rows, no segments: device "
        "time from a replayed CUDA graph at B=8, CUDA events over back-to-back calls at B=96")
    times, library, bounds = {}, {}, {}
    rate, seed, dt = 0.1, 977, torch.bfloat16
    for B, timer, iters in ((8, graph_ms, 10), (Bt, time_ms, 3)):
        q, k, v, dout, bias_row, _ = case(B, 512, [512] * B, False, dt)
        keep = ab.dropout_mask(seed, rate, B, H, 512, dev)
        fwd = a_b(torch,
                  lambda: fa.flash_attention_plain(q, k, v, bias_row, None, rate, seed, keep=keep),
                  lambda: fa.flash_attention_fwd(q, k, v, bias_row, None, rate, seed),
                  iters=iters, timer=timer)
        bwd = a_b(torch,
                  lambda: fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, None, rate, seed,
                                                       keep=keep),
                  lambda: fa.flash_attention_bwd(dout, q, k, v, bias_row, None, rate, seed),
                  iters=iters, timer=timer)
        fwd0 = timer(torch, lambda: fa.flash_attention_fwd(q, k, v, bias_row, None), iters)
        log(f"  flash_attention [{B}, 512, 12, 64]: kernel {fwd0:.4f} ms at dropout 0, "
            f"{fwd[0]:.4f} ms at dropout {rate}")
        parts = part_times(torch, lambda: fa.flash_attention_bwd(dout, q, k, v, bias_row, None,
                                                                 rate, seed),
                           3, FLASH_BACKWARD_PARTS)
        log(f"  flash_attention_bwd [{B}, 512, 12, 64] dropout {rate}: dq kernel "
            f"{parts['dq']:.4f} ms (three passes over the keys), dk/dv kernel "
            f"{parts['dkdv']:.4f} ms")
        del keep
        # library yardstick, timed only: SDPA with the mask, forward, then
        # its backward; it rounds at other points than the kernels
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        attn_bias = bias_row.clamp(min=NEG).to(dt)[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, attn_mask=attn_bias, dropout_p=rate)
        lib_fwd = time_ms(torch, sdpa, max(iters, 5))
        sdpa_out = sdpa()
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, [qs, ks, vs], dout.transpose(1, 2), retain_graph=True), max(iters, 5))
        del sdpa_out
        shape = f"[{B}, 512, 12, 64]"
        for name, (kms, pms), lib, back in (("flash_attention", fwd, lib_fwd, False),
                                            ("flash_attention_bwd", bwd, lib_bwd, True)):
            bound = bound_ms(*flash_cost(B, 512, H, D, 2, back))
            log(f"  {name} {shape}: kernel {kms:.4f} ms, plain {pms:.4f} ms, library "
                f"{lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            # the kernels line carries the packed run's shape, B=96
            times[name], library[name], bounds[name] = (kms, pms), lib, bound
        torch.cuda.empty_cache()

    x, res = (f32(rng.standard_normal((N, E))).to(dt) for _ in range(2))
    times["add_copy"] = a_b(torch, lambda: fused_ln.add_copy_plain(x, res),
                            lambda: fused_ln.add_copy(x, res), iters=20)
    library["add_copy"] = time_ms(torch, lambda: torch.add(x, res), 20)
    # one fp32 add an element; x and the residual read, the output written
    bounds["add_copy"] = bound_ms(1.0 * N * E, 3 * N * E * 2, PEAK_FP32_FLOPS)
    kms, pms = times["add_copy"]
    log(f"  add_copy [{N}, {E}]: kernel {kms:.4f} ms, plain {pms:.4f} ms, library "
        f"{library['add_copy']:.4f} ms, bound {bounds['add_copy'][0]:.4f} ms "
        f"({bounds['add_copy'][1]})")
    return {"times": times, "library": library, "bounds": bounds}


def phase_packed_run(torch, workdir: str) -> tuple[dict, dict]:
    """16. the Trainer through its normal entry on a packed,
    on-device-masked run on the flash path: 8 steps, then a resume to 12."""
    import contextlib

    import numpy as np

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.models.albert import build_model
    from pl_bert_tpu_torch.training.train import train

    out_dir = os.path.join(workdir, "runs")
    config_path = os.path.join(workdir, "packed_run.yml")
    run_dir = os.path.join(out_dir, "smoke")

    def launch(steps: int, paths) -> tuple[str, dict, float]:
        for path in paths:
            with open(path, "w", encoding="utf-8") as f:
                f.write(RUN_CONFIG.format(out=out_dir, steps=steps))
        counters = reset_counters()  # the packed run starts here
        printed = Tee()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            final = train({"config_path": config_path, "run_name": "smoke", "device": DEV})
        wall = time.perf_counter() - t0
        launches = read_counters(counters)  # the packed run ends here
        if final != steps:
            raise AssertionError(f"the run stopped at step {final}, not {steps}")
        return printed.getvalue(), launches, wall

    log("phase 16: the packed run through training.train.train(): flagship model, "
        "attention_impl pallas, on-device masking, sequence packing, B=96, bf16, dropout 0.1, "
        "8 steps")
    printed, first, wall1 = launch(8, [config_path])
    if "sequence packing:" not in printed or "token occupancy" not in printed:
        raise AssertionError("the run did not print its packing line")
    log("phase 16: the same call again with num_steps 12 (the run directory's config copy "
        "is what a resumed run reads, so it is raised there too): resumes from step_8.pth")
    printed2, second, wall2 = launch(12, [config_path, os.path.join(run_dir, "packed_run.yml")])
    if "step_8.pth loaded" not in printed2 or "Resuming" not in printed2:
        raise AssertionError("the second call did not resume from step_8.pth")

    with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    if [r["step"] for r in steps] != list(range(1, 13)):
        raise AssertionError(f"metrics.jsonl steps: {[r['step'] for r in steps]}")
    losses = [r["loss"] for r in steps]
    vals = [r for r in records if "val_phoneme_loss" in r]
    if not all(np.isfinite(losses)) or not all(np.isfinite(r["val_phoneme_loss"]) for r in vals):
        raise AssertionError(f"non-finite loss in the packed run: {losses}")
    for n in (4, 8, 12):
        if not os.path.isfile(os.path.join(run_dir, f"step_{n}.pth")):
            raise AssertionError(f"step_{n}.pth is missing")
    config = Config.load(config_path)
    ckpt = torch.load(os.path.join(run_dir, "step_12.pth"), map_location="cpu",
                      weights_only=True)
    fresh = build_model(config.model_params, config.training_params.mixed_precision)
    fresh.load_state_dict(ckpt["net"], strict=True)
    if ckpt["step"] != 12 or len(ckpt["optimizer"]["state"]) != len(ckpt["net"]):
        raise AssertionError("step_12.pth: wrong step or optimizer state")

    n = config.model_params.num_hidden_layers
    total = {k: first[k] + second[k] for k in first}
    # every training step runs K7 and K8 once and K5 and K6 twice a layer;
    # every validation forward K7 once and K5 twice a layer
    evals, rem = divmod(total["flash_attention"] - 12 * n, n)
    expect = dict.fromkeys(total, 0)
    expect.update({"flash_attention": n * (12 + evals), "flash_attention_bwd": n * 12,
                   "dropout_add_layernorm": 2 * n * (12 + evals),
                   "dropout_add_layernorm_bwd": 2 * n * 12})
    log(f"  launch counters over 12 training steps and {evals} validation forwards: {total}")
    if rem or evals < 0 or total != expect:
        raise AssertionError(f"launch counts {total} != {expect}")
    # per-step rates from the run's own log (log_interval 1: each record
    # ends in a host read of the loss, so the step has finished); the
    # median leaves out the steps that follow a checkpoint and a validation
    occupancy = float(printed.split("rows (")[1].split("%")[0]) / 100
    sps = float(np.median([r["steps_per_sec"] for r in steps if "steps_per_sec" in r]))
    tokens = sps * config.training_params.batch_size * config.dataset_params.max_seq_length
    log(f"  losses {[round(v, 4) for v in losses]}; validation "
        f"{[round(r['val_phoneme_loss'], 4) for r in vals]}")
    log(f"  packed run: {1e3 / sps:.1f} ms a step (median), {tokens:.0f} token positions/s, "
        f"{tokens * occupancy:.0f} phoneme tokens/s at {occupancy:.0%} occupancy; the two "
        f"calls took {wall1:.1f} s and {wall2:.1f} s with set-up, validation and checkpoints")
    run = {"step_ms": 1e3 / sps, "tokens_per_s": tokens * occupancy, "occupancy": occupancy,
           "losses": losses}
    return run, total


def head_gate(name: str, out, ref) -> dict:
    """Gate a grapheme-head gradient, fused against chunked, at
    ``HEAD_GRAD_TOL``: rel-L2, and max-abs relative to the reference's
    largest magnitude (the head's gradients are ~1e-4 in size)."""
    err = errors(out, ref)
    scale = float(ref.float().abs().max())
    ok = (out.isfinite().all() and err["rel_l2"] <= HEAD_GRAD_TOL["rel_l2"]
          and err["max_abs"] <= HEAD_GRAD_TOL["max_abs_rel"] * scale)
    log(f"  {name}: max_abs {err['max_abs']:.3e} (of {scale:.3e}) rel_l2 {err['rel_l2']:.3e} "
        f"(tol {HEAD_GRAD_TOL['max_abs_rel']:.0e} of the scale / {HEAD_GRAD_TOL['rel_l2']:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} outside tolerance: {err}")
    return err


def head_cost(B: int, L: int, rows: int, H: int, V: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the fused grapheme head's forward and backward on
    ``rows`` gathered positions a sample: the logits, dh and dW products
    (2·B·rows·H·V each); bf16 hidden read and dh written, the fp32 head
    (W, b) read and its gradients written, the int32 labels and the bool
    mask read."""
    return (3 * 2 * B * rows * H * V,
            2 * B * rows * H * 2 + 2 * (V * H + V) * 4 + B * L * (4 + 1))


def phase_multitask_head(torch) -> dict:
    """18 a. the grapheme head's losses at the production shape (B=96,
    L=512, hidden 768, vocabulary 60,000, bf16, capacity 144): the fused
    value against the chunked value and their gradients, the gathered
    loss against the full-length one; each timed forward and backward,
    and the fused head split into its parts (torch.profiler)."""
    import numpy as np

    from pl_bert_tpu_torch.ops import masked_ce
    from pl_bert_tpu_torch.training.profile import HEAD_PARTS, head_parts

    B, L, H, V, capacity = 96, 512, 768, 60_000, 144
    log(f"phase 18 a: the grapheme head at the production shape: [{B}, {L}, {H}] bf16 hidden, "
        f"a head of {V}, capacity {capacity}")
    rng = np.random.default_rng(SEED + 18)
    dev = DEV
    hidden = torch.from_numpy(rng.standard_normal((B, L, H), dtype=np.float32)).to(
        dev, torch.bfloat16).requires_grad_()
    weight = torch.from_numpy(0.02 * rng.standard_normal((V, H), dtype=np.float32)).to(dev)
    weight.requires_grad_()
    bias = torch.from_numpy(0.02 * rng.standard_normal(V, dtype=np.float32)).to(dev)
    bias.requires_grad_()
    labels = torch.from_numpy(rng.integers(5, V, (B, L)).astype(np.int32)).to(dev)
    # about 58 valid masked positions a row, as the production masking gives
    mask = torch.from_numpy(rng.random((B, L)) < 58 / L).to(dev)
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    rows = int(mask.sum(1).max())
    if rows > capacity:
        raise AssertionError(f"a row holds {rows} masked positions, more than {capacity}")

    def run(fused: bool, cap: int, grad: bool = True):
        for t in (hidden, weight, bias):
            t.grad = None
        with torch.set_grad_enabled(grad):
            loss = masked_ce.masked_lm_loss(hidden, weight, bias, labels, mask, lengths,
                                            capacity=cap, fused=fused)
        if grad:
            loss.backward()
        return loss.detach()

    fused = run(True, capacity)
    fused_grads = [t.grad.clone() for t in (hidden, weight, bias)]
    chunked = run(False, capacity)
    chunked_grads = [t.grad.clone() for t in (hidden, weight, bias)]
    full = run(True, 0)
    full_chunked = run(False, 0, grad=False)
    log(f"  loss: fused {fused.item():.9f}, chunked {chunked.item():.9f} (gathered); "
        f"full length {full.item():.9f}")
    if fused.item() != chunked.item() or full.item() != full_chunked.item():
        raise AssertionError("the fused loss is not the chunked loss bit for bit")
    rel = abs(fused.item() - full.item()) / abs(full.item())
    log(f"  gathered against full length: rel {rel:.2e} (tol {GATHER_TOL:.0e}) "
        f"{'ok' if rel <= GATHER_TOL else 'FAIL'}")
    if not np.isfinite(fused.item()) or rel > GATHER_TOL:
        raise AssertionError(f"the gathered loss is off the full-length loss: {rel}")
    errs = {name: head_gate(f"{name}, fused against chunked", f, c)["rel_l2"]
            for name, f, c in zip(("dhidden", "dW", "db"), fused_grads, chunked_grads)}
    del fused_grads, chunked_grads

    times = {}
    for label, fused_, cap in (("fused, gathered", True, capacity),
                               ("chunked, gathered", False, capacity),
                               ("fused, full length", True, 0)):
        times[label] = time_ms(torch, lambda: run(fused_, cap), iters=3, warmup=1)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(True, capacity)
        torch.cuda.synchronize()
    events = prof.events()
    kernel_ms = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith("lm_head.")) / 1e3
    parts = head_parts(events)
    flops, nbytes = head_cost(B, L, capacity, H, V)
    bound, by = bound_ms(flops, nbytes)
    log(f"  forward and backward, ms a micro-batch (CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; bound {bound:.3f} ms ({flops / 1e12:.2f} TFLOP, {by}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"  the fused head's device time by part (torch.profiler): "
        + ", ".join(f"{p} {parts[p]:.3f}" for p in HEAD_PARTS)
        + f"; other {kernel_ms - sum(parts.values()):.3f}; all kernels {kernel_ms:.3f} ms")
    del hidden, weight, bias
    torch.cuda.empty_cache()
    return {"times": times, "parts": parts, "bound_ms": bound, "grad_rel_l2": errs,
            "gather_rel": rel}


def phase_multitask_step(torch) -> None:
    """18 b. the multi-task train step at B=8, L=512, flagship width and a
    head of 60,000: 3 steps on the block path and the flash path against
    the plain path, dropout 0, the fused head at a capacity some batches
    overflow."""
    import dataclasses

    import numpy as np

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.data.synthetic import full_length_batches
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.ops import masked_ce
    from pl_bert_tpu_torch.training import train_step as ts

    config = Config()
    mp = dataclasses.replace(config.model_params, dropout=0.0, num_token_vocab=60_000)
    tp, L = config.training_params, config.dataset_params.max_seq_length
    rng = np.random.default_rng(SEED + 19)
    pool8 = full_length_batches(3, 8, L)
    for b in pool8:
        b["token_ids"] = rng.integers(5, mp.num_token_vocab, (8, L)).astype(np.int32)
    most = [int((b["mask_positions"] & (np.arange(L)[None] < b["lengths"][:, None]))
                .sum(1).max()) for b in pool8]
    capacity = min(most)  # the batch with the fewest gathers; the others fall back
    if max(most) <= capacity:
        raise AssertionError(f"no batch overflows capacity {capacity}: {most}")
    log(f"phase 18 b: multi-task train step (head of {mp.num_token_vocab}, fused, capacity "
        f"{capacity}; the batches' fullest rows {most}), block path (auto) and flash path "
        "(pallas) against the plain path: 3 steps, B=8, bf16, dropout 0")
    losses, uses = {}, {"auto": ("attention_block_train", "attention_block_bwd"),
                        "pallas": ("flash_attention", "flash_attention_bwd")}
    for impl in ("auto", "pallas", "eager"):
        model = init_params(build_model(dataclasses.replace(mp, attention_impl=impl),
                                        tp.mixed_precision), seed=SEED).to(DEV)
        tx = ts.make_optimizer(tp)
        state = ts.TrainState(model, tx.init(model))
        step = ts.make_train_step(model, tx, seed=tp.seed, fused_lm_head=True,
                                  lm_head_capacity=capacity)
        for c in (masked_ce.GATHERED, masked_ce.FALLBACKS):
            c.reset()
        counters = reset_counters()
        losses[impl] = [{k: float(v) for k, v in step(state, b)[1].items()} for b in pool8]
        launches = read_counters(counters)
        decided = (masked_ce.GATHERED.count, masked_ce.FALLBACKS.count)
        log(f"  {impl}: gathered {decided[0]}, full length {decided[1]}; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if decided != (1, 2):
            raise AssertionError(f"{impl}: gathered/full-length {decided}, not (1, 2)")
        needed = uses.get(impl, ()) + (("dropout_add_layernorm", "dropout_add_layernorm_bwd")
                                       if impl != "eager" else ())
        if any(launches[k] == 0 for k in needed) or (impl == "eager" and any(launches.values())):
            raise AssertionError(f"{impl}: launch counts {launches}")
        del model, state, tx
        torch.cuda.empty_cache()
    for impl in ("auto", "pallas"):
        for s, (k, p) in enumerate(zip(losses[impl], losses["eager"])):
            rel = {m: abs(k[m] - p[m]) / abs(p[m]) for m in ("loss", "grad_norm")}
            ok = all(rel[m] <= TRAIN_TOL[m] for m in rel) and all(
                np.isfinite(k[m]) for m in ("loss", "grad_norm", "token_loss"))
            log(f"  {impl} step {s}: loss {k['loss']:.6f} vs {p['loss']:.6f} (token "
                f"{k['token_loss']:.6f} vs {p['token_loss']:.6f}; rel {rel['loss']:.2e}), "
                f"grad_norm {k['grad_norm']:.6f} vs {p['grad_norm']:.6f} "
                f"(rel {rel['grad_norm']:.2e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"multi-task step {s}: {impl} path off the plain path: {rel}")


def phase_production_run(torch, workdir: str) -> tuple[dict, dict]:
    """18 c. bench.py's production run through ``training.train.train()``:
    the multi-task model (a head of 60,000), packed short samples masked
    on the device, ``attention_impl: pallas``, the fused head at capacity
    144, gradient accumulation 2 of B=96, L=512, bf16, dropout 0.1; then
    ``training/evaluate.py`` on its last checkpoint, and
    ``training/profile.py --multitask`` for the step's breakdown."""
    import contextlib

    import numpy as np

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.ops import masked_ce
    from pl_bert_tpu_torch.training import profile
    from pl_bert_tpu_torch.training.evaluate import evaluate
    from pl_bert_tpu_torch.training.train import make_synthetic_corpus, train

    out_dir = os.path.join(workdir, "runs")
    config_path = os.path.join(workdir, "production.yml")
    run_dir = os.path.join(out_dir, "production")
    with open(config_path, "w", encoding="utf-8") as f:
        f.write(MT_CONFIG.format(out=out_dir, steps=MT_STEPS, save=MT_STEPS,
                                 dataset=MT_DATASET))
    config = Config.load(config_path)
    tp, mp = config.training_params, config.model_params
    # the training_dataset spec's corpus (bench.py's short samples with
    # random grapheme ids), made once for the run and the evaluation
    corpus = make_synthetic_corpus(6000, token_vocab=mp.num_token_vocab,
                                   words_per_sample=(8, 30))
    log(f"phase 18 c: the production run through training.train.train(): a head of "
        f"{mp.num_token_vocab}, packed, pallas, fused head at capacity {tp.lm_head_capacity}, "
        f"{tp.grad_accum_steps} x B={tp.batch_size}, L=512, bf16, dropout {mp.dropout}, "
        f"{MT_STEPS} steps")

    for c in (masked_ce.GATHERED, masked_ce.FALLBACKS):
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    printed = Tee()
    counters = reset_counters()  # the multi-task path's run starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed), timed_steps(torch, timed=False) as trainers:
        final = train({"config_path": config_path, "run_name": "production", "device": DEV},
                      dataset=corpus)
    wall = time.perf_counter() - t0
    launches = read_counters(counters)  # the multi-task path's run ends here
    peak = torch.cuda.max_memory_allocated()
    decided = (masked_ce.GATHERED.count, masked_ce.FALLBACKS.count)
    if final != MT_STEPS:
        raise AssertionError(f"the production run stopped at step {final}")
    with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]
    vals = [r for r in records if "val_token_loss" in r]
    keys = ("loss", "phoneme_loss", "token_loss")
    if [r["step"] for r in steps] != list(range(1, MT_STEPS + 1)) or not all(
            np.isfinite(r[k]) and r["token_loss"] > 0 for r in steps for k in keys):
        raise AssertionError(f"production run metrics: {steps}")
    val_keys = ("val_phoneme_loss", "val_masked_accuracy", "val_token_loss",
                "val_token_accuracy")
    if [r["step"] for r in vals] != [0, MT_STEPS] or not all(
            np.isfinite(r[k]) for r in vals for k in val_keys):
        raise AssertionError(f"production run validation: {vals}")

    n = mp.num_hidden_layers
    micro = MT_STEPS * tp.grad_accum_steps
    evals = validation_forwards(trainers[0])
    expect = {**dict.fromkeys(launches, 0), **path_launches("pallas", n, micro, evals)}
    log(f"  launch counters over {MT_STEPS} steps ({micro} micro-batches) and {evals} "
        f"validation forwards: {launches}")
    if evals < 1 or launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    # the rows' occupancy from the packing line's row count: short samples
    # are never cropped, so the rows hold every sample's phonemes and
    # separators
    rows = int(printed.getvalue().split("samples → ")[1].split(" rows")[0])
    occupancy = sum(min(sum(len(w) + 1 for w in r["phonemes"]), 512) for r in corpus) / (
        rows * 512)
    sps = float(np.median([r["steps_per_sec"] for r in steps if "steps_per_sec" in r]))
    positions = sps * tp.grad_accum_steps * tp.batch_size * config.dataset_params.max_seq_length
    log(f"  losses {[round(r['loss'], 4) for r in steps]} (token "
        f"{[round(r['token_loss'], 4) for r in steps]}); validation "
        + "; ".join(f"step {r['step']}: " + ", ".join(f"{k} {r[k]:.4f}" for k in val_keys)
                    for r in vals))
    log(f"  production run: {1e3 / sps:.1f} ms a step (median), {positions * occupancy:.0f} "
        f"real tokens/s at {occupancy:.1%} occupancy; peak device memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes); the capacity gather held {decided[0]} times and fell back to the "
        f"full length {decided[1]} times (training and validation); the call took "
        f"{wall:.1f} s with set-up, validation and a checkpoint")

    log("phase 18 c: training/evaluate.py on the run's last checkpoint")
    scored = evaluate({"checkpoint": run_dir, "config_path": config_path, "device": DEV},
                      dataset=corpus)
    if not scored["checkpoint"].endswith(f"step_{MT_STEPS}.pth") or any(
            abs(scored[k] - vals[-1][k]) > 1e-5 * max(abs(vals[-1][k]), 1.0)
            for k in val_keys):
        raise AssertionError(f"evaluate {scored} is not the run's validation {vals[-1]}")
    log("phase 18 c: training/profile.py --multitask (the step's kernels by group, the head "
        "by part)")
    profile.main(["--multitask", "--steps", "3", "--top", "12"])
    run = {"step_ms": 1e3 / sps, "tokens_per_s": positions * occupancy,
           "occupancy": occupancy, "peak_bytes": peak, "gathered": decided[0],
           "fallbacks": decided[1], "steps": steps}
    return run, launches


def phase_microbench(torch) -> dict:
    """17. the fused-LN microbench through its own entry."""
    from pl_bert_tpu_torch.tools import bench_fused_ln

    log("phase 17: the fused-LN microbench (copy anchor K9, K5, K5+K6, plain)")
    counters = reset_counters()  # the microbench's run starts here
    bench_fused_ln.main(["--steps", "5"])
    launches = read_counters(counters)  # the microbench's run ends here
    # the anchor's case: the warm-up chains and the one captured in a graph
    # (its five timed replays launch no wrapper)
    expect = bench_fused_ln.CALLS * (bench_fused_ln.WARMUP + 1)
    if launches["add_copy"] != expect:
        raise AssertionError(f"add_copy launched {launches['add_copy']} times, not {expect}")
    return launches


def vm_rss() -> int:
    """This process's resident set in bytes (``VmRSS`` of /proc/self/status)."""
    with open("/proc/self/status", encoding="ascii") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def run_module(args: list[str], env: dict | None = None,
               timeout: float = 900) -> subprocess.CompletedProcess:
    """``python -m <args>`` from this checkout in a session of its own,
    output captured; the whole session is killed if it outlives
    ``timeout`` or this call is interrupted, so no child outlives it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], cwd=HERE, env={**os.environ, **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def hold_losses(got: list[dict], want: list[dict], label: str) -> bool:
    """Hold a run's per-step losses (metrics.jsonl records) to another
    run's under the train step's loss gate; True when every one is
    bitwise."""
    if [r["step"] for r in got] != [r["step"] for r in want]:
        raise AssertionError(f"{label}: steps {[r['step'] for r in got]}")
    worst, differ = 0.0, []
    for g, w in zip(got, want):
        for k in ("loss", "phoneme_loss", "token_loss"):
            worst = max(worst, abs(g[k] - w[k]) / max(abs(w[k]), 1e-12))
            if g[k] != w[k]:
                differ.append(f"step {g['step']} {k} {g[k]!r} vs {w[k]!r}")
    bitwise = not differ
    log(f"  {label}: losses {[round(r['loss'], 4) for r in got]}; largest relative "
        f"difference {worst:.2e} (gate {TRAIN_TOL['loss']:.0e}); bitwise equal: {bitwise}"
        + (f"; the first that differs: {differ[0]} ({len(differ)} of {3 * len(got)} differ)"
           if differ else ""))
    if worst > TRAIN_TOL["loss"]:
        raise AssertionError(f"{label}: losses off by {worst:.2e}")
    return bitwise


def step_records(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if "loss" in r]


def phase_store_run(torch, workdir: str, production: dict, mt_launches: dict) -> dict:
    """19 a-d. 18 c's corpus through the pack CLI, ``verify_store``, a
    Trainer run from the store and the elastic launcher."""
    import contextlib
    import itertools
    import shutil

    import numpy as np

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.data.packed import PackedSequenceDataset
    from pl_bert_tpu_torch.data.packed_store import open_packed_store
    from pl_bert_tpu_torch.data.pipeline import split_train_val
    from pl_bert_tpu_torch.models.albert import MultiTaskModel, build_model
    from pl_bert_tpu_torch.preprocess.shard_engine import combine_and_save
    from pl_bert_tpu_torch.training.train import load_training_dataset, train

    out_dir = os.path.join(workdir, "runs")
    src = os.path.join(workdir, "production")
    store = src + ".packed"

    def write_config(name: str, save: int, dataset: str) -> str:
        path = os.path.join(workdir, name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(MT_CONFIG.format(out=out_dir, steps=MT_STEPS, save=save, dataset=dataset))
        return path

    pack_config = write_config("pack.yml", MT_STEPS, MT_DATASET)
    config = Config.load(pack_config)
    tp, mp, dp = config.training_params, config.model_params, config.dataset_params
    corpus = load_training_dataset(MT_DATASET, tp.split, token_vocab=mp.num_token_vocab)
    combine_and_save([corpus], src)
    log(f"phase 19 a: 18 c's corpus ({len(corpus)} records.jsonl samples) through the pack "
        "CLI in a subprocess, one shard of packed_rows with tokens")
    t0 = time.perf_counter()
    packed = run_module(["pl_bert_tpu_torch.preprocess.pipeline", "--stage", "pack",
                         "--dataset_path", src, "--config_path", pack_config])
    pack_s = time.perf_counter() - t0
    if packed.returncode:
        raise AssertionError(f"the pack stage exited {packed.returncode}:\n{packed.stderr[-3000:]}")
    routes = [line for line in packed.stdout.splitlines() if line.startswith("pack_batch calls:")]
    log(f"  {routes}, the subprocess took {pack_s:.1f} s")
    calls = dict(part.split() for part in routes[0].split(": ", 1)[1].split(", ")) if len(
        routes) == 1 else {}
    if int(calls.get("native", 0)) < 1 or int(calls.get("numpy", 1)) != 0:
        raise AssertionError(f"the native packer did not pack the store: {packed.stdout[-2000:]}")
    reader = open_packed_store(store)
    meta = reader.meta
    if (meta["kind"], len(meta["shards"]), meta["has_tokens"], meta["num_samples"]) != (
            "packed_rows", 1, True, len(corpus)):
        raise AssertionError(f"store meta: {meta}")
    ram = PackedSequenceDataset(corpus, dp.max_seq_length, token_separator=dp.word_separator)
    if len(ram) != len(reader):
        raise AssertionError(f"store rows {len(reader)} != 18 c's {len(ram)}")
    train_idx, val_idx = split_train_val(len(ram), seed=tp.seed)
    streams = {f"train epoch {e}": dict(epoch=e, seed=tp.seed, indices=train_idx)
               for e in (0, 1)}
    streams["validation snapshot"] = dict(epoch=0, shuffle=False, drop_last=False,
                                          indices=val_idx)
    compared = 0
    for name, kw in streams.items():
        pairs = itertools.zip_longest(reader.batches(tp.batch_size, **kw),
                                      ram.batches(tp.batch_size, **kw))
        for i, (a, b) in enumerate(pairs):
            if a is None or b is None or set(a) != set(b) or any(
                    a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]) for k in b):
                raise AssertionError(f"the store's {name} batch {i} is not 18 c's")
            compared += 1
    log(f"  store: {meta['num_rows']} rows, {meta['total_tokens']} tokens; its {compared} "
        f"batches of train epochs 0 and 1 and the validation snapshot equal the in-RAM "
        "PackedSequenceDataset's bit for bit")

    log("phase 19 b: python -m pl_bert_tpu_torch.data.verify_store on the store, then on a "
        "copy with one shard file cut short")
    verified = run_module(["pl_bert_tpu_torch.data.verify_store", store])
    if verified.returncode or not verified.stdout.startswith("OK (full scan)"):
        raise AssertionError(f"verify_store: rc {verified.returncode}\n{verified.stdout}"
                             f"{verified.stderr[-2000:]}")
    damaged = os.path.join(workdir, "damaged.packed")
    shutil.copytree(store, damaged)
    victim = os.path.join(damaged, meta["shards"][0]["dir"], "label_ids.npy")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 1024)
    refused = run_module(["pl_bert_tpu_torch.data.verify_store", damaged])
    shutil.rmtree(damaged)
    log(f"  {verified.stdout.strip()} (rc 0); the cut copy: rc {refused.returncode}, "
        f"{refused.stderr.strip()[:200]}")
    if refused.returncode == 0 or not refused.stderr.startswith("CORRUPT: "):
        raise AssertionError("verify_store passed a store with a truncated shard file")

    log(f"phase 19 c: training.train.train() on the store, {MT_STEPS} steps of 18 c's "
        "configuration")
    store_config = write_config("store.yml", MT_STEPS, store)
    printed = Tee()
    counters = reset_counters()  # the store run starts here
    with contextlib.redirect_stdout(printed):
        final = train({"config_path": store_config, "run_name": "store", "device": DEV})
    launches = read_counters(counters)  # the store run ends here
    if final != MT_STEPS or "memory-mapped packed store: " not in printed.getvalue():
        raise AssertionError(f"the store run stopped at step {final} or did not read the store")
    log(f"  launch counters: {launches}")
    if launches != mt_launches:
        raise AssertionError(f"store run launches {launches} != 18 c's {mt_launches}")
    steps = step_records(os.path.join(out_dir, "store"))
    bitwise_c = hold_losses(steps, production["steps"], "store run against 18 c")
    sps = float(np.median([r["steps_per_sec"] for r in steps if "steps_per_sec" in r]))

    log("phase 19 d: python -m pl_bert_tpu_torch.training.orchestrate --max_restarts 2 "
        "--restart_delay 0 on the store, save_interval 3, PLBERT_CRASH_AT_STEP=4")
    elastic_config = write_config("elastic.yml", 3, store)
    torch.cuda.empty_cache()  # room for the children on the card
    t0 = time.perf_counter()
    launched = run_module(
        ["pl_bert_tpu_torch.training.orchestrate", "--config_path", elastic_config,
         "--run_name", "elastic", "--max_restarts", "2", "--restart_delay", "0"],
        env={"PLBERT_CRASH_AT_STEP": "4"})
    elastic_s = time.perf_counter() - t0
    run_dir = os.path.join(out_dir, "elastic")
    lines = [line for line in launched.stdout.splitlines()
             if "preemption_count" in line or "Training child exited" in line
             or "Training completed" in line]
    log("  " + "; ".join(lines) + f" (launcher rc {launched.returncode}, {elastic_s:.1f} s)")
    if launched.returncode:
        raise AssertionError(f"the launcher exited {launched.returncode}:\n"
                             f"{launched.stdout[-2000:]}\n{launched.stderr[-3000:]}")
    with open(os.path.join(run_dir, "restart_tracker.json"), encoding="utf-8") as f:
        restarts = json.load(f)["count"]
    saved = sorted(n for n in os.listdir(run_dir) if n.startswith("step_"))
    records = step_records(run_dir)
    if ("Training child exited rc=17 (attempt 1)" not in launched.stdout or restarts != 1
            or saved != ["step_3.pth", "step_6.pth"]
            or [r["step"] for r in records] != [1, 2, 3, 4, 4, 5, 6]):
        raise AssertionError(f"elastic run: tracker {restarts}, checkpoints {saved}, steps "
                             f"{[r['step'] for r in records]}")
    last = list({r["step"]: r for r in records}.values())  # the resumed child's step 4
    bitwise_d = hold_losses(last, steps, "orchestrated run against 19 c")
    ckpt = torch.load(os.path.join(run_dir, "step_6.pth"), map_location="cpu",
                      weights_only=True)
    fresh = build_model(mp, tp.mixed_precision)
    if not isinstance(fresh, MultiTaskModel) or ckpt["step"] != MT_STEPS:
        raise AssertionError("step_6.pth: wrong step or model")
    fresh.load_state_dict(ckpt["net"], strict=True)
    log("  step_6.pth loads strictly into a fresh MultiTaskModel")
    return {"pack_s": pack_s, "batches_compared": compared, "step_ms": 1e3 / sps,
            "bitwise_c": bitwise_c, "bitwise_d": bitwise_d, "elastic_s": elastic_s,
            "launches": launches}


def phase_store_feed(workdir: str, step_ms: float) -> dict:
    """19 e. bench.py::run_store_feed at its own settings on the port: a
    rows store of 50,000 samples of 40-120 words from a 4,096-word pool,
    then 400 shuffled batches of 96 × 512 after a 20-batch warm-up; the
    feed against the production step's demand (2 × 96 rows a step)."""
    import numpy as np

    from pl_bert_tpu_torch.data.packed_store import open_packed_store, write_packed_store

    batch, seq = 96, 512
    pool_rng = np.random.default_rng(11)
    alphabet = np.array(list("ɑɐɒæbdfɡhijklmnopqrstuvwzʃʒθðŋɹɾʔˈˌː"))
    word_pool = ["".join(pool_rng.choice(alphabet, size=int(n)))
                 for n in pool_rng.integers(2, 10, size=4096)]

    def gen():
        rng = np.random.default_rng(12)
        for _ in range(FEED_SAMPLES):
            idx = rng.integers(0, len(word_pool), size=int(rng.integers(40, 120)))
            yield {"phonemes": [word_pool[i] for i in idx]}

    path = os.path.join(workdir, "feed.packed")
    log(f"phase 19 e: the store feed (bench.py run_store_feed): {FEED_SAMPLES} samples of "
        f"40-120 words packed as rows, {FEED_BATCHES} shuffled batches of {batch} x {seq} "
        f"after {FEED_WARMUP} warm-up batches")
    t0 = time.perf_counter()
    write_packed_store(gen(), path, max_seq_length=seq)
    pack_s = time.perf_counter() - t0
    store_bytes = sum(os.path.getsize(os.path.join(d, n))
                      for d, _, names in os.walk(path) for n in names)
    rss0 = vm_rss()
    t0 = time.perf_counter()
    reader = open_packed_store(path)
    open_ms = 1e3 * (time.perf_counter() - t0)
    rng = np.random.default_rng(0)
    for _ in range(FEED_WARMUP):
        reader.batch(np.sort(rng.integers(0, len(reader), batch)))
    n = real = 0
    t0 = time.perf_counter()
    for epoch in (1, 2):
        for b in reader.batches(batch, epoch, seed=3):
            n += 1
            real += int(b["lengths"].sum())
            if n >= FEED_BATCHES:
                break
        if n >= FEED_BATCHES:
            break
    dt = time.perf_counter() - t0
    growth = vm_rss() - rss0
    rows_s = n * batch / dt
    demand = 2 * batch / (step_ms / 1e3)
    feed = {"store_bytes": store_bytes, "pack_s": pack_s, "open_ms": open_ms,
            "rows_per_s": rows_s, "tokens_per_s": rows_s * seq, "real_tokens_per_s": real / dt,
            "rss_growth": growth, "demand_rows_per_s": demand}
    log(f"  store {store_bytes} bytes ({len(reader)} rows, {reader.meta['num_long_rows']} long) "
        f"packed in {pack_s:.1f} s; open {open_ms:.3f} ms; {n} batches in {dt:.3f} s: "
        f"{rows_s:.0f} rows/s, {rows_s * seq:.0f} token positions/s, {real / dt:.0f} real "
        f"tokens/s; VmRSS growth over the read pass {growth} bytes "
        f"({growth / store_bytes:.2%} of the store); the production step needs {demand:.0f} "
        f"rows/s (2 x {batch} rows at {step_ms:.1f} ms), so the feed is {rows_s / demand:.1f}x "
        "the demand")
    if growth >= store_bytes / 4:
        raise AssertionError(f"VmRSS grew {growth} bytes reading a {store_bytes}-byte store")
    if rows_s < demand:
        raise AssertionError(f"the store feeds {rows_s:.0f} rows/s, the step needs {demand:.0f}")
    return feed


def int8_bound(M: int, K: int, N: int, out_itemsize: int = 2) -> float:
    """The least time for an int8 dense layer [M, K] x [N, K]ᵀ: the bf16
    input read and the output written once, the int8 weight read once,
    against the int8 operations at the card's int8 peak."""
    nbytes = M * K * 2 + N * K + M * N * out_itemsize
    return bound_ms(2 * M * K * N, nbytes, PEAK_INT8_OPS)[0]


def phase_deploy(torch, sd, mt_dir: str, smi: str) -> dict:
    """20. the deployment path: the export CLI on 18 c's checkpoint,
    ``from_hf_export`` against ``from_checkpoint``, the int8 encoder held
    to its plain version and to the bf16 one, the server on ``--hf_dir
    --int8`` and its ``/reload``, and the int8 forward timed."""
    import collections
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.export import cli as export_cli
    from pl_bert_tpu_torch.export.to_hf import export_checkpoint
    from pl_bert_tpu_torch.models.albert import AlbertModel
    from pl_bert_tpu_torch.models.inference import PhonemeEncoder
    from pl_bert_tpu_torch.ops import quant
    from pl_bert_tpu_torch.serving.client import ServingClient
    from pl_bert_tpu_torch.serving.server import build_server, serve_in_thread

    t_phase = time.perf_counter()
    config_path = os.path.join(mt_dir, "production.yml")
    ckpt = os.path.join(mt_dir, "runs", "production", f"step_{MT_STEPS}.pth")
    exports = os.path.join(mt_dir, "exports")
    production = os.path.join(exports, "production")
    config = Config.load(config_path)
    vocab, hidden = config.model_params.num_token_vocab, config.model_params.hidden_size
    L = config.dataset_params.max_seq_length
    log(f"phase 20 a: python -m pl_bert_tpu_torch.export.cli on 18 c's step_{MT_STEPS}.pth (the "
        f"multi-task model, a head of {vocab}) in a subprocess")
    t0 = time.perf_counter()
    done = run_module(["pl_bert_tpu_torch.export.cli", "--checkpoint_path", ckpt,
                       "--config_path", config_path, "--output_dir", production], timeout=600)
    export_s = time.perf_counter() - t0
    if done.returncode:
        raise AssertionError(f"the export CLI exited {done.returncode}:\n{done.stderr[-3000:]}")
    files = sorted(os.listdir(production))
    head = torch.load(os.path.join(production, "pl_bert_full_model.pt"),
                      weights_only=True)["token_predictor.weight"]
    with open(os.path.join(production, "training_metadata.txt"), encoding="utf-8") as f:
        meta = f.read()
    log(f"  {files} in {export_s:.1f} s; token_predictor.weight {tuple(head.shape)}; "
        + "; ".join(meta.splitlines()))
    if files != ["config.json", "config.yml", "model.safetensors", "pl_bert_full_model.pt",
                 "training_metadata.txt"] or tuple(head.shape) != (vocab, hidden) or (
            f"Step: {MT_STEPS}" not in meta):
        raise AssertionError(f"the export wrote {files}, a head of {tuple(head.shape)}, {meta!r}")

    rng = np.random.default_rng(SEED + 20)
    texts = [phoneme_text(rng, n) for n in (512, 500, 384, 256, 128, 64, 5, 300)]
    kw = {"batch_size": MAX_BATCH, "device": DEV}
    hf = PhonemeEncoder.from_hf_export(production, **kw)
    pth = PhonemeEncoder.from_checkpoint(ckpt, config_path, **kw)
    ids, mask, _ = hf.encode_batch(texts)
    a, b = hf.forward(ids, mask), pth.forward(ids, mask)
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    log(f"phase 20 b: from_hf_export against from_checkpoint(step_{MT_STEPS}.pth), "
        f"B={MAX_BATCH} L={ids.shape[1]} bf16, the {hf.model.encoder.layer.attention.impl} path: "
        f"hidden states bitwise equal {same}")
    if not same or tuple(a.shape) != (MAX_BATCH, L, hidden):
        raise AssertionError(f"from_hf_export's hidden states {tuple(a.shape)} differ")
    del hf, pth, a, b

    # the same checkpoint for serving on the block path (attention_impl auto)
    serving_yml = os.path.join(mt_dir, "serving.yml")
    with open(config_path, encoding="utf-8") as f:
        text = f.read()
    with open(serving_yml, "w", encoding="utf-8") as f:
        f.write(text.replace("attention_impl: pallas", "attention_impl: auto"))
    serving = os.path.join(exports, "serving")
    export_cli.main(["--checkpoint_path", ckpt, "--config_path", serving_yml,
                     "--output_dir", serving])
    enc16 = PhonemeEncoder.from_hf_export(serving, **kw)
    enc8 = PhonemeEncoder.from_hf_export(serving, quantize="int8", **kw)
    n = enc8.cfg.num_hidden_layers
    log(f"phase 20 c: int8 at the serving shape: B={MAX_BATCH} L={L} bf16, the "
        f"{enc8.model.encoder.layer.attention.impl} path")
    sites = []
    real = quant.int8_linear

    def record(x, wq, w_scale, bias=None, out_dtype=None):
        sites.append((x, wq, w_scale, bias, out_dtype))
        return real(x, wq, w_scale, bias, out_dtype)

    quant.int8_linear = record  # observe the forward's int8 sites
    try:
        out8 = enc8.forward(ids, mask)
    finally:
        quant.int8_linear = real
    torch.cuda.synchronize()
    shapes = collections.Counter(
        f"[{x.reshape(-1, x.shape[-1]).shape[0]}, {x.shape[-1]}] x [{wq.shape[0]}, "
        f"{wq.shape[1]}]ᵀ" for x, wq, *_ in sites)
    for x, wq, w_scale, bias, dt in sites:
        q, _ = quant.quantize_rows(x.reshape(-1, x.shape[-1]))
        if not torch.equal(quant.int8_matmul(q, wq), quant.int8_matmul_plain(q, wq)) or (
                not torch.equal(real(x, wq, w_scale, bias, dt),
                                quant.int8_linear_plain(x, wq, w_scale, bias, dt))):
            raise AssertionError(f"int8 site {tuple(x.shape)} x {tuple(wq.shape)}: _int_mm "
                                 "differs from the fp64 product")
    log(f"  {len(sites)} int8 sites a forward ({', '.join(f'{s}: {c}' for s, c in shapes.items())}"
        "): every site's _int_mm accumulators equal the fp64 product's bit for bit, and its "
        "output the plain version's")
    if len(sites) != 2 * n + 2:
        raise AssertionError(f"{len(sites)} int8 sites, not {2 * n + 2}")
    # the plain version of the block path: the eager path on the block
    # path's weight set, whose attention is not quantized, runs K1's and
    # K5's plain versions around the same int8 sites
    twin = AlbertModel.from_state_dict(dataclasses.replace(enc8.cfg, attention_impl="eager"),
                                       PhonemeEncoder.hf_encoder_params(serving))
    with torch.inference_mode():
        plain8, _ = twin(torch.from_numpy(ids).to(DEV), torch.from_numpy(mask).to(DEV),
                         weights=enc8.weights)
    out16 = enc16.forward(ids, mask)
    torch.cuda.synchronize()
    valid = torch.from_numpy(mask.astype(bool)).to(DEV)
    if not torch.isfinite(out8).all():
        raise AssertionError("int8 encoder: non-finite hidden states")
    gate("int8 encoder, block path against its plain version", errors(out8[valid], plain8[valid]),
         INT8_ENCODER_TOL)
    a, b = out8[valid].float(), out16[valid].float()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    rel = errors(out8[valid], out16[valid])["rel_l2"]
    log(f"  int8 against bf16 over {int(valid.sum())} valid tokens: min cosine "
        f"{float(cos.min()):.6f} (gate {INT8_COSINE}), mean {float(cos.mean()):.6f}, rel-L2 "
        f"{rel:.3e}")
    if float(cos.min()) < INT8_COSINE:
        raise AssertionError(f"int8 against bf16: min cosine {float(cos.min())}")
    del twin, plain8, out16

    second = os.path.join(exports, "random")
    export_checkpoint({f"encoder.{k}": v for k, v in sd.items()},
                      Config.load(serving_yml).to_dict(), second)
    argv = ["--hf_dir", serving, "--int8", "--port", "0", "--max_batch", str(MAX_BATCH),
            "--device", DEV]
    log(f"phase 20 d: the server on {' '.join(argv[:3])} (no buckets: every forward "
        f"at L={L}), {DEPLOY_REQUESTS} requests from {DEPLOY_CLIENTS} client threads through "
        "the port's ServingClient")
    counters = reset_counters()  # the deployment path's run starts here
    quant.LAUNCHES.reset()
    server = build_server(argv)
    serve_in_thread(server)
    client = ServingClient(f"127.0.0.1:{server.server_address[1]}", timeout_s=300)
    try:
        sizes = [5, 500, *rng.integers(5, 501, DEPLOY_REQUESTS - 2)]
        requests = [phoneme_text(rng, int(s)) for s in sizes]
        answers: dict[int, tuple] = {}
        failures: list[BaseException] = []

        def client_loop(c: int) -> None:
            try:
                for i in range(c, len(requests), DEPLOY_CLIENTS):
                    answers[i] = client.encode(requests[i], encoding="b64")
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                failures.append(exc)
            finally:
                client.close()

        threads = [threading.Thread(target=client_loop, args=(c,)) for c in range(DEPLOY_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if failures:
            raise failures[0]
        if any(t.is_alive() for t in threads) or len(answers) != len(requests):
            raise AssertionError(f"{len(answers)} of {len(requests)} requests answered")
        stats = client.stats()
        launches = read_counters(counters)  # the deployment path's run ends here
        launches["int8_matmul"] = quant.LAUNCHES.count
        forwards = 1 + stats["batches"]  # build_server warms L=512 once
        expect = dict.fromkeys(launches, 0)
        expect.update({"attention_block": n * forwards, "dropout_add_layernorm": 2 * n * forwards,
                       "int8_matmul": (2 * n + 2) * forwards})
        log(f"  {stats['batches']} batches, mean batch {stats['mean_batch_size']:.2f}, p50 "
            f"{stats['latency_ms']['p50']:.1f} ms; launch counters over {forwards} forwards: "
            f"{launches}")
        if launches != expect:
            raise AssertionError(f"launch counts {launches} != {expect}")
        direct = PhonemeEncoder.from_hf_export(serving, quantize="int8", **kw)
        worst, equal = 0.0, 0
        for i, text in enumerate(requests):
            hidden, length = answers[i]
            ref, lengths = direct([text])
            if length != int(lengths[0]) or not np.isfinite(hidden).all():
                raise AssertionError(f"request {i}: length {length} vs {lengths[0]}")
            worst = max(worst, float(np.abs(hidden - ref[0, :length]).max()))
            equal += bool(np.array_equal(hidden, ref[0, :length]))
        log(f"  every answer against a direct int8 PhonemeEncoder call: {equal} of "
            f"{len(requests)} bitwise equal, max_abs {worst:.3e}")
        if equal != len(requests):
            raise AssertionError(f"served int8 answers differ from direct calls by {worst}")
        reply = client.reload(second)
        fresh = PhonemeEncoder.from_hf_export(second, quantize="int8", **kw)
        moved = 0
        for i, text in enumerate(requests[:4]):
            hidden, length = client.encode(text, encoding="b64")
            if not np.array_equal(hidden, fresh([text])[0][0, :length]):
                raise AssertionError(f"after /reload, request {i} differs from a direct call")
            moved += not np.array_equal(hidden, answers[i][0])
        log(f"  /reload {reply}: {moved} of 4 answers changed, each bitwise a direct int8 "
            "call on the new export's weights")
        if moved != 4:
            raise AssertionError("/reload left answers unchanged")
    finally:
        client.close()
        server.shutdown()
        server.batcher.close()
        server.server_close()
    del direct, fresh

    log(f"phase 20 e: the int8 forward against the bf16 forward, L={L}, the block path; CUDA "
        f"events around back-to-back serving forwards, host included ({smi})")
    times = {}
    for B, iters in ((MAX_BATCH, 20), (64, 10)):
        e16 = PhonemeEncoder.from_hf_export(serving, batch_size=B, device=DEV)
        e8 = PhonemeEncoder.from_hf_export(serving, batch_size=B, quantize="int8", device=DEV)
        bi, bm, _ = e16.encode_batch(texts * (B // len(texts)))
        ms8, ms16 = a_b(torch, lambda: e16.forward(bi, bm), lambda: e8.forward(bi, bm), iters)
        times[B] = (ms8, ms16)
        log(f"  B={B}: int8 {ms8:.3f} ms a forward, bf16 {ms16:.3f} ms ({ms8 / ms16:.3f}x) ({smi})")
        del e16, e8
    x, wq, w_scale, bias, dt = sites[1]  # the first FFN layer
    x2 = x.reshape(-1, x.shape[-1])
    q, x_scale = quant.quantize_rows(x2)
    acc = quant.int8_matmul(q, wq)
    w16 = enc16.weights["encoder"]["layer"]["ffn"]
    M, K, N = x2.shape[0], x2.shape[1], wq.shape[0]
    parts = {
        "quantize pass": graph_ms(torch, lambda: quant.quantize_rows(x2), 20),
        "_int_mm": graph_ms(torch, lambda: quant.int8_matmul(q, wq), 20),
        "rescale + bias": graph_ms(torch, lambda: quant.rescale(acc, x_scale, w_scale, bias, dt), 20),
        "int8 dense": graph_ms(torch, lambda: real(x2, wq, w_scale, bias, dt), 20),
        "F.linear bf16": graph_ms(torch, lambda: F.linear(x2, w16["w"], w16["b"]), 20),
    }
    bf16_bound = bound_ms(2 * M * K * N, (M * K + N * K + M * N) * 2)[0]
    log(f"  one FFN dense [{M}, {K}] x [{N}, {K}]ᵀ, device ms a call (graph replay): "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; bound int8 {int8_bound(M, K, N):.4f}, bf16 {bf16_bound:.4f} ({smi})")
    wall = time.perf_counter() - t_phase
    log(f"phase 20 took {wall:.1f} s")
    del enc8, enc16, sites, out8
    torch.cuda.empty_cache()
    return {"launches": launches, "times": times, "parts": parts, "min_cos": float(cos.min()),
            "rel_l2": rel, "wall_s": wall}


def phase_remat(torch, smi: str) -> dict:
    """21. remat on bench.py's workload, against the same run without it,
    on the block path; then on the flash path."""
    import dataclasses

    import numpy as np

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.data.synthetic import full_length_batches
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.training import train_step as ts

    t_phase = time.perf_counter()
    config = Config()  # configs/config.yml's values: bf16, B 96, L 512, AdamW 7e-5
    mp, tp = config.model_params, config.training_params
    B, L, n = tp.batch_size, config.dataset_params.max_seq_length, mp.num_hidden_layers
    pool = full_length_batches(4, B, L)

    def run(impl: str, remat: bool, warm: int, timed: int) -> dict:
        model = init_params(build_model(dataclasses.replace(mp, attention_impl=impl),
                                        tp.mixed_precision, remat=remat), seed=SEED).to(DEV)
        tx = ts.make_optimizer(tp)
        state = ts.TrainState(model, tx.init(model))
        step = ts.make_train_step(model, tx, seed=tp.seed)
        metrics = [{k: float(v) for k, v in step(state, pool[i % len(pool)])[1].items()}
                   for i in range(warm)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters()  # the remat path's run starts here
        t0 = time.perf_counter()
        for i in range(warm, warm + timed):  # a host read a step: each has finished
            metrics.append({k: float(v) for k, v in step(state, pool[i % len(pool)])[1].items()})
        wall = time.perf_counter() - t0
        launches = read_counters(counters)  # the remat path's run ends here
        peak = torch.cuda.max_memory_allocated()
        del state, model, tx, step
        torch.cuda.empty_cache()
        per_step = {k: v / timed for k, v in launches.items()}
        log(f"  {impl} path, remat {remat}: losses {[round(m['loss'], 5) for m in metrics]}; "
            f"{wall / timed * 1e3:.1f} ms a step over {timed}; peak device memory "
            f"{peak / 2**30:.2f} GiB ({peak} bytes); launches a step {per_step} ({smi})")
        kernel = {"auto": "attention_block_train", "pallas": "flash_attention"}[impl]
        bwd = {"auto": "attention_block_bwd", "pallas": "flash_attention_bwd"}[impl]
        expect = dict.fromkeys(launches, 0)
        expect.update({kernel: (2 if remat else 1) * n * timed, bwd: n * timed,
                       "dropout_add_layernorm": (4 if remat else 2) * n * timed,
                       "dropout_add_layernorm_bwd": 2 * n * timed})
        if launches != expect:
            raise AssertionError(f"launch counts {launches} != {expect}")
        if not all(np.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm")):
            raise AssertionError(f"non-finite metrics: {metrics}")
        return {"metrics": metrics, "step_ms": wall / timed * 1e3, "peak": peak,
                "launches": launches}

    def compare(on: dict, off: dict, label: str) -> bool:
        worst = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(on["metrics"], off["metrics"]))
                 for k in TRAIN_TOL}
        bitwise = all(a[k] == b[k] for a, b in zip(on["metrics"], off["metrics"]) for k in TRAIN_TOL)
        log(f"  {label}: largest relative difference loss {worst['loss']:.2e}, grad_norm "
            f"{worst['grad_norm']:.2e} (gates {TRAIN_TOL['loss']:.0e}, "
            f"{TRAIN_TOL['grad_norm']:.0e}); bitwise equal: {bitwise}")
        if any(worst[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
            raise AssertionError(f"{label}: remat off the run without it: {worst}")
        return bitwise

    log(f"phase 21: remat on bench.py's workload (B={B}, L={L}, {tp.mixed_precision}, dropout "
        f"{mp.dropout}, the block path): 3 warm-up and 5 timed steps with remat off, on, and "
        "off again, from the same weights, batches and seeds (the second run without remat "
        "shows whether the step repeats bit for bit on the card without it)")
    off = run("auto", False, 3, 5)
    on = run("auto", True, 3, 5)
    again = run("auto", False, 3, 5)
    bitwise = compare(on, off, "block path, remat against none over 8 steps")
    repeats = compare(again, off, "block path, none against none over 8 steps")
    log(f"  remat: {on['step_ms']:.1f} against {off['step_ms']:.1f} ms a step "
        f"({on['step_ms'] / off['step_ms'] - 1:+.1%}); peak {on['peak'] / 2**30:.2f} against "
        f"{off['peak'] / 2**30:.2f} GiB ({(off['peak'] - on['peak']) / 1e9:.2f} GB less) ({smi})")
    log("phase 21: 2 steps on the flash path (attention_impl pallas) with remat, and without")
    flash_on = run("pallas", True, 0, 2)
    flash_off = run("pallas", False, 0, 2)
    flash_bitwise = compare(flash_on, flash_off, "flash path, remat against none over 2 steps")
    wall = time.perf_counter() - t_phase
    log(f"phase 21 took {wall:.1f} s")
    return {"on": on, "off": off, "bitwise": bitwise, "repeats": repeats,
            "flash_bitwise": flash_bitwise,
            "launches": on["launches"], "wall_s": wall}


# the sharded runs of phase 22 c/d: the flagship model (configs/config.yml
# widths, 12 applications), L 512, global batch 8, bf16; {out}, {steps},
# {data}, {model}, {zero1}, {impl}, {sp}, {dropout} and {extra} filled in
SHARDED_CONFIG = """\
training_params:
  output_dir: {out}
  mixed_precision: bf16
  batch_size: {batch}
  save_interval: 100
  log_interval: 1
  num_steps: {steps}
  data_axis: {data}
  model_axis: {model}
  zero1: {zero1}
  training_dataset: "synthetic:{samples}"
{extra}dataset_params:
  max_seq_length: 512
  ondevice_masking: true
model_params:
  attention_impl: {impl}
  dropout: {dropout}
  sequence_parallel: {sp}
{model_extra}"""
# 22 c's runs: name → (data, model, zero1, attention_impl, sequence_parallel)
SHARDED_RUNS = {
    "data 2": (2, 1, False, "auto", False),
    "data 2, zero1": (2, 1, True, "auto", False),
    "model 2": (1, 2, False, "auto", False),
    "model 2, SP": (1, 2, False, "auto", True),
    "model 2, flash": (1, 2, False, "pallas", False),
}


def sharded_config(path: str, out: str, data: int = 1, model: int = 1, zero1: bool = False,
                   impl: str = "auto", sp: bool = False, steps: int = 4, batch: int = 8,
                   dropout: float = 0.0, samples: int = 200, multitask: bool = False) -> str:
    extra = model_extra = ""
    if multitask:  # bench.py run_production's head: 60,000, fused, capacity 144
        extra = "  fused_lm_head: true\n  lm_head_capacity: 144\n"
        model_extra = "  num_token_vocab: 60000\n"
    with open(path, "w", encoding="utf-8") as f:
        f.write(SHARDED_CONFIG.format(
            out=out, steps=steps, batch=batch, data=data, model=model,
            zero1=str(zero1).lower(), samples=samples, extra=extra, impl=impl,
            dropout=dropout, sp=str(sp).lower(), model_extra=model_extra))
    return path


@contextlib.contextmanager
def timed_steps(torch, timed: bool = True):
    """Inside it, each ``training.train.Trainer`` made times its steps,
    each between two synchronisations of the card (``step_s``), counts
    the real tokens of each step's batch (``step_tokens``: the rows'
    ``lengths`` summed, read after the step's clock stops) and the
    vocabulary-parallel head's collectives a step
    (``head_collectives``); yields the list the trainers are appended to.
    With ``timed`` False the trainers are only collected, their steps left
    as they are."""
    from pl_bert_tpu_torch.ops import masked_ce
    from pl_bert_tpu_torch.training import train as train_mod

    trainers, base = [], train_mod.Trainer

    class Timed(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)
            if not timed:
                return
            step, self.step_s, self.head_collectives = self.train_step, [], []
            self.step_tokens = []

            def timed_step(state, batch):
                torch.cuda.synchronize()
                before = masked_ce.VOCAB_COLLECTIVES.count
                t0 = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                self.step_s.append(time.perf_counter() - t0)
                self.head_collectives.append(masked_ce.VOCAB_COLLECTIVES.count - before)
                self.step_tokens.append(int(batch["lengths"].sum()))
                return out

            self.train_step = timed_step

    train_mod.Trainer = Timed
    try:
        yield trainers
    finally:
        train_mod.Trainer = base


def validation_forwards(trainer) -> int:
    """The eval forwards of a fresh run of ``trainer``'s config, from the
    config and its validation split: each of its validation batches once
    before the first step and again every ``val_interval`` (else
    ``save_interval``) steps."""
    tp = trainer.config.training_params
    return len(trainer._val_cache) * (1 + tp.num_steps // (tp.val_interval or tp.save_interval))


def path_launches(impl: str, n: int, micro: int, evals: int) -> dict:
    """The launches a run of ``micro`` training forwards and backwards and
    ``evals`` eval forwards makes through ``n`` layers: on the block path
    (``auto``) K3/K4 a training layer, K1 an eval layer; on the flash path
    (``pallas``) K7 a forward layer, K8 a backward layer; K5 twice a
    forward layer and K6 twice a backward layer on both."""
    if impl == "auto":
        out = {"attention_block": n * evals, "attention_block_train": n * micro,
               "attention_block_bwd": n * micro}
    else:
        out = {"flash_attention": n * (micro + evals), "flash_attention_bwd": n * micro}
    out.update({"dropout_add_layernorm": 2 * n * (micro + evals),
                "dropout_add_layernorm_bwd": 2 * n * micro})
    return out


def median_step_ms(step_s: list) -> float:
    """The median of a run's step times past its first, in ms."""
    ms = sorted(t * 1e3 for t in step_s[1:])
    return ms[len(ms) // 2]


def sharded_rank(spec: dict) -> None:
    """One rank of a 22 c/d run (this script run with ``--sharded-rank``):
    ``training.train.train()`` on the card over gloo, then what the parent
    checks, as JSON in ``spec["result"]``: the launch counts, the local
    head count, ms a step (each step timed between two synchronisations),
    the peak device memory and a digest of each replicated parameter."""
    import hashlib

    os.environ.update(PLBERT_DISTRIBUTED="1", PLBERT_COORDINATOR=f"localhost:{spec['port']}",
                      PLBERT_NUM_PROCESSES=str(spec["world"]),
                      PLBERT_PROCESS_ID=str(spec["rank"]), PLBERT_DIST_BACKEND="gloo")
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from pl_bert_tpu_torch.parallel.mesh import param_spec
    from pl_bert_tpu_torch.training.train import train

    torch.backends.cuda.matmul.allow_tf32 = False
    with timed_steps(torch) as trainers:
        counters = reset_counters()  # this rank's run starts here
        final = train({"config_path": spec["config"], "run_name": spec["run"], "device": DEV})
        launches = read_counters(counters)  # and ends here
    trainer = trainers[0]

    def digest(t) -> str:
        return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()

    digests = {n: digest(p) for n, p in trainer.model.named_parameters()
               if param_spec(n) is None}
    result = {"final": final, "launches": launches, "evals": validation_forwards(trainer),
              "local_heads": trainer.model.cfg.local_heads, "step_s": trainer.step_s,
              "peak": torch.cuda.max_memory_allocated(), "digests": digests,
              "head_collectives": trainer.head_collectives}
    vocab = getattr(trainer.model, "vocab_slice", lambda: None)()
    if vocab is not None:  # 22 d: this rank's rows of the head, and the head whole
        result.update(vocab_parallel_head(torch, trainer, vocab, digest))
    with open(spec["result"], "w", encoding="utf-8") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def vocab_parallel_head(torch, trainer, vocab, digest) -> dict:
    """22 d, on each rank: the rows of the head (and of its moments) this
    rank holds, a digest of the head gathered whole, and the head's
    collectives of one gathered micro-batch (capacity 144, chunks of 48
    positions) timed over the model group: per chunk the MAX all-reduce
    of [rows] and the SUM of [2, rows] fp32, then the fp32 dh all-reduce
    once, each the median of 5 between two synchronisations."""
    from pl_bert_tpu_torch.ops.masked_ce import chunk_size_for
    from pl_bert_tpu_torch.parallel import collectives as col

    head = dict(trainer.model.named_parameters())
    weight, bias = head["token_predictor.weight"], head["token_predictor.bias"]
    tp = trainer.config.training_params
    B, cap, H = tp.batch_size, tp.lm_head_capacity, weight.shape[1]
    c = chunk_size_for(cap, 64)

    def timed(fn) -> float:
        out = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return sorted(out[1:])[2]

    rows = torch.zeros(B * c, device=DEV)
    pair = torch.zeros(2, B * c, device=DEV)
    dh = torch.zeros(B, cap, H, device=DEV)
    ms = {"max": timed(lambda: col.all_reduce_(rows, vocab.group, col.dist.ReduceOp.MAX)),
          "sum": timed(lambda: col.all_reduce_(pair, vocab.group)),
          "dh": timed(lambda: col.all_reduce_(dh, vocab.group))}
    return {"head_rows": weight.shape[0], "head_start": vocab.start,
            "moment_rows": [t.shape[0] for t in trainer.state.opt_state.moments[
                "token_predictor.weight"]],
            "head_whole": {n: digest(col.all_gather_uneven(p.detach(), vocab.group, 0))
                           for n, p in (("token_predictor.weight", weight),
                                        ("token_predictor.bias", bias))},
            "head_collective_ms": ms, "head_chunks": cap // c}


def run_ranks(config: str, run: str, world: int, workdir: str) -> list[dict]:
    """A 22 c/d run: one process a rank, all on the one card."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, results, logs = [], [], []
    for rank in range(world):
        spec = {"config": config, "run": run, "world": world, "rank": rank, "port": port,
                "result": os.path.join(workdir, f"{run}.rank{rank}.json")}
        logs.append(os.path.join(workdir, f"{run}.rank{rank}.log"))
        with open(logs[-1], "w", encoding="utf-8") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--sharded-rank",
                 json.dumps(spec)], cwd=HERE, stdout=f, stderr=subprocess.STDOUT))
        results.append(spec["result"])
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (code, path) in enumerate(zip(codes, logs)):
        if code:
            with open(path, encoding="utf-8") as f:
                log(f.read()[-6000:])
            raise AssertionError(f"{run}: rank {rank} exited {code}")
    out = []
    for path in results:
        with open(path, encoding="utf-8") as f:
            out.append(json.load(f))
    return out


def metrics_steps(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [r for r in map(json.loads, f) if "grad_norm" in r]


def compare_runs(got: list[dict], want: list[dict], label: str) -> bool:
    """Losses and grad norms within TRAIN_TOL of ``want``'s; whether bitwise."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} steps against {len(want)}")
    worst = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got, want))
             for k in TRAIN_TOL}
    bitwise = all(a[k] == b[k] for a, b in zip(got, want) for k in TRAIN_TOL)
    ok = all(worst[k] <= TRAIN_TOL[k] for k in TRAIN_TOL) and all(
        np_isfinite(a[k]) for a in got for k in TRAIN_TOL)
    log(f"  {label}: largest relative difference loss {worst['loss']:.2e}, grad_norm "
        f"{worst['grad_norm']:.2e} (gates {TRAIN_TOL['loss']:.0e}, "
        f"{TRAIN_TOL['grad_norm']:.0e}); bitwise: {bitwise} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: off the reference run: {worst}")
    return bitwise


def np_isfinite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


def phase_sharded_kernels(torch, results: dict, smi: str, per_draw: dict,
                          clock_mhz: float) -> dict:
    """22 a. K1/K3 with the fp32 output of a tensor-parallel shard at
    [8, 512, 768] with 6 heads of 64 (P = 384), bf16, at dropout 0 and 0.1,
    against their plain versions; K4 from those saved tensors; K3 at P =
    192, forward only; then each timed at P = 384 beside its plain version,
    its library call and its bound."""
    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops.attention import NEG

    rng = np.random.default_rng(SEED + 22)
    B, L, E, dt, f32 = 8, 512, 768, torch.bfloat16, torch.float32
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(DEV)  # noqa: E731
    lengths = np.array([512, 480, 384, 256, 128, 64, 5, 0])
    bias_row, _ = ab.rows(attention_bias_from_mask(to(np.arange(L)[None, :] < lengths[:, None])),
                          None, B, L)
    x = to(rng.standard_normal((B, L, E)) * 0.5).to(dt)
    dout = to(rng.standard_normal((B, L, E))).to(dt)
    zero = torch.zeros(E, device=DEV)
    log(f"phase 22 a: K1/K3 writing the fp32 partial output of a tensor-parallel shard "
        f"(6 heads of 64, P = 384; zero output bias), [{B}, {L}, {E}] bf16, against their "
        "plain versions; K4 from K3's saved tensors; K3 at P = 192 (3 heads)")
    weights = {}
    for heads in (6, 3):
        P = 64 * heads
        wqkv = to(rng.standard_normal((E, 3 * P)) * 0.05).to(dt)
        bqkv = to(rng.standard_normal(3 * P) * 0.02)
        wo = to(rng.standard_normal((P, E)) * 0.05).to(dt)
        weights[heads] = (wqkv, bqkv, wo)
        for rate in ((0.0, 0.1) if heads == 6 else (0.0,)):
            seed = 4321 if rate else None
            keep = ab.dropout_mask(seed, rate, B, heads, L, DEV) if rate else None
            tag = f"P = {P} dropout {rate}"
            out, saved = ab.train_forward(x, wqkv, bqkv, wo, zero, heads, bias_row, None, rate,
                                          seed, out_dtype=f32)
            ref, ref_saved = ab.train_forward_plain(x, wqkv, bqkv, wo, zero, heads, bias_row,
                                                    None, rate, seed, keep=keep, out_dtype=f32)
            if out.dtype != f32:
                raise AssertionError(f"K3 wrote {out.dtype}, not float32")
            for name, a, r in [("out (fp32)", out, ref), ("qkv", saved[0], ref_saved[0]),
                               ("ctx", saved[1], ref_saved[1])]:
                hold(results, "attention_block_train", f"K3 {name} {tag}", a, r,
                     TOL["bfloat16"])
            rounded, _ = ab.train_forward(x, wqkv, bqkv, wo, zero, heads, bias_row, None, rate,
                                          seed)
            if not torch.equal(out.to(dt), rounded):
                raise AssertionError(f"K3's fp32 output does not round to its bf16 one ({tag})")
            log(f"  K3's fp32 output rounded to bf16 == its bf16 output bitwise ({tag})")
            if heads == 3:
                continue
            light = ab.attention_block_packed(x, wqkv, bqkv, wo, zero, heads,
                                              bias=attention_bias_from_mask(
                                                  to(np.arange(L)[None, :] < lengths[:, None])),
                                              out_dtype=f32, dropout_rate=rate,
                                              dropout_seed=seed)
            if not torch.equal(light, out):
                raise AssertionError(f"K1's fp32 output is not K3's ({tag})")
            results["attention_block"].append(errors(light, ref)["max_abs"])
            log(f"  K1 fp32 output == K3 fp32 output bitwise ({tag})")
            dx, dqkv = ab.train_backward(dout, x, wqkv, wo, saved, heads, bias_row, None, rate,
                                         seed)
            rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, heads, bias_row,
                                                 None, rate, seed, keep=keep)
            x2, d2 = x.reshape(B * L, E).float(), dout.reshape(B * L, E).float()
            for name, a, r in [("dx", dx, rdx), ("dqkv", dqkv, rdqkv)]:
                hold_ulp(results, "attention_block_bwd", f"K4 {name} {tag}", a, r,
                         TOL["bfloat16"])
            for name, a, r in [
                ("dWqkv", x2.T @ dqkv.float(), x2.T @ rdqkv.float()),
                ("dWo", saved[1].float().T @ d2, ref_saved[1].float().T @ d2),
            ]:
                hold(results, "attention_block_bwd", f"K4 {name} {tag}", a, r,
                     TOL_GRAD["bfloat16"])
            del saved, ref_saved, keep, dx, dqkv, rdx, rdqkv

    shard_rows = hold_sharded_rows(torch, results, rng, bias_row, smi, per_draw, clock_mhz)
    rowpar = time_row_parallel(torch, rng, smi)

    # timed at P = 384, dropout 0.1, beside the plain versions and one
    # library call each: cuBLAS and SDPA over the shard's 6 heads, the
    # out-projection in fp32 (bf16 operands; speed reference only)
    wqkv, bqkv, wo = weights[6]
    H, P, rate, seed = 6, 384, 0.1, 7
    keep = ab.dropout_mask(seed, rate, B, H, L, DEV)
    bias4 = attention_bias_from_mask(to(np.arange(L)[None, :] < lengths[:, None]))
    times = {
        "attention_block": a_b(
            torch,
            lambda: ab.attention_block_plain(x, wqkv, bqkv, wo, zero, H, bias=bias4,
                                             out_dtype=f32),
            lambda: ab.attention_block_packed(x, wqkv, bqkv, wo, zero, H, bias=bias4,
                                              out_dtype=f32), iters=5),
        "attention_block_train": a_b(
            torch,
            lambda: ab.train_forward_plain(x, wqkv, bqkv, wo, zero, H, bias_row, None, rate,
                                           seed, keep=keep, out_dtype=f32),
            lambda: ab.train_forward(x, wqkv, bqkv, wo, zero, H, bias_row, None, rate, seed,
                                     out_dtype=f32), iters=5),
    }
    _, saved = ab.train_forward(x, wqkv, bqkv, wo, zero, H, bias_row, None, rate, seed,
                                out_dtype=f32)
    times["attention_block_bwd"] = a_b(
        torch,
        lambda: ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed,
                                        keep=keep),
        lambda: ab.train_backward(dout, x, wqkv, wo, saved, H, bias_row, None, rate, seed),
        iters=5)
    xg = x.detach().requires_grad_()
    ws = [t.detach().requires_grad_() for t in (wqkv, bqkv.to(dt), wo)]
    attn_bias = bias_row.clamp(min=NEG).to(dt)[:, None, None, :]

    def stock(p):
        qkv = F.linear(xg, ws[0].T, ws[1])
        q, k, v = qkv.view(B, L, 3, H, 64).permute(2, 0, 3, 1, 4)
        ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_bias, dropout_p=p)
        return ctx.transpose(1, 2).reshape(B * L, P).float() @ ws[2].float()

    library = {"attention_block": time_ms(torch, lambda: stock(0.0), 5),
               "attention_block_train": time_ms(torch, lambda: stock(rate), 5)}
    stock_out = stock(rate)
    library["attention_block_bwd"] = time_ms(
        torch, lambda: torch.autograd.grad(stock_out, [xg, *ws], dout.reshape(B * L, E).float(),
                                           retain_graph=True), 5)
    del stock_out, saved, keep
    # bounds: the shard's products, its inputs read once and its fp32
    # output written once (block_cost counts the output at the compute
    # dtype's 2 bytes: 4·M·E more here)
    M = B * L
    bounds = {}
    for name, kind in (("attention_block", "light"), ("attention_block_train", "train")):
        cost = block_cost(B, L, E, P, 2, kind)
        cost["bytes"] += 2 * M * E
        bounds[name] = block_bound(cost)
    bounds["attention_block_bwd"] = block_bound(block_cost(B, L, E, P, 2, "backward"))
    for name, (k, p) in times.items():
        log(f"  {name} P = {P} [{B}, {L}, {E}] bf16 (fp32 out for K1/K3; K1 dropout 0, K3/K4 "
            f"dropout {rate}): kernel {k:.4f} ms, plain {p:.4f} ms, library "
            f"{library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms ({bounds[name][1]}) "
            f"({smi})")
    torch.cuda.empty_cache()
    return {"times": times, "library": library, "bounds": bounds, "row_parallel": rowpar,
            "shard_rows": shard_rows}


def hold_sharded_rows(torch, results: dict, rng, bias_row, smi: str, per_draw: dict,
                      clock_mhz: float) -> dict:
    """22 a. The flash path's kernels at a model rank's shapes: K7/K8 on
    its 6 heads ([8, 512, 6, 64], q/k/v views of one [B, L, 3·384]
    projection, the model's layout), and K5/K6 (through their autograd
    Function) on its rows under sequence parallelism ([B·L/2, 768]), bf16,
    at dropout 0 and 0.1 with model rank 1's shard seeds of a 1×2 mesh,
    against their plain versions at phases 11 and 14's bf16 gates; then
    each timed at dropout 0.1 with CUDA events over back-to-back calls
    beside its plain version, its library call (SDPA with the mask and
    dropout, and its backward; ``F.dropout`` + add + ``F.layer_norm``,
    and its backward) and its bound (``flash_cost``, ``ln_bound``)."""
    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.ops.attention import NEG

    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.ops import flash_attention as fa
    from pl_bert_tpu_torch.ops import fused_ln
    from pl_bert_tpu_torch.parallel import tp

    B, L = bias_row.shape
    H, D, E, N, dt = 6, 64, 768, bias_row.numel() // 2, torch.bfloat16
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(DEV)  # noqa: E731
    log(f"  K7/K8 at [{B}, {L}, {H}, {D}] and K5/K6 at [{N}, {E}] (a model rank's heads, and "
        "its rows under sequence parallelism), bf16, model rank 1's seeds of a 1x2 mesh, "
        "against their plain versions")
    qkv = to(rng.standard_normal((B, L, 3 * H * D)) * 0.7).to(dt)
    q, k, v = (t.reshape(B, L, H, D) for t in qkv.split(H * D, dim=-1))
    dout = to(rng.standard_normal((B, L, H, D))).to(dt)
    x, res, dy = (to(rng.standard_normal((N, E))).to(dt) for _ in range(3))
    gamma, beta = to(1 + 0.1 * rng.standard_normal(E)), to(0.1 * rng.standard_normal(E))
    offset = tp.shard_seed_offset(0, 1, 2)
    for rate in (0.0, 0.1):
        tag = f"dropout {rate}"
        seed = tp.shard_seed(977, offset) if rate else None
        keep = ab.dropout_mask(seed, rate, B, H, L, DEV) if rate else None
        out = fa.flash_attention_fwd(q, k, v, bias_row, None, rate, seed)
        grads = fa.flash_attention_bwd(dout, q, k, v, bias_row, None, rate, seed)
        ref = fa.flash_attention_plain(q, k, v, bias_row, None, rate, seed, keep=keep)
        refs = fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, None, rate, seed,
                                            keep=keep)
        hold(results, "flash_attention", f"K7 out {H} heads {tag}", out, ref, TOL["bfloat16"])
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            hold(results, "flash_attention_bwd", f"K8 {name} {H} heads {tag}", a, r,
                 TOL["bfloat16"])
        del out, grads, ref, refs, keep
        seed = tp.shard_seed(99, offset) if rate else None
        keep = fused_ln.dropout_mask((N, E), seed, rate, DEV) if rate else None
        ins = [t.detach().requires_grad_() for t in (x, res, gamma, beta)]
        y = fused_ln.dropout_add_layernorm_train(*ins, seed=seed, rate=rate)
        got = torch.autograd.grad(y, ins, dy)
        want = fused_ln.dropout_add_layernorm_bwd_plain(dy, x, res, gamma, seed, rate, keep=keep)
        hold(results, "dropout_add_layernorm", f"K5 out [{N}, {E}] {tag}", y.detach(),
             fused_ln.dropout_add_layernorm_plain(x, res, gamma, beta, seed, rate, keep=keep),
             TOL["bfloat16"])
        for name, a, r in zip(("dx", "dres", "dgamma", "dbeta"), got, want):
            hold(results, "dropout_add_layernorm_bwd", f"K6 {name} [{N}, {E}] {tag}", a, r,
                 TOL["bfloat16"] if a.dtype == dt else TOL_GRAD["bfloat16"])

    rate, iters = 0.1, 20
    seed = tp.shard_seed(977, offset)
    keep = ab.dropout_mask(seed, rate, B, H, L, DEV)
    times = {
        "flash_attention": a_b(
            torch, lambda: fa.flash_attention_plain(q, k, v, bias_row, None, rate, seed,
                                                    keep=keep),
            lambda: fa.flash_attention_fwd(q, k, v, bias_row, None, rate, seed), iters=iters),
        "flash_attention_bwd": a_b(
            torch, lambda: fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, None, rate,
                                                        seed, keep=keep),
            lambda: fa.flash_attention_bwd(dout, q, k, v, bias_row, None, rate, seed),
            iters=iters)}
    del keep
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    attn_bias = bias_row.clamp(min=NEG).to(dt)[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, attn_mask=attn_bias, dropout_p=rate)
    library = {"flash_attention": time_ms(torch, sdpa, iters)}
    sdpa_out = sdpa()
    library["flash_attention_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, [qs, ks, vs], dout.transpose(1, 2), retain_graph=True), iters)
    del sdpa_out
    bounds = {name: bound_ms(*flash_cost(B, L, H, D, 2, back))
              for name, back in (("flash_attention", False), ("flash_attention_bwd", True))}
    seed = tp.shard_seed(99, offset)
    times["dropout_add_layernorm"] = a_b(
        torch, lambda: fused_ln.dropout_add_layernorm_plain(x, res, gamma, beta, seed, rate),
        lambda: fused_ln.dropout_add_layernorm(x, res, gamma, beta, seed, rate), iters=iters)
    times["dropout_add_layernorm_bwd"] = a_b(
        torch, lambda: fused_ln.dropout_add_layernorm_bwd_plain(dy, x, res, gamma, seed, rate),
        lambda: fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate), iters=iters)
    g16, b16 = gamma.to(dt).requires_grad_(), beta.to(dt).requires_grad_()
    xg, rg = x.detach().requires_grad_(), res.detach().requires_grad_()
    stock_ln = lambda: F.layer_norm(F.dropout(xg, rate) + rg, (E,), g16, b16, 1e-12)  # noqa: E731
    library["dropout_add_layernorm"] = time_ms(torch, stock_ln, iters)
    ln_out = stock_ln()
    library["dropout_add_layernorm_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        ln_out, [xg, rg, g16, b16], dy, retain_graph=True), iters)
    del ln_out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bounds["dropout_add_layernorm"] = ln_bound(N, E, 2, 3, 10.0, N * E, per_draw["ln_fwd"],
                                               sms, clock_mhz)[:2]
    bounds["dropout_add_layernorm_bwd"] = ln_bound(N, E, 2, 5, 20.0, N * E,
                                                   per_draw["ln_bwd"], sms, clock_mhz)[:2]
    for name, (kms, pms) in times.items():
        shape = f"[{N}, {E}]" if "layernorm" in name else f"[{B}, {L}, {H}, {D}]"
        log(f"  {name} {shape} bf16 dropout {rate}: kernel {kms:.4f} ms, plain {pms:.4f} ms, "
            f"library {library[name]:.4f} ms, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}) (CUDA events, {iters} calls) ({smi})")
    return {"times": times, "library": library, "bounds": bounds}


def time_row_parallel(torch, rng, smi: str) -> dict:
    """22 a. The FFN's row-parallel layer on a model rank (``ffn_output``:
    [B·L, 1024] x [768, 1024]ᵀ, its half of the 2048 inputs), forward and
    backward, at B = 8 (22 c) and 96 (bench.py): the model's partial
    product (one bf16 GEMM writing its fp32 accumulators) against the
    fp32 GEMM of the same values on the CUDA cores (TF32 off), with the
    bound of the bf16 one. The forward is held against the fp32 one at
    the fp32 gate: the products are exact in fp32 either way."""
    import numpy as np
    import torch.nn.functional as F

    from pl_bert_tpu_torch.models.albert import _PartialProduct

    K, N, dt = 1024, 768, torch.bfloat16
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(DEV)  # noqa: E731
    out = {}
    for B in (8, 96):
        M = B * 512
        a = to(rng.standard_normal((M, K))).to(dt).requires_grad_()
        w = to(rng.standard_normal((N, K)) * 0.03).to(dt).requires_grad_()
        g = to(rng.standard_normal((M, N))).to(dt).float()  # the fp32 gradient of a bf16 value
        gate(f"row-parallel partial product [{M}, {K}] x [{N}, {K}]ᵀ against the fp32 GEMM",
             errors(_PartialProduct.apply(a, w), F.linear(a.float(), w.float())), TOL["float32"])
        # (partial product, fp32 GEMM) ms
        fwd = a_b(torch, lambda: F.linear(a.float(), w.float()),
                  lambda: _PartialProduct.apply(a, w), iters=10)
        both = a_b(
            torch,
            lambda: torch.autograd.grad(F.linear(a.float(), w.float()), [a, w], g),
            lambda: torch.autograd.grad(_PartialProduct.apply(a, w), [a, w], g), iters=10)
        bound_f = bound_ms(2 * M * K * N, 2 * M * K + 2 * K * N + 4 * M * N)
        # forward and backward: three products; a, w and g read, the fp32
        # output and the bf16 dx and dw written
        bound_b = bound_ms(6 * M * K * N, 2 * (2 * M * K + 2 * K * N) + 8 * M * N)
        log(f"  row-parallel layer [{M}, {K}] x [{N}, {K}]ᵀ: forward {fwd[0]:.4f} ms (fp32 GEMM "
            f"{fwd[1]:.4f}, bound {bound_f[0]:.4f} by {bound_f[1]}); forward and backward "
            f"{both[0]:.4f} ms (fp32 {both[1]:.4f}, bound {bound_b[0]:.4f} by {bound_b[1]}) "
            f"({smi})")
        out[M] = {"forward": fwd, "both": both, "bound": (bound_f[0], bound_b[0])}
        del a, w, g
    return out


def phase_sharded(torch, smi: str, results: dict, per_draw: dict, clock_mhz: float) -> dict:
    """22. the sharded step: a. its kernels at the shard's shapes; b. a NCCL
    world of one; c. two ranks over gloo on the one card, five meshes; d.
    the multi-task model at model 2, its head split over the vocabulary:
    at dropout 0 against one rank, and at dropout 0.1 across its ranks."""
    import torch.distributed as dist

    from pl_bert_tpu_torch.training.train import train

    t_phase = time.perf_counter()
    kernels = phase_sharded_kernels(torch, results, smi, per_draw, clock_mhz)
    out = {"kernels": kernels}
    with tempfile.TemporaryDirectory() as workdir:
        runs = os.path.join(workdir, "runs")

        def one_rank(config: str, run: str, world_of_one: bool = False) -> tuple[list, float]:
            """One process through train(); with ``world_of_one`` in a NCCL
            world of one (PLBERT_DISTRIBUTED=1). Its steps, and the median
            ms of its steps past the first, each timed between two
            synchronisations, as each rank of 22 c times its own."""
            env = {}
            if world_of_one:
                import socket

                with socket.socket() as s:
                    s.bind(("localhost", 0))
                    env = {"PLBERT_DISTRIBUTED": "1", "PLBERT_NUM_PROCESSES": "1",
                           "PLBERT_COORDINATOR": f"localhost:{s.getsockname()[1]}",
                           "PLBERT_PROCESS_ID": "0"}
            os.environ.update(env)
            try:
                with contextlib.redirect_stdout(io.StringIO()), timed_steps(torch) as trainers:
                    train({"config_path": config, "run_name": run, "device": DEV})
            finally:
                for key in env:
                    del os.environ[key]
                if dist.is_initialized():
                    log(f"  {run}: a world of {dist.get_world_size()} over "
                        f"{dist.get_backend()}")
                    dist.destroy_process_group()
            return metrics_steps(os.path.join(runs, run)), median_step_ms(trainers[0].step_s)

        log("phase 22 b: a NCCL world of one (PLBERT_DISTRIBUTED=1) against no world, the "
            "Trainer on bench.py's workload (B 96, L 512, bf16, dropout 0.1, block path), "
            "4 steps each")
        bench = lambda name: sharded_config(  # noqa: E731
            os.path.join(workdir, f"{name}.yml"), runs, batch=96, dropout=0.1, samples=640)
        plain, plain_ms = one_rank(bench("bench"), "bench")
        world, world_ms = one_rank(bench("bench_world"), "bench_world", world_of_one=True)
        out["world_of_one"] = compare_runs(world, plain, "NCCL world of one against none")
        log(f"  {world_ms:.1f} ms a step in a world of one against {plain_ms:.1f} without "
            f"(median of steps 2-4, each between two synchronisations) ({smi})")
        out["world_ms"], out["plain_ms"] = world_ms, plain_ms

        log("phase 22 c: two ranks on the one card over gloo (NCCL refuses two ranks on one "
            "device; gloo moves every collective through host memory, not NVLink): the "
            "flagship model, L 512, global batch 8, bf16, dropout 0, 4 steps through "
            "training.train.train(), against one rank on the same weights and batches")
        refs = {impl: one_rank(sharded_config(os.path.join(workdir, f"ref_{impl}.yml"), runs,
                                              impl=impl), f"ref_{impl}")
                for impl in ("auto", "pallas")}
        n, steps = 12, 4
        for impl, (_, ms) in refs.items():
            log(f"  one rank, attention_impl {impl}: {ms:.1f} ms a step (median of steps "
                f"2-{steps}, each between two synchronisations; no collective) ({smi})")
        out["one_rank_ms"] = {impl: ms for impl, (_, ms) in refs.items()}
        by_run = {}
        for label, (data, model, zero1, impl, sp) in SHARDED_RUNS.items():
            run = "r_" + label.replace(" ", "").replace(",", "_")
            config = sharded_config(os.path.join(workdir, f"{run}.yml"), runs, data=data,
                                    model=model, zero1=zero1, impl=impl, sp=sp)
            ranks = run_ranks(config, run, 2, workdir)
            got = metrics_steps(os.path.join(runs, run))
            bitwise = compare_runs(got, refs[impl][0], f"{label} against one rank")
            by_run[label] = {"ranks": ranks, "steps": got, "bitwise": bitwise}
            heads = 12 // model
            for rank, r in enumerate(ranks):
                c, vals = r["launches"], r["evals"]
                expect = {**dict.fromkeys(c, 0), **path_launches(impl, n, steps, vals)}
                if vals < 1 or c != expect or r["local_heads"] != heads:
                    raise AssertionError(f"{label} rank {rank}: launches {c} != {expect} or "
                                         f"heads {r['local_heads']} != {heads}")
                log(f"  {label} rank {rank}: {r['local_heads']} local heads; launches over "
                    f"{steps} steps and {vals} validation forwards {c}; "
                    f"{median_step_ms(r['step_s']):.1f} ms "
                    f"a step (median of steps 2-{steps}, gloo through host memory); peak "
                    f"{r['peak'] / 2**30:.2f} GiB ({r['peak']} bytes) ({smi})")
            if model > 1:
                same = ranks[0]["digests"] == ranks[1]["digests"]
                log(f"  {label}: replicated parameters bitwise equal across the model ranks "
                    f"after step {steps}: {same} ({len(ranks[0]['digests'])} tensors)")
                if not same:
                    raise AssertionError(f"{label}: replicated parameters differ across ranks")
        zero1 = compare_runs(by_run["data 2, zero1"]["steps"], by_run["data 2"]["steps"],
                             "data 2 with zero1 against data 2")
        out["runs"], out["zero1_bitwise"] = by_run, zero1

        log("phase 22 d: the multi-task model at model 2, data 1, its head of 60,000 split "
            "over the vocabulary (fused, capacity 144, dropout 0, 4 steps, global batch 8), "
            "against one rank on the same weights and batches")
        V = 60_000
        mt_ref, _ = one_rank(sharded_config(os.path.join(workdir, "mt_ref.yml"), runs,
                                            multitask=True), "mt_ref")
        config = sharded_config(os.path.join(workdir, "mt.yml"), runs, model=2, multitask=True)
        ranks = run_ranks(config, "mt", 2, workdir)
        got = metrics_steps(os.path.join(runs, "mt"))
        compare_runs(got, mt_ref, "multi-task model 2 against one rank")
        if not all(np_isfinite(r[k]) and r["token_loss"] > 0 for r in got
                   for k in ("phoneme_loss", "token_loss", "grad_norm")):
            raise AssertionError(f"multi-task model 2: {got}")
        half = -(-V // 2)
        whole = ranks[0]["head_whole"] == ranks[1]["head_whole"]
        same = ranks[0]["digests"] == ranks[1]["digests"]
        log(f"  the head gathered whole bitwise equal on both ranks after step 4: {whole}; "
            f"replicated parameters bitwise equal across the model ranks: {same} "
            f"({len(ranks[0]['digests'])} tensors, the head not among them)")
        if not whole or not same or any(k.startswith("token_predictor.")
                                        for k in ranks[0]["digests"]):
            raise AssertionError("multi-task model 2: the ranks' parameters differ")
        for rank, r in enumerate(ranks):
            per_mb = r["head_collectives"]
            ms = r["head_collective_ms"]
            cost = r["head_chunks"] * (ms["max"] + ms["sum"]) + ms["dh"]
            log(f"  rank {rank}: head rows [{r['head_start']}, {r['head_start'] + r['head_rows']})"
                f", moments {r['moment_rows']} rows (at most {half}); the head's collectives "
                f"a step {per_mb} (one micro-batch a step); an isolated estimate over gloo, "
                f"each collective timed alone on zero tensors outside the step: a MAX of [rows] "
                f"{ms['max']:.3f} ms, a SUM of [2, rows] {ms['sum']:.3f} ms, the dh all-reduce "
                f"{ms['dh']:.3f} ms: {cost:.2f} ms a micro-batch of {r['head_chunks']} chunks; "
                f"{median_step_ms(r['step_s']):.1f} ms a step; peak {r['peak'] / 2**30:.2f} GiB "
                f"({r['peak']} bytes) against the predicted 1.5 GiB and 1.89 GiB with the "
                f"head replicated ({smi})")
            if r["head_rows"] > half or any(n > half for n in r["moment_rows"]):
                raise AssertionError(f"rank {rank} holds {r['head_rows']} rows of the head")
        out["multitask"] = {"peak": [r["peak"] for r in ranks],
                            "collectives": ranks[0]["head_collectives"],
                            "collective_ms": ranks[0]["head_collective_ms"]}

        log("phase 22 d: the same two ranks at dropout 0.1, 2 steps (each rank's shard seeds, "
            "the embedding dropout drawn at the global batch shape, K3 and K5 with each rank's "
            "seed offsets under the Trainer): finite losses, the replicated parameters and the "
            "head gathered whole bitwise equal across the ranks")
        steps = 2
        config = sharded_config(os.path.join(workdir, "mt_dropout.yml"), runs, model=2,
                                dropout=0.1, steps=steps, multitask=True)
        ranks = run_ranks(config, "mt_dropout", 2, workdir)
        got = metrics_steps(os.path.join(runs, "mt_dropout"))
        if len(got) != steps or not all(np_isfinite(r[k]) and r["token_loss"] > 0 for r in got
                                        for k in ("phoneme_loss", "token_loss", "grad_norm")):
            raise AssertionError(f"multi-task model 2 at dropout 0.1: {got}")
        whole = ranks[0]["head_whole"] == ranks[1]["head_whole"]
        same = ranks[0]["digests"] == ranks[1]["digests"]
        for rank, r in enumerate(ranks):
            c = r["launches"]
            expect = {**dict.fromkeys(c, 0), **path_launches("auto", n, steps, r["evals"])}
            log(f"  rank {rank}: launches over {steps} steps and {r['evals']} validation "
                f"forwards {c}")
            if r["evals"] < 1 or c != expect:
                raise AssertionError(f"dropout 0.1 rank {rank}: launches {c} != {expect}")
        log(f"  losses {[(round(r['phoneme_loss'], 4), round(r['token_loss'], 4)) for r in got]};"
            f" the head gathered whole bitwise equal on both ranks: {whole}; replicated "
            f"parameters bitwise equal across the model ranks: {same} "
            f"({len(ranks[0]['digests'])} tensors)")
        if not whole or not same:
            raise AssertionError("multi-task model 2 at dropout 0.1: the ranks' parameters "
                                 "differ")
        out["multitask_dropout"] = {"steps": got, "launches": ranks[0]["launches"]}
    out["launches"] = by_run["model 2, SP"]["ranks"][0]["launches"]
    wall = time.perf_counter() - t_phase
    log(f"phase 22 took {wall:.1f} s")
    out["wall_s"] = wall
    return out


# phase 23's corpus: a generated lexicon of Arabic-letter words drawn
# uniformly (about 200,000 draws over 80,000 words leave about 73,000
# distinct, past the tokenizer's 60,000 cap), with digits, dates and
# punctuation mixed in so arabic_numbers and the punctuation split run
TEXT_LEXICON, TEXT_LINES, TEXT_WORDS = 80_000, 10_000, 20
ARABIC_LETTERS = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي"
# the pipeline's config for phase 23's text stages and its pack
TEXT_CONFIG = """\
preprocess_params:
  num_shards: 4
  max_workers: 4
  max_try_count: 1
  timeout: 600
  preprocess_dir: {prep}
  cleaned_output_dir: cleaned
  g2p_backend: espeak
dataset_params:
  max_seq_length: 512
  ondevice_masking: true
  sequence_packing: true
"""


def arabic_corpus(path: str, seed: int) -> int:
    """Write phase 23's corpus (one article a line); returns its words."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lexicon = set()
    while len(lexicon) < TEXT_LEXICON:
        n = int(rng.integers(2, 8))
        lexicon.add("".join(ARABIC_LETTERS[i] for i in rng.integers(0, 28, n)))
    lexicon = sorted(lexicon)
    marks, words = "،؛؟!:", 0
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(TEXT_LINES):
            line = []
            for j in range(int(rng.integers(TEXT_WORDS - 4, TEXT_WORDS + 5))):
                r = rng.random()
                if r < 0.05:
                    line.append(str(int(rng.integers(0, 100_000))))
                elif r < 0.07:
                    line.append(f"{rng.integers(1, 29)}/{rng.integers(1, 13)}/"
                                f"{rng.integers(1900, 2030)}")
                else:
                    word = lexicon[int(rng.integers(len(lexicon)))]
                    if 0 < j and rng.random() < 0.04:
                        word += marks[int(rng.integers(len(marks)))]
                    line.append(word)
            words += len(line)
            f.write(" ".join(line) + ".\n")
    return words


def stub_espeak() -> str:
    """``tests/espeak_stub/espeak_stub.c`` built as C with the host
    compiler ``runtime/build.py::build_host`` uses (``-x c``), into the
    git-ignored build directory; a failed build raises."""
    from pl_bert_tpu_torch.runtime.build import BUILD_DIR, host_compiler

    src = os.path.join(HERE, "tests", "espeak_stub", "espeak_stub.c")
    out = BUILD_DIR / "libespeak-stub.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([host_compiler(), "-x", "c", "-O2", "-shared", "-fPIC", src, "-o",
                    str(out)], check=True, capture_output=True, text=True, timeout=300)
    return str(out)


def count_lines(path: str) -> int:
    with open(path, encoding="utf-8") as f:
        return sum(1 for line in f if line.strip())


def phase_text_to_training(torch, smi: str) -> dict:
    """23. raw Arabic text → the pipeline's stages in subprocesses (the
    shard engine forks its workers, so none of them touches CUDA) →
    ``verify_store`` → bench.py's production shape trained from the store
    through ``training.train.train()``."""
    import numpy as np

    from pl_bert_tpu_torch.training.train import train

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        prep = os.path.join(workdir, "prep")
        corpus = os.path.join(workdir, "corpus.txt")
        words = arabic_corpus(corpus, SEED + 23)
        config = os.path.join(workdir, "text.yml")
        with open(config, "w", encoding="utf-8") as f:
            f.write(TEXT_CONFIG.format(prep=prep))
        log(f"phase 23 a: a corpus of {TEXT_LINES} lines, {words} words drawn from a lexicon of "
            f"{TEXT_LEXICON} generated Arabic words, with digits, dates and punctuation")
        t0 = time.perf_counter()
        lib = stub_espeak()
        log(f"phase 23 b: the espeak-ng ABI stub built in {time.perf_counter() - t0:.1f} s: "
            f"{lib} (PLBERT_ESPEAK_LIB)")
        # the CATT root inside this phase's own directory, where no checkout
        # is: the diacritize stage's fall-back does not depend on what lies
        # beside the repository
        catt = os.path.join(workdir, "catt")
        env = {"PLBERT_ESPEAK_LIB": lib, "PLBERT_CATT_DIR": catt, "CUDA_VISIBLE_DEVICES": ""}
        cleaned = os.path.join(prep, "cleaned")
        phonemized = cleaned + ".diacritized.phonemized"
        tokenized = phonemized + ".tokenized"
        tok_dir = os.path.join(prep, "word_tokenizer")
        stages = [
            ("clean", ["--local_dataset_path", corpus], cleaned),
            ("diacritize", ["--dataset_path", cleaned], phonemized),
            ("tokenize", ["--dataset_path", phonemized, "--tokenizer_dir", tok_dir], tokenized),
            ("pack", ["--dataset_path", tokenized], None),
        ]
        log("phase 23 c: python -m pl_bert_tpu_torch.preprocess.pipeline in subprocesses")
        printed = {}
        for stage, args, result in stages:
            t0 = time.perf_counter()
            done = run_module(["pl_bert_tpu_torch.preprocess.pipeline", "--config_path", config,
                               "--stage", stage, *args], env=env, timeout=600)
            seconds = time.perf_counter() - t0
            if done.returncode:
                raise AssertionError(f"--stage {stage} exited {done.returncode}:\n"
                                     f"{done.stdout[-2000:]}\n{done.stderr[-3000:]}")
            printed[stage] = done.stdout
            if result is not None:
                n = count_lines(os.path.join(result, "records.jsonl"))
                log(f"  --stage {stage}: {seconds:.1f} s, {n} records -> {result}")
            else:
                line = next(x for x in done.stdout.splitlines() if x.startswith("Packed store"))
                log(f"  --stage {stage}: {seconds:.1f} s, {line}")
            out[stage + "_s"] = seconds
        if (f"CATT checkout not found at {catt}" not in printed["diacritize"]
                or "falling back to identity diacritizer" not in printed["diacritize"]):
            raise AssertionError("the diacritize stage did not report its fall-back from "
                                 f"{catt}:\n{printed['diacritize'][-2000:]}")
        with open(os.path.join(tok_dir, "tokenizer.json"), encoding="utf-8") as f:
            vocab = json.load(f)["vocab_size"]
        with open(os.path.join(tokenized, "records.jsonl"), encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        mismatched = sum(r["token_alignment"] == "mismatch" for r in rows)
        stubbed = sum(p.startswith("ˈ") for r in rows[:200] for p in r["phonemes"])
        log(f"  the tokenizer: {vocab} words (the cap); {mismatched} of {len(rows)} records "
            f"misaligned; {stubbed} phoneme words of the first 200 records carry the stub's "
            "stress mark")
        if vocab != 60_000 or stubbed == 0:
            raise AssertionError(f"tokenizer {vocab} words, stub marks {stubbed}")
        store = tokenized + ".packed"

        log("phase 23 d: python -m pl_bert_tpu_torch.data.verify_store on the store")
        verified = run_module(["pl_bert_tpu_torch.data.verify_store", store])
        if verified.returncode or not verified.stdout.startswith("OK (full scan)"):
            raise AssertionError(f"verify_store: rc {verified.returncode}\n{verified.stdout}"
                                 f"{verified.stderr[-2000:]}")
        log(f"  {verified.stdout.strip()}")
        with open(os.path.join(store, "packed_meta.json"), encoding="utf-8") as f:
            meta = json.load(f)

        steps = 4
        run_config = os.path.join(workdir, "production.yml")
        with open(run_config, "w", encoding="utf-8") as f:
            f.write(MT_CONFIG.format(out=os.path.join(workdir, "runs"), steps=steps, save=steps,
                                     dataset=store).replace("num_token_vocab: 60000",
                                                            f"num_token_vocab: {vocab}"))
        log(f"phase 23 e: bench.py's production shape from the store ({meta['num_rows']} rows, "
            f"{meta['total_tokens']} tokens), a head of {vocab}, {steps} steps")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counters()  # this run starts here
        with contextlib.redirect_stdout(Tee()), timed_steps(torch) as trainers:
            final = train({"config_path": run_config, "run_name": "text", "device": DEV})
        launches = read_counters(counters)  # and ends here
        peak = torch.cuda.max_memory_allocated()
        records = step_records(os.path.join(workdir, "runs", "text"))
        keys = ("loss", "phoneme_loss", "token_loss")
        if final != steps or [r["step"] for r in records] != list(range(1, steps + 1)) or not all(
                np.isfinite(r[k]) and r["token_loss"] > 0 for r in records for k in keys):
            raise AssertionError(f"phase 23 run: step {final}, {records}")
        trainer = trainers[0]
        n, micro = 12, 2 * steps
        evals = validation_forwards(trainer)
        expect = {**dict.fromkeys(launches, 0), **path_launches("pallas", n, micro, evals)}
        log(f"  launches over {steps} steps ({micro} micro-batches) and {evals} validation "
            f"forwards ({len(trainer._val_cache)} validation batches, before step 1 and after "
            f"step {steps}): {launches}")
        if evals < 1 or launches != expect:
            raise AssertionError(f"launch counts {launches} != {expect}")
        step_ms = median_step_ms(trainer.step_s)
        # the real tokens of the batches the run trained on, over the steps
        # past the first, by the steps' own clock
        tokens_per_s = sum(trainer.step_tokens[1:]) / sum(trainer.step_s[1:])
        occupancy = sum(trainer.step_tokens) / (steps * 2 * 96 * 512)
        log(f"  {step_ms:.1f} ms a step (median of steps 2-{steps}, each between two "
            f"synchronisations), {tokens_per_s:.0f} real tokens/s over steps 2-{steps} "
            f"({trainer.step_tokens} real tokens a step, {occupancy:.1%} of the rows), "
            f"peak {peak / 2**30:.2f} GiB ({peak} bytes); losses "
            f"{[(round(r['phoneme_loss'], 4), round(r['token_loss'], 4)) for r in records]} "
            f"({smi})")
        out.update(step_ms=step_ms, tokens_per_s=tokens_per_s, occupancy=occupancy, peak=peak,
                   launches=launches, vocab=vocab, rows=meta["num_rows"],
                   step_tokens=trainer.step_tokens)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 23 took {out['wall_s']:.1f} s")
    return out


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pl_bert_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)  # 1. the card, beside every number below
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from pl_bert_tpu_torch.models.albert import AlbertConfig
    from pl_bert_tpu_torch.runtime import build

    log("phase 2: build")
    t0 = time.perf_counter()
    for name, path in build.build_all().items():  # one nvcc a source, all at once
        log(f"  nvcc {name}: {path}")
    build.import_triton()
    log(f"  built in {time.perf_counter() - t0:.1f} s (Triton compiles at first launch)")
    phase_tensor_cores(build)
    per_draw = phase_fused_ln_build(build)
    clock_mhz = max_sm_clock_mhz()

    cfg = AlbertConfig()  # the flagship model of configs/config.yml
    results = {name: [] for name in KERNELS}
    phase_kernels(torch, cfg, results)
    sd = random_state_dict(torch, cfg, SEED)
    encoders = phase_encoder(torch, cfg, sd)
    with tempfile.TemporaryDirectory() as workdir:
        serve_launches, stats2 = phase_serve(torch, cfg, sd, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        _, stats1 = phase_serve(torch, cfg, sd, workdir, depth=1)
    phase_pipeline(torch, cfg, sd, encoders["bf16", "auto"], {1: stats1, 2: stats2})
    with tempfile.TemporaryDirectory() as workdir:
        log("phase 15: 8 requests from a server started with attention_impl pallas")
        phase_serve(torch, cfg, sd, workdir, impl="pallas", per_client=2)
    serving = phase_timing(torch, cfg, encoders, per_draw, clock_mhz)
    del encoders
    torch.cuda.empty_cache()
    phase_train_kernels(torch, cfg, results)
    flash = phase_flash_kernels(torch, cfg, results)
    train, train_launches, training = phase_train(torch, results, per_draw, clock_mhz)
    with tempfile.TemporaryDirectory() as workdir:
        run, run_launches = phase_packed_run(torch, workdir)
    bench_launches = phase_microbench(torch)
    torch.cuda.empty_cache()
    head = phase_multitask_head(torch)
    phase_multitask_step(torch)
    with tempfile.TemporaryDirectory() as mt_dir:
        production, mt_launches = phase_production_run(torch, mt_dir)
        missing = [k for k in ("dropout_add_layernorm", "dropout_add_layernorm_bwd",
                               "flash_attention", "flash_attention_bwd") if not mt_launches[k]]
        if missing:
            raise AssertionError(f"the multi-task path launched no {missing}")
        with tempfile.TemporaryDirectory() as workdir:
            stored = phase_store_run(torch, workdir, production, mt_launches)
            feed = phase_store_feed(workdir, production["step_ms"])
        torch.cuda.empty_cache()
        deploy = phase_deploy(torch, sd, mt_dir, smi)  # on 18 c's step_6.pth
    remat = phase_remat(torch, smi)
    torch.cuda.empty_cache()
    sharded = phase_sharded(torch, smi, results, per_draw, clock_mhz)
    torch.cuda.empty_cache()
    text = phase_text_to_training(torch, smi)
    imported = sorted({"datasets", "transformers", "safetensors"} & set(sys.modules))
    if imported:
        raise AssertionError(f"the smoke's path imported {imported}")

    paths = {"serving": (serve_launches, serving), "training": (train_launches, training),
             "packed_run": (run_launches, flash), "microbench": (bench_launches, flash),
             "multitask": (mt_launches, flash), "store_run": (stored["launches"], flash),
             "deploy": (deploy["launches"], flash), "remat": (remat["launches"], flash),
             "sharded": (sharded["launches"], flash)}
    kernels = []
    for name, (route, source, replaces, path) in KERNELS.items():
        launches, measured = paths[path]
        ms, plain_ms = measured["times"][name]
        bound, bound_by = measured["bounds"][name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            # the count from the run of the path the kernel serves; every
            # path's count beside (K5 runs in all but the plain ones)
            "launches": launches[name],
            "max_abs_err": max(results[name]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": measured["library"].get(name),
            "launches_by_path": {p: counts[name] for p, (counts, _) in paths.items()},
        })
    log(f"train step, block path: {train['step_ms']:.1f} ms, {train['tokens_per_s']:.0f} "
        f"phoneme tokens/s (B=96, L=512, bf16, dropout 0.1)")
    log(f"packed run, flash path: {run['step_ms']:.1f} ms a step, {run['tokens_per_s']:.0f} "
        f"phoneme tokens/s at {run['occupancy']:.0%} occupancy (B=96, L=512, bf16, dropout 0.1)")
    log(f"production run (multi-task, packed, flash path, accumulation 2): "
        f"{production['step_ms']:.1f} ms a step, {production['tokens_per_s']:.0f} real tokens/s "
        f"at {production['occupancy']:.1%} occupancy, peak {production['peak_bytes'] / 2**30:.2f} "
        f"GiB; the grapheme head {head['times']['fused, gathered']:.2f} ms a micro-batch "
        f"(bound {head['bound_ms']:.2f})")
    log(f"production run from the packed store: {stored['step_ms']:.1f} ms a step (18 c: "
        f"{production['step_ms']:.1f}), losses bitwise 18 c's: {stored['bitwise_c']}, the "
        f"orchestrated run's bitwise the store run's: {stored['bitwise_d']}; the store feeds "
        f"{feed['rows_per_s']:.0f} rows/s against the step's {feed['demand_rows_per_s']:.0f}")
    (ms8, ms16), (ms8_64, ms16_64) = deploy["times"][MAX_BATCH], deploy["times"][64]
    log(f"int8 serving (block path, L=512): {ms8:.3f} against bf16 {ms16:.3f} ms a forward at "
        f"B={MAX_BATCH}, {ms8_64:.3f} against {ms16_64:.3f} at B=64; min cosine to bf16 "
        f"{deploy['min_cos']:.6f} ({smi})")
    on, off = remat["on"], remat["off"]
    log(f"remat (block path, B=96): {on['step_ms']:.1f} against {off['step_ms']:.1f} ms a step, "
        f"peak {on['peak'] / 2**30:.2f} against {off['peak'] / 2**30:.2f} GiB, bitwise "
        f"{remat['bitwise']} (without remat, a second run bitwise the first: {remat['repeats']}) "
        f"({smi})")
    times22 = sharded["kernels"]["times"]
    log("sharded step (phase 22): K1 / K3 / K4 at P = 384 with the fp32 output: "
        + ", ".join(f"{name} {k:.4f} ms (plain {p:.4f})" for name, (k, p) in times22.items())
        + f"; NCCL world of one {sharded['world_ms']:.1f} against {sharded['plain_ms']:.1f} ms "
        f"a step; one rank at B=8 {sharded['one_rank_ms']['auto']:.1f} (block) and "
        f"{sharded['one_rank_ms']['pallas']:.1f} (flash) ms a step; zero1 bitwise data 2: "
        f"{sharded['zero1_bitwise']} ({smi})")
    log(f"raw Arabic text to the production shape (phase 23): clean {text['clean_s']:.1f} s, "
        f"diacritize and phonemize {text['diacritize_s']:.1f} s, tokenize "
        f"{text['tokenize_s']:.1f} s, pack {text['pack_s']:.1f} s; {text['step_ms']:.1f} ms a "
        f"step, {text['tokens_per_s']:.0f} real tokens/s, peak {text['peak'] / 2**30:.2f} GiB "
        f"({smi})")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:  # one rank of phase 22 c/d
        sharded_rank(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())

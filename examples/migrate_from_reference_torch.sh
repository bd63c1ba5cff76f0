#!/usr/bin/env bash
# Migration demo: continue a REFERENCE (torch) PL-BERT run with the
# PyTorch port. The port's checkpoints are the reference's own
# step_N.pth layout, so it reads a reference save directly: there is no
# conversion step (the JAX package's examples/migrate_from_reference.sh
# converts to orbax with export.from_torch).
#
# 1. writes a reference-format step_6.pth — the reference's state-dict
#    names and a torch AdamW state dict that never stepped the unused
#    pooler, as the reference's own saves (train.py:412-425) — a stand-in
#    for a real run's artifact, e.g. the published 1M-step checkpoint;
# 2. packs a corpus into the memory-mapped training store;
# 3. scores the reference checkpoint as-is (evaluate reads .pth);
# 4. places it in a run directory beside the run's config, where the
#    Trainer RESUMES it like one of its own checkpoints (AdamW moments
#    included, so the continued run has no Adam re-warm bump) — for a
#    params-only warm start instead, point model_params.pretrained_model
#    at the .pth;
# 5. scores the continued run and exports it to HF AlbertModel for
#    StyleTTS.
#
# Training and scoring run on DEVICE (default cuda; DEVICE=cpu runs them
# on the CPU).
set -euo pipefail

# a fresh directory of its own unless one is given
WORK="${1:-$(mktemp -d "${TMPDIR:-/tmp}/pl_bert_torch_migrate.XXXXXX")}"
DEVICE="${DEVICE:-cuda}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
rm -rf "$WORK" && mkdir -p "$WORK"
echo "work directory: $WORK"

cat > "$WORK/config.yml" <<YML
preprocess_params:
  num_shards: 2
  max_workers: 2
  max_try_count: 1
  timeout: 120
  preprocess_dir: "$WORK/prep"
  cleaned_output_dir: "cleaned"
  g2p_backend: "identity"
training_params:
  output_dir: "$WORK/ckpt"
  batch_size: 4
  save_interval: 10
  log_interval: 2
  num_steps: 10
  learning_rate: 1e-4
  training_dataset: "$WORK/prep/cleaned.phonemized.packed"
  mixed_precision: "fp32"
dataset_params:
  max_seq_length: 512
  ondevice_masking: true
model_params:
  hidden_size: 256
  num_attention_heads: 4
  intermediate_size: 512
  max_position_embeddings: 512
  num_hidden_layers: 4
  embedding_size: 128
YML

echo "== 1. a reference-format checkpoint (state dict + torch AdamW state) =="
python - <<PY
import torch
from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.models.albert import build_model, draw_dropout_seeds

torch.manual_seed(0)
cfg = Config.load("$WORK/config.yml")
m = build_model(cfg.model_params, "fp32")  # the reference's state-dict names
# a couple of real AdamW steps so the checkpoint carries genuine
# optimizer state (exp_avg / exp_avg_sq / step), like any mid-run save;
# the pooler gets no gradient and no state, as in the reference
opt = torch.optim.AdamW(m.parameters(), lr=1e-4)
ids = torch.randint(0, 188, (2, 64))
gen = torch.Generator().manual_seed(0)
for _ in range(2):
    seeds = draw_dropout_seeds(gen, cfg.model_params.num_hidden_layers)
    loss = m(ids, deterministic=False, dropout_seeds=seeds).float().pow(2).mean()
    opt.zero_grad(); loss.backward(); opt.step()
torch.save({"net": m.state_dict(), "step": 6, "epoch": 0,
            "optimizer": opt.state_dict()}, "$WORK/reference_step_6.pth")
print("saved $WORK/reference_step_6.pth (with AdamW state)")
PY

echo "== 2. corpus -> packed store =="
cat > "$WORK/base_corpus.txt" <<'TXT'
ولد الكاتب عام 1986 في مدينة كبيرة، وكان يحب القراءة منذ الصغر.
العلم نور والجهل ظلام، والقراءة مفتاح المعرفة لكل إنسان.
ذهب الطفل إلى المدرسة صباحا، وعاد إلى البيت مساء وهو سعيد.
كتب 3 رسائل إلى أصدقائه القدامى في المدينة البعيدة جدا.
TXT
# 40 articles so the reference's 95/5 split semantics (int(0.05*N))
# leave a non-empty validation set for the evaluate steps below
for _ in $(seq 1 10); do cat "$WORK/base_corpus.txt"; done > "$WORK/corpus.txt"
python -m pl_bert_tpu_torch.preprocess.pipeline --config_path "$WORK/config.yml" \
    --local_dataset_path "$WORK/corpus.txt" --stage clean
python -m pl_bert_tpu_torch.preprocess.pipeline --config_path "$WORK/config.yml" \
    --stage phonemize --dataset_path "$WORK/prep/cleaned"
python -m pl_bert_tpu_torch.preprocess.pipeline --config_path "$WORK/config.yml" \
    --stage pack --dataset_path "$WORK/prep/cleaned.phonemized"

echo "== 3. score the reference checkpoint as-is (no training needed) =="
python -m pl_bert_tpu_torch.training.evaluate --config_path "$WORK/config.yml" \
    --checkpoint "$WORK/reference_step_6.pth" --device "$DEVICE"

echo "== 4. the trainer resumes the reference run (steps 7..10) =="
mkdir -p "$WORK/ckpt/migrated"
cp "$WORK/reference_step_6.pth" "$WORK/ckpt/migrated/step_6.pth"
cp "$WORK/config.yml" "$WORK/ckpt/migrated/config.yml"
python -m pl_bert_tpu_torch.training.train --config_path "$WORK/config.yml" \
    --run_name migrated --device "$DEVICE"

echo "== 5. score the continued run =="
python -m pl_bert_tpu_torch.training.evaluate --config_path "$WORK/config.yml" \
    --checkpoint "$WORK/ckpt/migrated" --device "$DEVICE"

echo "== 6. export the continued run for StyleTTS =="
python -m pl_bert_tpu_torch.export.cli \
    --checkpoint_path "$WORK/ckpt/migrated/step_10.pth" \
    --config_path "$WORK/config.yml" \
    --output_dir "$WORK/hf_export"

echo "migration complete: artifacts in $WORK"

#!/usr/bin/env bash
# End-to-end PL-BERT pipeline of the PyTorch port on a toy corpus:
# clean → phonemize → tokenize → pack → pretrain from the packed store →
# the multi-task run (phoneme + grapheme heads) → export to HuggingFace →
# encode phonemes with the export.
#
# Uses the dependency-free identity G2P backend; set g2p_backend to
# "espeak" with libespeak-ng installed (or PLBERT_ESPEAK_LIB pointing at
# it) for real IPA phonemization. The text stages run on the host; the
# training and encoding steps run on DEVICE (default cuda; DEVICE=cpu
# runs them, slowly, on the CPU).
set -euo pipefail

# a fresh directory of its own unless one is given
WORK="${1:-$(mktemp -d "${TMPDIR:-/tmp}/pl_bert_torch_example.XXXXXX")}"
DEVICE="${DEVICE:-cuda}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
rm -rf "$WORK" && mkdir -p "$WORK"
echo "work directory: $WORK"

# --- a toy Arabic corpus (one article per line) -------------------------
cat > "$WORK/corpus.txt" <<'TXT'
ولد الكاتب عام 1986 في مدينة كبيرة، وكان يحب القراءة منذ الصغر.
العلم نور والجهل ظلام، والقراءة مفتاح المعرفة لكل إنسان.
ذهب الطفل إلى المدرسة صباحا، وعاد إلى البيت مساء وهو سعيد.
كتب 3 رسائل إلى أصدقائه القدامى في المدينة البعيدة جدا.
TXT

# --- config --------------------------------------------------------------
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
  batch_size: 2
  save_interval: 10
  log_interval: 2
  num_steps: 10
  learning_rate: 1e-3
  training_dataset: "$WORK/prep/cleaned.phonemized.packed"
  mixed_precision: "fp32"
dataset_params:
  max_seq_length: 64
  ondevice_masking: true
model_params:
  hidden_size: 128
  num_attention_heads: 2
  intermediate_size: 256
  max_position_embeddings: 64
  num_hidden_layers: 2
  embedding_size: 32
  attention_impl: "auto"
YML

stage() {
    python -m pl_bert_tpu_torch.preprocess.pipeline --config_path "$WORK/config.yml" "$@"
}

echo "== 1. clean =="
stage --local_dataset_path "$WORK/corpus.txt" --stage clean

echo "== 2. phonemize =="
stage --stage phonemize --dataset_path "$WORK/prep/cleaned"

echo "== 2b. tokenize (multi-task token_ids column + word tokenizer) =="
stage --stage tokenize --dataset_path "$WORK/prep/cleaned.phonemized" \
    --tokenizer_dir "$WORK/prep/word_tokenizer"

echo "== 2c. pack into the memory-mapped training store =="
stage --stage pack --dataset_path "$WORK/prep/cleaned.phonemized"
python -m pl_bert_tpu_torch.data.verify_store "$WORK/prep/cleaned.phonemized.packed"

echo "== 3. pretrain (from the packed store) =="
python -m pl_bert_tpu_torch.training.train --config_path "$WORK/config.yml" \
    --run_name demo --device "$DEVICE"

echo "== 3b. pretrain the multi-task variant (phoneme + grapheme heads) =="
python - <<PY
import json, yaml
cfg = yaml.safe_load(open("$WORK/config.yml"))
cfg["training_params"]["training_dataset"] = \
    "$WORK/prep/cleaned.phonemized.tokenized"
tok = json.load(open("$WORK/prep/word_tokenizer/tokenizer.json"))
# the grapheme label at separator positions is word_separator (87,
# reference dataloader.py:67-68), so the head must cover it too
sep = cfg.get("dataset_params", {}).get("word_separator", 87)
cfg["model_params"]["num_token_vocab"] = max(tok["vocab_size"], sep + 1)
yaml.safe_dump(cfg, open("$WORK/config_multitask.yml", "w"),
               allow_unicode=True)
PY
python -m pl_bert_tpu_torch.training.train \
    --config_path "$WORK/config_multitask.yml" --run_name demo_multitask \
    --device "$DEVICE"

echo "== 4. export to HuggingFace =="
python -m pl_bert_tpu_torch.export.cli \
    --checkpoint_path "$WORK/ckpt/demo/step_10.pth" \
    --config_path "$WORK/config.yml" \
    --output_dir "$WORK/hf_export"

echo "== 5. encode phonemes with the trained model =="
python - <<PY
from pl_bert_tpu_torch.models.inference import PhonemeEncoder
enc = PhonemeEncoder.from_hf_export("$WORK/hf_export", device="$DEVICE")
hidden, lengths = enc(["mrhba balʕalm", "ktab w qlm"])
print(f"hidden states: {hidden.shape}, lengths: {lengths.tolist()}")
PY

echo "end-to-end pipeline complete: artifacts in $WORK"

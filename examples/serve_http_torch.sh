#!/usr/bin/env bash
# Online serving demo of the PyTorch port: pretrain a toy model, serve it
# over HTTP with dynamic request batching, and query it — the production
# path (bucket-aware batch formation, queue backpressure, live /stats,
# zero-downtime /reload). The model trains and serves on DEVICE (default
# cuda; DEVICE=cpu runs it on the CPU).
set -euo pipefail

# a fresh directory of its own unless one is given
WORK="${1:-$(mktemp -d "${TMPDIR:-/tmp}/pl_bert_torch_serve_example.XXXXXX")}"
PORT="${2:-8787}"
DEVICE="${DEVICE:-cuda}"
REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
rm -rf "$WORK" && mkdir -p "$WORK"
echo "work directory: $WORK"

cat > "$WORK/config.yml" <<YML
training_params:
  output_dir: "$WORK/ckpt"
  batch_size: 4
  save_interval: 5
  log_interval: 2
  num_steps: 10
  learning_rate: 1e-3
  training_dataset: "synthetic:32"
  mixed_precision: "fp32"
dataset_params:
  max_seq_length: 64
model_params:
  hidden_size: 128
  num_attention_heads: 2
  intermediate_size: 256
  max_position_embeddings: 64
  num_hidden_layers: 2
  embedding_size: 32
  attention_impl: "auto"
YML

echo "== 1. pretrain a toy model =="
python -m pl_bert_tpu_torch.training.train --config_path "$WORK/config.yml" \
    --run_name demo --device "$DEVICE"

echo "== 2. serve it (bucketed batching, bounded queue) =="
python -m pl_bert_tpu_torch.serving.server \
    --checkpoint "$WORK/ckpt/demo/step_5.pth" --config_path "$WORK/config.yml" \
    --port "$PORT" --max_batch 8 --max_wait_ms 5 --device "$DEVICE" \
    --buckets 16,32,64 --max_pending 64 > "$WORK/server.log" 2>&1 &
SERVER_PID=$!
trap 'kill $SERVER_PID 2>/dev/null || true' EXIT
for _ in $(seq 1 120); do
    curl -sf "http://127.0.0.1:$PORT/healthz" > /dev/null 2>&1 && break
    sleep 1
done

echo "== 3. liveness =="
curl -s "http://127.0.0.1:$PORT/healthz"; echo

echo "== 4. encode one utterance (valid-prefix hidden states) =="
curl -s -X POST "http://127.0.0.1:$PORT/encode" \
    -H 'Content-Type: application/json' \
    -d '{"phonemes": "mrhba balʕalm", "round": 3}' \
    | python -c 'import json,sys; r=json.load(sys.stdin); print("length=%d, hidden rows=%d, H=%d" % (r["length"], len(r["hidden"]), len(r["hidden"][0])))'

echo "== 5. concurrent clients coalesce into shared batches =="
CURL_PIDS=()
for i in $(seq 1 12); do
    curl -s -o /dev/null -X POST "http://127.0.0.1:$PORT/encode" \
        -H 'Content-Type: application/json' \
        -d "{\"phonemes\": \"ktab w qlm $i\"}" &
    CURL_PIDS+=($!)
done
# wait on the curls specifically — a bare `wait` would also block on
# the background server process
wait "${CURL_PIDS[@]}"

echo "== 6. serving stats (batching + latency percentiles) =="
curl -s "http://127.0.0.1:$PORT/stats"; echo

echo "== 7. Prometheus scrape + typed Python client =="
curl -s "http://127.0.0.1:$PORT/metrics" | head -3
python - <<PY
from pl_bert_tpu_torch.serving.client import ServingClient
client = ServingClient("http://127.0.0.1:$PORT")
hidden, length = client.encode("mrhba", round_decimals=3)
print(f"client.encode -> hidden {hidden.shape}, length {length}")
PY

echo "== 8. zero-downtime checkpoint rollout (step_5 -> step_10) =="
curl -s -X POST "http://127.0.0.1:$PORT/reload" \
    -H 'Content-Type: application/json' \
    -d "{\"checkpoint\": \"$WORK/ckpt/demo/step_10.pth\"}"; echo
curl -s "http://127.0.0.1:$PORT/healthz" \
    | python -c 'import json,sys; print("now serving:", json.load(sys.stdin)["checkpoint"])'

echo "serving demo complete: server log in $WORK/server.log"

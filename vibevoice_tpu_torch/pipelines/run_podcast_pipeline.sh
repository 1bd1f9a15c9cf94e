#!/usr/bin/env bash
# Podcast automation pipeline on the PyTorch port — the port's copy of
# pipelines/run_podcast_pipeline.sh: download script -> batch inference w/
# captions (python -m vibevoice_tpu_torch.demo.batch_inference_simple_captions,
# on the GPU) -> wav->mp3 192k -> upload audio + SRT captions.
#
# Positional args mirror the reference invocation
# (`setup_cron.sh:29-35`): DATE TIME_SLOT API_KEY MODEL_PATH
# Upload/download stages are pluggable command templates (the reference
# hardcodes node scripts, run_podcast_pipeline.sh:30,:123,:136):
#   DOWNLOAD_CMD     — invoked as: $DOWNLOAD_CMD <date> <time_slot> <api_key>
#                      (must print the script path; optional — otherwise
#                      scripts are read from $SCRIPTS_DIR)
#   UPLOAD_AUDIO_CMD — invoked per file: $UPLOAD_AUDIO_CMD <mp3|wav> <api_key>
#   UPLOAD_SRT_CMD   — invoked per file: $UPLOAD_SRT_CMD <srt> <api_key>
#   UPLOAD_CMD       — legacy whole-directory hook: $UPLOAD_CMD <output_dir>
# PIPELINE_DRY_RUN=1 replaces the inference step with a stub wav+srt so the
# full stage chain can be exercised without a model (test_cron_command.sh).
set -euo pipefail

REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
DATE_TAG="${1:-${DATE_TAG:-$(date +%Y-%m-%d)}}"
TIME_SLOT="${2:-${TIME_SLOT:-adhoc}}"
API_KEY="${3:-${API_KEY:-}}"
MODEL_PATH="${4:-${MODEL_PATH:-}}"

SCRIPTS_DIR="${SCRIPTS_DIR:-$REPO_DIR/data/scripts/$DATE_TAG}"
OUTPUT_DIR="${OUTPUT_DIR:-$REPO_DIR/outputs/$DATE_TAG}"
LOG_DIR="${LOG_DIR:-$REPO_DIR/logs}"
mkdir -p "$LOG_DIR" "$OUTPUT_DIR"
LOG="$LOG_DIR/podcast_${TIME_SLOT}_$(date +%Y%m%d).log"

echo "[$(date)] podcast pipeline start (date=$DATE_TAG slot=$TIME_SLOT)" | tee -a "$LOG"

# ---- stage 1: download script (pluggable; ref node downloadPodcastScript.js)
if [ -n "${DOWNLOAD_CMD:-}" ]; then
  mkdir -p "$SCRIPTS_DIR"
  DL_OUT=$($DOWNLOAD_CMD "$DATE_TAG" "$TIME_SLOT" "$API_KEY")
  echo "$DL_OUT" | tee -a "$LOG"
  DL_FILE=$(echo "$DL_OUT" | sed -n 's/.*Script saved to: //p' | tail -1)
  if [ -n "$DL_FILE" ] && [ -f "$DL_FILE" ]; then
    cp "$DL_FILE" "$SCRIPTS_DIR/" 2>/dev/null || true
  fi
fi

if [ ! -d "$SCRIPTS_DIR" ] || [ -z "$(ls -A "$SCRIPTS_DIR" 2>/dev/null)" ]; then
  echo "[$(date)] no scripts found in $SCRIPTS_DIR, exiting" | tee -a "$LOG"
  exit 0
fi

# ---- stage 2: batch inference with captions
if [ "${PIPELINE_DRY_RUN:-0}" = "1" ]; then
  echo "[$(date)] DRY RUN: stubbing inference outputs" | tee -a "$LOG"
  for txt in "$SCRIPTS_DIR"/*.txt; do
    [ -e "$txt" ] || continue
    base=$(basename "${txt%.txt}")
    # minimal valid wav (44-byte header + 1 silent sample, 24 kHz mono s16)
    python - "$OUTPUT_DIR/$base.wav" <<'PY'
import struct, sys
path = sys.argv[1]
data = struct.pack('<4sI4s4sIHHIIHH4sI', b'RIFF', 38, b'WAVE', b'fmt ', 16,
                   1, 1, 24000, 48000, 2, 16, b'data', 2) + b'\x00\x00'
open(path, 'wb').write(data)
PY
    printf '1\n00:00:00,000 --> 00:00:01,000\n%s\n' "$base" > "$OUTPUT_DIR/$base.srt"
  done
else
  MODEL_ARG=""
  [ -n "$MODEL_PATH" ] && MODEL_ARG="--model_path $MODEL_PATH"
  PYTHONPATH="$REPO_DIR${PYTHONPATH:+:$PYTHONPATH}" \
  python -m vibevoice_tpu_torch.demo.batch_inference_simple_captions \
    $MODEL_ARG \
    --input_dir "$SCRIPTS_DIR" \
    --output_dir "$OUTPUT_DIR" \
    --batch_size "${BATCH_SIZE:-8}" 2>&1 | tee -a "$LOG"
fi

# ---- stage 3: wav -> mp3 192k (ref :81)
if command -v ffmpeg >/dev/null 2>&1; then
  for wav in "$OUTPUT_DIR"/*.wav; do
    [ -e "$wav" ] || continue
    ffmpeg -y -i "$wav" -b:a 192k "${wav%.wav}.mp3" >>"$LOG" 2>&1 || true
  done
fi

# ---- stage 4: uploads (audio, prefer mp3 like the reference :97; then SRT)
for wav in "$OUTPUT_DIR"/*.wav; do
  [ -e "$wav" ] || continue
  upload_file="$wav"
  [ -f "${wav%.wav}.mp3" ] && upload_file="${wav%.wav}.mp3"
  if [ -n "${UPLOAD_AUDIO_CMD:-}" ]; then
    $UPLOAD_AUDIO_CMD "$upload_file" "$API_KEY" 2>&1 | tee -a "$LOG"
  fi
  srt="${wav%.wav}.srt"
  [ ! -f "$srt" ] && srt="$OUTPUT_DIR/captions/$(basename "${wav%.wav}").srt"
  if [ -f "$srt" ] && [ -n "${UPLOAD_SRT_CMD:-}" ]; then
    $UPLOAD_SRT_CMD "$srt" "$API_KEY" 2>&1 | tee -a "$LOG"
  fi
done
if [ -n "${UPLOAD_CMD:-}" ]; then
  $UPLOAD_CMD "$OUTPUT_DIR" 2>&1 | tee -a "$LOG"
fi

echo "[$(date)] podcast pipeline done" | tee -a "$LOG"

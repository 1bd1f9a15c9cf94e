#!/usr/bin/env bash
# Exercise the PyTorch port's pipeline's full stage chain with today's date —
# the port's copy of pipelines/test_cron_command.sh (equivalent of the
# reference's test_cron_command.sh), runnable without a model or
# network: PIPELINE_DRY_RUN stubs inference, and the upload stages fire
# echo commands so each pluggable hook is verified.
set -euo pipefail
REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"

WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$WORK/scripts"
printf 'Speaker 1: Testing the pipeline.\nSpeaker 2: All stages should fire.\n' \
  > "$WORK/scripts/test_episode.txt"

SCRIPTS_DIR="$WORK/scripts" \
OUTPUT_DIR="$WORK/out" \
LOG_DIR="$WORK/logs" \
PIPELINE_DRY_RUN=1 \
UPLOAD_AUDIO_CMD="echo UPLOAD_AUDIO" \
UPLOAD_SRT_CMD="echo UPLOAD_SRT" \
  "$REPO_DIR/vibevoice_tpu_torch/pipelines/run_podcast_pipeline.sh" "$(date +%Y-%m-%d)" "test" "dummy-key"

echo "--- checks ---"
test -f "$WORK/out/test_episode.wav" && echo "wav: ok"
test -f "$WORK/out/test_episode.srt" && echo "srt: ok"
LOG_FILE="$WORK/logs/podcast_test_$(date +%Y%m%d).log"
test -f "$LOG_FILE" && echo "dated log: ok"
grep -q "UPLOAD_AUDIO" "$LOG_FILE" && echo "audio upload stage: ok"
grep -q "UPLOAD_SRT" "$LOG_FILE" && echo "srt upload stage: ok"
echo "PIPELINE DRY PATH OK"

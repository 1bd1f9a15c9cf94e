#!/usr/bin/env bash
# Install crontab entries for the PyTorch port's pipelines — the port's copy
# of pipelines/setup_cron.sh, which replaces the entries of either copy.
# Schedule + dated-log parity with the reference's
# setup_cron.sh (:29-46): weekday morning 12:35 / evening 21:35 UTC, weekend
# "weekly" runs at 21:35, stock digest daily at 13:00 UTC; each entry logs to
# its own dated file (morning_YYYYMMDD.log etc.).
set -euo pipefail
REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
API_KEY="${API_KEY:-}"
MODEL_PATH="${MODEL_PATH:-}"
LOGS="$REPO_DIR/logs"
mkdir -p "$LOGS" "$LOGS/stock_digests"

P="$REPO_DIR/vibevoice_tpu_torch/pipelines/run_podcast_pipeline.sh"
S="$REPO_DIR/vibevoice_tpu_torch/pipelines/run_stock_digest_pipeline.sh"

CRON_TMP="$(mktemp)"
crontab -l 2>/dev/null | grep -v "run_podcast_pipeline.sh" | grep -v "run_stock_digest_pipeline.sh" > "$CRON_TMP" || true
cat >> "$CRON_TMP" <<CRON
# Podcast Pipeline - Morning (12:35 UTC, Monday-Friday)
35 12 * * 1-5 cd $REPO_DIR && $P "\$(date +\%Y-\%m-\%d)" "morning" "$API_KEY" "$MODEL_PATH" >> $LOGS/morning_\$(date +\%Y\%m\%d).log 2>&1
# Podcast Pipeline - Evening (21:35 UTC, Monday-Friday)
35 21 * * 1-5 cd $REPO_DIR && $P "\$(date +\%Y-\%m-\%d)" "evening" "$API_KEY" "$MODEL_PATH" >> $LOGS/evening_\$(date +\%Y\%m\%d).log 2>&1
# Podcast Pipeline - Weekly Saturday (21:35 UTC)
35 21 * * 6 cd $REPO_DIR && $P "\$(date +\%Y-\%m-\%d)" "weekly" "$API_KEY" "$MODEL_PATH" >> $LOGS/weekly_saturday_\$(date +\%Y\%m\%d).log 2>&1
# Podcast Pipeline - Weekly Sunday (21:35 UTC)
35 21 * * 0 cd $REPO_DIR && $P "\$(date +\%Y-\%m-\%d)" "weekly" "$API_KEY" "$MODEL_PATH" >> $LOGS/weekly_sunday_\$(date +\%Y\%m\%d).log 2>&1
# Stock Digest Pipeline (13:00 UTC, daily)
0 13 * * * cd $REPO_DIR && $S "\$(date +\%Y-\%m-\%d)" "$API_KEY" "$MODEL_PATH" >> $LOGS/stock_digest_\$(date +\%Y\%m\%d).log 2>&1
CRON
crontab "$CRON_TMP"
rm -f "$CRON_TMP"
echo "cron installed:"
crontab -l | grep -E "run_(podcast|stock_digest)_pipeline" || true

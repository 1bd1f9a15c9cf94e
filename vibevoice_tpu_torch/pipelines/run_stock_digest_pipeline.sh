#!/usr/bin/env bash
# Stock Digest Pipeline (batch) on the PyTorch port — the port's copy of
# pipelines/run_stock_digest_pipeline.sh (behavioral port of the reference's
# run_stock_digest_pipeline.sh:17-354): download per-ticker digest scripts for
# a date, filter files by the MM_DD_YY date pattern (and optional ticker
# list), run ONE parallel batch inference over all of them on the GPU
# (python -m vibevoice_tpu_torch.demo.batch_inference_simple_captions; the
# batch dimension is the GPU-utilization fan-out the reference notes at :127-128),
# then per file: extract ticker + digest UUID from the filename, match the
# generated wav, convert to mp3 192k, upload audio + SRT caption, and keep
# per-file success/failure accounting.
#
# Usage: run_stock_digest_pipeline.sh <date> <api_key> <model_path> [tickers]
#   date:       YYYY-MM-DD
#   api_key:    passed to the pluggable download/upload commands
#   model_path: VibeVoice checkpoint dir ("" -> random-weight smoke run)
#   tickers:    optional comma-separated list (e.g. AAPL,MSFT) — filters both
#               the download request and the file list
#
# Pluggable stages (the reference hardcodes node scripts at :51-53,:305,:321):
#   DOWNLOAD_CMD     — $DOWNLOAD_CMD <date> <api_key> [tickers]; should drop
#                      TICKER_MM_DD_YY_UUID.txt files into $DIGESTS_DIR and/or
#                      print "stock_digests/...txt" paths
#   UPLOAD_AUDIO_CMD — $UPLOAD_AUDIO_CMD <mp3|wav> <digest_id> <api_key>
#   UPLOAD_SRT_CMD   — $UPLOAD_SRT_CMD <srt> <digest_id> <api_key>
# PIPELINE_DRY_RUN=1 stubs the inference step (wav + srt per input) so tests
# can exercise filtering / matching / accounting without a model.
set -uo pipefail

REPO_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
cd "$REPO_DIR" || exit 1

if [ $# -lt 3 ] && [ -z "${PIPELINE_DRY_RUN:-}" ]; then
    echo "Usage: $0 <date> <api_key> <model_path> [tickers]"
    echo "  tickers: optional comma-separated list (e.g. AAPL,MSFT,GOOGL);"
    echo "           omitted -> process all digests for the date"
    exit 1
fi

DATE="${1:-$(date +%Y-%m-%d)}"
API_KEY="${2:-}"
MODEL_PATH="${3:-}"
TICKERS="${4:-}"

DIGESTS_DIR="${DIGESTS_DIR:-$REPO_DIR/stock_digests}"
OUTPUT_DIR="${OUTPUT_DIR:-$REPO_DIR/outputs}"
BATCH_SIZE="${BATCH_SIZE:-16}"
LOG_DIR="${LOG_DIR:-$REPO_DIR/logs}"
mkdir -p "$LOG_DIR" "$OUTPUT_DIR"
LOG="$LOG_DIR/stock_digest_$(date +%Y%m%d).log"

echo "=========================================="
echo "Stock Digest Batch Pipeline"
echo "=========================================="
echo "Date: $DATE"
echo "Model Path: ${MODEL_PATH:-<random smoke>}"
if [ -n "$TICKERS" ]; then
    echo "Tickers: $TICKERS"
else
    echo "Tickers: All available"
fi
echo "=========================================="

# ---- step 1: download digest scripts (pluggable; ref node
# batchDownloadStockDigests.js :51-53)
DL_OUT=""
if [ -n "${DOWNLOAD_CMD:-}" ]; then
    echo "Step 1: Downloading stock digest scripts..."
    mkdir -p "$DIGESTS_DIR"
    if [ -n "$TICKERS" ]; then
        DL_OUT=$($DOWNLOAD_CMD "$DATE" "$API_KEY" "$TICKERS")
    else
        DL_OUT=$($DOWNLOAD_CMD "$DATE" "$API_KEY")
    fi
    echo "$DL_OUT" | tee -a "$LOG"
fi

# date YYYY-MM-DD -> MM_DD_YY filename pattern (ref :65)
DATE_FORMATTED=$(echo "$DATE" | awk -F'-' '{printf "%02d_%02d_%s", $2, $3, substr($1,3,2)}')
echo "Filtering files for date: $DATE (pattern: *_${DATE_FORMATTED}*.txt)"

# method 1: paths printed by the download command, date-filtered (ref :71)
FILENAMES=$(echo "$DL_OUT" | grep -oE "[^[:space:]]*stock_digests/[^[:space:]]+\.txt" \
            | grep "_${DATE_FORMATTED}" | sort -u || true)
# method 2 (primary): find by date pattern in the digests dir (ref :74-76)
if [ -z "$FILENAMES" ]; then
    FILENAMES=$(find "$DIGESTS_DIR" -name "*_${DATE_FORMATTED}*.txt" -type f 2>/dev/null | sort)
fi

# optional ticker filter — the reference filters at download only (:50-54);
# filtering the file list too keeps the find-fallback path consistent
if [ -n "$TICKERS" ] && [ -n "$FILENAMES" ]; then
    TICKER_RE=$(echo "$TICKERS" | tr ',' '|')
    FILENAMES=$(echo "$FILENAMES" | grep -E "/(${TICKER_RE})_" || true)
fi

# method 3: nothing matched -> debug listing + hard error (ref :79-106)
if [ -z "$FILENAMES" ]; then
    echo "Warning: No files found with date pattern *_${DATE_FORMATTED}*.txt"
    echo "   Files present in $DIGESTS_DIR:"
    find "$DIGESTS_DIR" -name "*.txt" -type f 2>/dev/null | head -5 | while read -r f; do
        echo "   - $f"
    done
    echo "ERROR: No stock digest files found for date $DATE"
    exit 1
fi

mapfile -t FILE_ARRAY < <(echo "$FILENAMES" | grep -v '^$')
FILE_COUNT=${#FILE_ARRAY[@]}
echo ""
echo "Found $FILE_COUNT stock digest file(s) to process:"
printf '  - %s\n' "${FILE_ARRAY[@]}"
echo ""

# ---- step 2.1: ONE batch inference over all files (ref :126-149 — the
# parallel fan-out; batch_size is the GPU utilization lever)
echo "Step 2.1: Running batch inference (${FILE_COUNT} files, batch_size=$BATCH_SIZE)..."
if [ "${PIPELINE_DRY_RUN:-0}" = "1" ]; then
    PYTHON_OUTPUT=""
    for txt in "${FILE_ARRAY[@]}"; do
        base=$(basename "${txt%.txt}")
        python - "$OUTPUT_DIR/$base.wav" <<'PY'
import struct, sys
path = sys.argv[1]
data = struct.pack('<4sI4s4sIHHIIHH4sI', b'RIFF', 38, b'WAVE', b'fmt ', 16,
                   1, 1, 24000, 48000, 2, 16, b'data', 2) + b'\x00\x00'
open(path, 'wb').write(data)
PY
        printf '1\n00:00:00,000 --> 00:00:01,000\n%s\n' "$base" > "$OUTPUT_DIR/$base.srt"
        PYTHON_OUTPUT+="Saved audio to: $OUTPUT_DIR/$base.wav"$'\n'
    done
    PYTHON_EXIT_CODE=0
    echo "$PYTHON_OUTPUT"
else
    MODEL_ARG=""
    [ -n "$MODEL_PATH" ] && MODEL_ARG="--model_path $MODEL_PATH"
    TEMP_OUTPUT=$(mktemp "${TMPDIR:-/tmp}/stock_batch_out.XXXXXX")
    PYTHONUNBUFFERED=1 python -m vibevoice_tpu_torch.demo.batch_inference_simple_captions \
        $MODEL_ARG \
        --txt_files "${FILE_ARRAY[@]}" \
        --output_dir "$OUTPUT_DIR" \
        --batch_size "$BATCH_SIZE" \
        --generate_captions \
        --caption_formats srt \
        2>&1 | tee "$TEMP_OUTPUT" | tee -a "$LOG"
    PYTHON_EXIT_CODE=${PIPESTATUS[0]}
    PYTHON_OUTPUT=$(cat "$TEMP_OUTPUT")
    rm -f "$TEMP_OUTPUT"
fi

if [ "$PYTHON_EXIT_CODE" -ne 0 ]; then
    echo "ERROR: Batch inference failed"
    exit 1
fi

# outputs advertised as "Saved audio to: <file>" lines (ref :162-171)
mapfile -t OUTPUT_FILES_ARRAY < <(echo "$PYTHON_OUTPUT" | grep "Saved audio to:" \
    | sed 's/.*Saved audio to: //' | sed 's|^\./||' | grep -v '^$')
if [ ${#OUTPUT_FILES_ARRAY[@]} -eq 0 ]; then
    echo "ERROR: No output files generated from batch inference"
    echo "$PYTHON_OUTPUT" | tail -20
    exit 1
fi
echo "Batch inference completed. Generated ${#OUTPUT_FILES_ARRAY[@]} audio file(s):"
printf '  - %s\n' "${OUTPUT_FILES_ARRAY[@]}"
echo ""

# ---- step 2.2: per-file uploads with accounting (ref :179-333)
SUCCESS_COUNT=0
FAILED_COUNT=0
FAILED_FILES=()

for FILENAME in "${FILE_ARRAY[@]}"; do
    if [ -z "$FILENAME" ] || [ ! -f "$FILENAME" ]; then
        echo "Skipping: file not found - $FILENAME"
        FAILED_COUNT=$((FAILED_COUNT + 1)); FAILED_FILES+=("$FILENAME"); continue
    fi
    echo "---- Processing: $FILENAME"

    # TICKER_MM_DD_YY_UUID.txt -> ticker + digest id (ref :196-224)
    FILENAME_BASE=$(basename "$FILENAME" .txt)
    TICKER=$(echo "$FILENAME_BASE" | cut -d'_' -f1)
    ID=$(echo "$FILENAME_BASE" \
         | grep -oE '[a-f0-9]{8}-[a-f0-9]{4}-[a-f0-9]{4}-[a-f0-9]{4}-[a-f0-9]{12}' \
         | head -1 || true)
    if [ -z "$ID" ]; then
        # legacy 8-char short id fallback (ref :206-216)
        ID=$(echo "$FILENAME_BASE" | grep -oE '[a-f0-9]{8}$' | head -1 || true)
        [ -n "$ID" ] && echo "  Warning: only short digest id found: $ID"
    fi
    if [ -z "$ID" ]; then
        echo "  ERROR: could not extract digest id from $FILENAME (want TICKER_MM_DD_YY_ID.txt)"
        FAILED_COUNT=$((FAILED_COUNT + 1)); FAILED_FILES+=("$FILENAME"); continue
    fi
    echo "  Ticker: $TICKER"
    echo "  Digest ID: $ID"

    # match the generated wav: basename, then id, then ticker+date (ref :229-273)
    PYTHON_FILENAME=""
    for out in "${OUTPUT_FILES_ARRAY[@]}"; do
        OUT_BASE=$(basename "$out" .wav | sed 's/_generated$//')
        if [ "$OUT_BASE" = "$FILENAME_BASE" ]; then PYTHON_FILENAME="$out"; break; fi
    done
    if [ -z "$PYTHON_FILENAME" ]; then
        for out in "${OUTPUT_FILES_ARRAY[@]}"; do
            if echo "$out" | grep -q "$ID"; then PYTHON_FILENAME="$out"; break; fi
        done
    fi
    if [ -z "$PYTHON_FILENAME" ]; then
        for out in "${OUTPUT_FILES_ARRAY[@]}"; do
            if echo "$out" | grep -q "${TICKER}_${DATE_FORMATTED}"; then
                PYTHON_FILENAME="$out"; break
            fi
        done
    fi
    if [ -z "$PYTHON_FILENAME" ] || [ ! -f "$PYTHON_FILENAME" ]; then
        echo "  ERROR: could not find generated audio for $FILENAME"
        FAILED_COUNT=$((FAILED_COUNT + 1)); FAILED_FILES+=("$FILENAME"); continue
    fi
    echo "  Found generated audio: $PYTHON_FILENAME"

    # wav -> mp3 192k (ref :277-300)
    UPLOAD_FILENAME="$PYTHON_FILENAME"
    if command -v ffmpeg >/dev/null 2>&1; then
        MP3_FILENAME="${PYTHON_FILENAME%.wav}.mp3"
        if ffmpeg -i "$PYTHON_FILENAME" -codec:a libmp3lame -b:a 192k -y \
                  "$MP3_FILENAME" >>"$LOG" 2>&1; then
            UPLOAD_FILENAME="$MP3_FILENAME"
            echo "  Converted to MP3: $MP3_FILENAME"
        else
            echo "  Warning: MP3 conversion failed, using WAV"
        fi
    else
        echo "  Warning: ffmpeg not found, using WAV"
    fi

    # audio upload — failure fails the file (ref :302-312)
    if [ -n "${UPLOAD_AUDIO_CMD:-}" ]; then
        if $UPLOAD_AUDIO_CMD "$UPLOAD_FILENAME" "$ID" "$API_KEY" 2>&1 | tee -a "$LOG"; then
            echo "  Audio uploaded"
        else
            echo "  ERROR: audio upload failed"
            FAILED_COUNT=$((FAILED_COUNT + 1)); FAILED_FILES+=("$FILENAME"); continue
        fi
    fi

    # SRT upload — failure only warns (ref :314-328)
    AUDIO_BASENAME=$(basename "$PYTHON_FILENAME" .wav)
    SRT_FILENAME="$(dirname "$PYTHON_FILENAME")/${AUDIO_BASENAME}.srt"
    [ ! -f "$SRT_FILENAME" ] && SRT_FILENAME="$OUTPUT_DIR/captions/${AUDIO_BASENAME}.srt"
    if [ -f "$SRT_FILENAME" ]; then
        if [ -n "${UPLOAD_SRT_CMD:-}" ]; then
            if $UPLOAD_SRT_CMD "$SRT_FILENAME" "$ID" "$API_KEY" 2>&1 | tee -a "$LOG"; then
                echo "  SRT caption uploaded"
            else
                echo "  Warning: SRT upload failed (continuing)"
            fi
        fi
    else
        echo "  Warning: SRT file not found: $SRT_FILENAME"
    fi

    SUCCESS_COUNT=$((SUCCESS_COUNT + 1))
    echo "  Completed: $FILENAME"
done

# ---- summary (ref :335-353)
echo ""
echo "=========================================="
echo "Pipeline Summary"
echo "=========================================="
echo "Total files processed: $FILE_COUNT"
echo "Successful: $SUCCESS_COUNT"
echo "Failed: $FAILED_COUNT"
if [ "$FAILED_COUNT" -gt 0 ] && [ ${#FAILED_FILES[@]} -gt 0 ]; then
    echo "Failed files:"
    printf '  - %s\n' "${FAILED_FILES[@]}"
fi
echo "=========================================="
echo "Pipeline completed!"
[ "$FAILED_COUNT" -eq 0 ] || exit 2

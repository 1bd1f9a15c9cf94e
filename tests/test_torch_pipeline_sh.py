"""The port's shell pipelines (`vibevoice_tpu_torch/pipelines/`): every case
of `tests/test_pipeline_sh.py` on the port's copies (the dry path's stages,
the stock digest's per-ticker filtering, matching and accounting, the cron
schedule), and their inference stage run for real against a stand-in
`python` that records how it was called: the port's module, with the JAX
pipeline's arguments."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINES = os.path.join(REPO, "vibevoice_tpu_torch", "pipelines")
MODULE = "vibevoice_tpu_torch.demo.batch_inference_simple_captions"
ENV_PATH = "/usr/local/bin:/usr/bin:/bin"


def test_cron_command_dry_path():
    env = dict(os.environ, PATH=ENV_PATH)
    out = subprocess.run(["/bin/bash", os.path.join(PIPELINES, "test_cron_command.sh")],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "PIPELINE DRY PATH OK" in out.stdout
    for check in ("wav: ok", "srt: ok", "dated log: ok",
                  "audio upload stage: ok", "srt upload stage: ok"):
        assert check in out.stdout


def _digests(tmp_path):
    digests = tmp_path / "stock_digests"
    digests.mkdir()
    uu = "5711e948-e79d-414a-9ee3-b260953b2a17"
    (digests / f"AAPL_11_28_25_{uu}.txt").write_text("Speaker 1: apple news.")
    (digests / f"MSFT_11_28_25_{uu.replace('5711', 'abcd')}.txt").write_text(
        "Speaker 1: microsoft news.")
    (digests / f"GOOG_11_27_25_{uu.replace('5711', '1234')}.txt").write_text(
        "Speaker 1: google news.")
    (digests / "TSLA_11_28_25_deadbeef.txt").write_text("Speaker 1: tesla news.")
    return digests, uu


def _uploader(tmp_path):
    uploads = tmp_path / "uploads.log"
    up_cmd = tmp_path / "upload.sh"
    up_cmd.write_text("#!/bin/bash\necho \"UPLOAD $1 id=$2 key=$3\" >> %s\n" % uploads)
    up_cmd.chmod(0o755)
    return uploads, up_cmd


def test_stock_digest_pipeline_per_ticker(tmp_path):
    """Ticker filtering, MM_DD_YY date matching, UUID extraction, output
    matching and upload accounting, through the dry-run stub."""
    digests, uu = _digests(tmp_path)
    outdir = tmp_path / "out"
    uploads, up_cmd = _uploader(tmp_path)
    env = dict(os.environ, PATH=ENV_PATH, PIPELINE_DRY_RUN="1", DIGESTS_DIR=str(digests),
               OUTPUT_DIR=str(outdir), LOG_DIR=str(tmp_path / "logs"),
               UPLOAD_AUDIO_CMD=str(up_cmd), UPLOAD_SRT_CMD=str(up_cmd))
    script = os.path.join(PIPELINES, "run_stock_digest_pipeline.sh")

    out = subprocess.run(["/bin/bash", script, "2025-11-28", "key", ""],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Found 3 stock digest file(s)" in out.stdout
    assert "GOOG" not in out.stdout
    assert f"Digest ID: {uu}" in out.stdout
    assert "only short digest id found: deadbeef" in out.stdout
    assert "Successful: 3" in out.stdout and "Failed: 0" in out.stdout
    ups = uploads.read_text()
    assert ups.count(f"id={uu}") == 2 and ups.count("id=deadbeef") == 2

    uploads.write_text("")
    out = subprocess.run(["/bin/bash", script, "2025-11-28", "key", "", "AAPL,MSFT"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Found 2 stock digest file(s)" in out.stdout
    assert "TSLA" not in out.stdout.split("Step 2.1")[0].split("Found 2")[1]
    assert "Successful: 2" in out.stdout

    out = subprocess.run(["/bin/bash", script, "2030-01-01", "key", ""],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 1
    assert "No stock digest files found for date 2030-01-01" in out.stdout


def test_setup_cron_entries_match_reference_schedule():
    src = open(os.path.join(PIPELINES, "setup_cron.sh")).read()
    for entry in ("35 12 * * 1-5", "35 21 * * 1-5", "35 21 * * 6", "35 21 * * 0",
                  "0 13 * * *"):
        assert entry in src
    for log in ("morning_", "evening_", "weekly_saturday_", "weekly_sunday_",
                "stock_digest_"):
        assert log in src
    # the entries run the port's pipelines
    assert '"$REPO_DIR/vibevoice_tpu_torch/pipelines/run_podcast_pipeline.sh"' in src
    assert '"$REPO_DIR/vibevoice_tpu_torch/pipelines/run_stock_digest_pipeline.sh"' in src


# a stand-in for `python`: records its arguments, PYTHONPATH and whether the
# module it is asked to run resolves there, then writes a wav and an srt per
# input script and prints the CLI's `Saved audio to:` lines
RECORDER = r'''
import glob, importlib.util, json, os, struct, sys
argv = sys.argv[1:]
# `python -m` looks in the working directory first, then PYTHONPATH
sys.path[:0] = [os.getcwd()] + [p for p in os.environ.get("PYTHONPATH", "").split(":") if p]
mod = argv[1] if argv[:1] == ["-m"] else None
rec = dict(argv=argv, pythonpath=os.environ.get("PYTHONPATH", ""), cwd=os.getcwd(),
           found=bool(mod) and importlib.util.find_spec(mod) is not None)
with open(os.environ["RECORD"], "a") as f:
    f.write(json.dumps(rec) + "\n")
def val(flag):
    return argv[argv.index(flag) + 1] if flag in argv else None
if "--txt_files" in argv:
    i = argv.index("--txt_files") + 1
    files = []
    while i < len(argv) and not argv[i].startswith("--"):
        files.append(argv[i]); i += 1
else:
    files = sorted(glob.glob(os.path.join(val("--input_dir"), "*.txt")))
out = val("--output_dir")
for f in files:
    base = os.path.splitext(os.path.basename(f))[0]
    data = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 38, b"WAVE", b"fmt ", 16, 1, 1, 24000,
                       48000, 2, 16, b"data", 2) + b"\x00\x00"
    open(os.path.join(out, base + ".wav"), "wb").write(data)
    open(os.path.join(out, base + ".srt"), "w").write("1\n00:00:00,000 --> 00:00:01,000\nx\n")
for f in files:
    print("Saved audio to: " + os.path.join(out, os.path.splitext(os.path.basename(f))[0] + ".wav"))
'''


@pytest.mark.parametrize("pipeline", ["podcast", "stock_digest"])
def test_inference_stage_runs_the_port_module(tmp_path, pipeline):
    """Not dry: the inference stage runs `python -m` the port's batch CLI,
    which resolves from any working directory, with the JAX pipeline's
    arguments; its outputs go through the upload stages."""
    shim = tmp_path / "bin"
    shim.mkdir()
    (tmp_path / "recorder.py").write_text(RECORDER)
    (shim / "python").write_text(f"#!/bin/sh\nexec {sys.executable} {tmp_path}/recorder.py "
                                 "\"$@\"\n")
    (shim / "python").chmod(0o755)
    record = tmp_path / "record.jsonl"
    uploads, up_cmd = _uploader(tmp_path)
    outdir = tmp_path / "out"
    env = dict(os.environ, PATH=f"{shim}:{ENV_PATH}", RECORD=str(record),
               OUTPUT_DIR=str(outdir), LOG_DIR=str(tmp_path / "logs"),
               UPLOAD_AUDIO_CMD=str(up_cmd), UPLOAD_SRT_CMD=str(up_cmd), BATCH_SIZE="2")
    env.pop("PYTHONPATH", None)
    env.pop("PIPELINE_DRY_RUN", None)
    if pipeline == "podcast":
        scripts = tmp_path / "scripts"
        scripts.mkdir()
        for name in ("ep_a", "ep_b"):
            (scripts / f"{name}.txt").write_text("Speaker 1: hello.\nSpeaker 2: hi.")
        env["SCRIPTS_DIR"] = str(scripts)
        cmd = [os.path.join(PIPELINES, "run_podcast_pipeline.sh"), "2025-11-28", "morning",
               "key", "/models/vv"]
        want = ["-m", MODULE, "--model_path", "/models/vv", "--input_dir", str(scripts),
                "--output_dir", str(outdir), "--batch_size", "2"]
        n_files = 2
    else:
        digests, _ = _digests(tmp_path)
        env["DIGESTS_DIR"] = str(digests)
        cmd = [os.path.join(PIPELINES, "run_stock_digest_pipeline.sh"), "2025-11-28", "key",
               "/models/vv"]
        files = sorted(str(p) for p in digests.glob("*_11_28_25_*.txt"))
        want = ["-m", MODULE, "--model_path", "/models/vv", "--txt_files", *files,
                "--output_dir", str(outdir), "--batch_size", "2", "--generate_captions",
                "--caption_formats", "srt"]
        n_files = 3
    outdir.mkdir()
    out = subprocess.run(["/bin/bash", *cmd], capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    (rec,) = [json.loads(l) for l in record.read_text().splitlines()]
    assert rec["argv"] == want
    # the podcast pipeline runs where it is called from and names the repo
    # in PYTHONPATH; the stock digest pipeline runs from the repo's root
    assert rec["found"]
    if pipeline == "podcast":
        assert rec["cwd"] == str(tmp_path) and rec["pythonpath"].split(":")[0] == REPO
    else:
        assert rec["cwd"] == REPO
    assert len(list(outdir.glob("*.wav"))) == len(list(outdir.glob("*.srt"))) == n_files
    ups = uploads.read_text().splitlines()
    assert sum(".wav" in u or ".mp3" in u for u in ups) == n_files
    assert sum(".srt" in u for u in ups) == n_files

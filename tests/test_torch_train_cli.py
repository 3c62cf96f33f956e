"""``python -m repro_torch.launch.train`` on the CPU (``--device cpu``), as
``tests/test_launchers.py`` drives the reference's launcher: gin-tu with an
injected failure restarts once from its checkpoint and ends with finite
losses; DIEN resumes from the checkpoint a first run left.  Without a card
the default device (``cuda``) raises."""
import json
import os
import subprocess
import sys

import numpy as np


def _run(args, timeout=420):
    return subprocess.run([sys.executable, "-m", *args],
                          capture_output=True, text=True, timeout=timeout,
                          env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                               "HOME": os.path.expanduser("~")})


def test_train_cli_with_injected_failure(tmp_path):
    r = _run(["repro_torch.launch.train", "--arch", "gin-tu", "--steps",
              "12", "--ckpt-dir", str(tmp_path / "ckpt"),
              "--ckpt-interval", "5", "--inject-failure-at", "7",
              "--metrics-out", str(tmp_path / "m.json"), "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "restarts=1" in r.stdout
    losses = [m["loss"] for m in json.load(open(tmp_path / "m.json"))]
    assert len(losses) >= 12 and all(np.isfinite(losses))


def test_train_cli_resumes_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    common = ["--ckpt-dir", ckpt, "--ckpt-interval", "3", "--device", "cpu"]
    r1 = _run(["repro_torch.launch.train", "--arch", "dien", "--steps", "6",
               *common])
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _run(["repro_torch.launch.train", "--arch", "dien", "--steps",
               "10", "--trace", str(tmp_path / "t.json"), *common])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resuming from checkpoint step 6" in r2.stdout
    assert "steps=4" in r2.stdout
    spans = [e for e in json.load(open(tmp_path / "t.json"))["traceEvents"]
             if e.get("name") == "train_step"]
    assert len(spans) == 4


def test_train_cli_defaults_to_the_card(tmp_path):
    r = _run(["repro_torch.launch.train", "--arch", "dien", "--steps", "1",
              "--ckpt-dir", str(tmp_path / "ckpt")])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr

"""The port's multi-device entry points on the CPU: ``python -m
yume_tpu_torch.sample --smoke --device cpu`` with ``--sp 2`` and with
``--pp 2`` (one command; two ranks spawned over gloo), the webapp with
``--sp 2`` serving a request, and the refusals of the combinations the
reference, or the port, refuses.

Each parallel run is held to the one-rank run of the same seed through
``--save_latents``: ``--pp`` bit for bit (the same blocks in the same
order), ``--sp`` (Ulysses) within 1e-5 (the attention of each head runs
over the whole sequence as in one rank, the other products on each rank's
rows). Only rank 0 writes the files and says what it wrote; the parent
prints each rank's line.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from torch_parity import torch_threads
from yume_tpu_torch import sample
from yume_tpu_torch.serving import webapp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--smoke", "--device", "cpu", "--t2v", "--sample_num", "2", "--save_latents"]
FILES = ["segment_000.mp4", "segment_000.pt", "segment_001.mp4", "segment_001.pt"]
SP_TOL = 1e-5


def _cli(argv):
    """``python -m yume_tpu_torch.sample`` in a process of its own (with one
    torch thread a rank): its stdout."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", "yume_tpu_torch.sample"] + argv, cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The one-rank run, here, with one torch thread as each rank has."""
    out = tmp_path_factory.mktemp("one_rank")
    with torch_threads(1):
        sample.main(BASE + ["--output_dir", str(out)])
    return out


def _outputs(path):
    return [torch.load(path / name) for name in ("segment_000.pt", "segment_001.pt")]


@pytest.mark.parametrize("flags", [["--sp", "2"], ["--pp", "2"]], ids=["sp2", "pp2"])
def test_parallel_cli_matches_one_rank(one_rank, tmp_path, flags):
    stdout = _cli(BASE + flags + ["--output_dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == FILES
    assert stdout.count("--> segment 0 written") == 1       # rank 0 alone says it
    assert "launch: 2 ranks over gloo, 0 card(s)" in stdout
    ranks = [json.loads(m) for m in re.findall(r"^rank \d of 2: (.*)$", stdout, re.M)]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in ranks)
    if flags[0] == "--pp":
        # each rank holds one of the smoke model's two blocks
        assert ranks[0]["dit_bytes"] == ranks[1]["dit_bytes"]
    for got, want in zip(_outputs(tmp_path), _outputs(one_rank)):
        if flags[0] == "--pp":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=SP_TOL, rtol=0)


def test_parallel_14b_cli_pp_matches_one_rank(tmp_path):
    """``--config i2v-14B --pp 2`` in image mode with a ``generate_next``
    continuation: both segments' latents bit-equal to one rank's."""
    import numpy as np
    from PIL import Image

    os.makedirs(tmp_path / "jpg")
    Image.fromarray((np.random.default_rng(65).random((48, 40, 3)) * 255).astype(np.uint8)) \
        .save(str(tmp_path / "jpg" / "frame.png"))
    argv = ["--config", "i2v-14B", "--smoke", "--device", "cpu", "--jpg_dir",
            str(tmp_path / "jpg"), "--sample_num", "2", "--save_latents"]
    with torch_threads(1):
        sample.main(argv + ["--output_dir", str(tmp_path / "one")])
    stdout = _cli(argv + ["--pp", "2", "--output_dir", str(tmp_path / "pp")])
    assert "launch: 2 ranks over gloo, 0 card(s)" in stdout
    assert sorted(os.listdir(tmp_path / "pp")) == FILES
    for got, want in zip(_outputs(tmp_path / "pp"), _outputs(tmp_path / "one")):
        assert torch.equal(got, want)


def test_parallel_webapp_serves_a_request(tmp_path):
    """``--sp 2``: a t2v request of 2 segments, then continue_from_last; rank
    0 writes the videos, and SIGINT stops the server and both ranks."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "yume_tpu_torch.serving.webapp", "--smoke", "--device", "cpu",
         "--port", "0", "--sp", "2", "--output_dir", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stdout:
            m = re.search(r"webapp on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, proc.stderr.read()[-3000:]

        def call(path, obj=None):
            data = None if obj is None else json.dumps(obj).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
            return json.loads(urllib.request.urlopen(req, timeout=30).read())

        for req, n_out in (({"mode": "t2v", "steps": 2, "segments": 2, "seed": 5}, 2),
                           ({"mode": "continue_from_last", "steps": 2, "keys": "D"}, 3)):
            assert call("/api/generate_long", req)["status"] == "started"
            deadline = time.time() + 120
            while (st := call("/api/status"))["status"] == "generating":
                assert time.time() < deadline
                time.sleep(0.2)
            assert st["status"] == "done", st
            assert len(st["outputs"]) == n_out and all(os.path.exists(p) for p in st["outputs"])
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    assert sorted(os.listdir(tmp_path)) == ["web_0000.mp4", "web_0001.mp4", "web_0002.mp4",
                                            "webapp.log"]


def test_parallel_webapp_request_fails_on_every_rank(tmp_path):
    """``--sp 2``: rank 0's decode raises within a request. Both ranks leave
    the request with its error (none waits in a collective the other never
    joins), and the next request is served."""
    import threading

    from torch_parity import rank_webapp_decode_failure
    from yume_tpu_torch.parallel.mesh import launch

    args = webapp.build_argparser().parse_args(
        ["--smoke", "--device", "cpu", "--sp", "2", "--output_dir", str(tmp_path)])
    box = {}

    def run():
        try:
            box["out"] = launch(2, rank_webapp_decode_failure, args, device="cpu")
        except Exception as e:  # noqa: reported below
            box["error"] = e
    runner = threading.Thread(target=run, daemon=True)
    runner.start()
    runner.join(timeout=150)
    assert not runner.is_alive(), "the ranks hang after a failed decode on rank 0"
    assert "error" not in box, box.get("error")
    (first0, second0), (first1, second1) = box["out"]
    assert first0[0] == first1[0] == "error"
    assert "rank 0: RuntimeError: decode failed on rank 0" in first0[1]
    assert "rank 1: RuntimeError: rank 0 failed: RuntimeError: decode failed" in first0[1]
    assert second0[0] == "done" and second1[0] != "error"
    assert sorted(os.listdir(tmp_path)) == ["web_0000.mp4", "webapp.log"]


# argv and what the refusal must say: the reference's refusals (SP with the
# storage trunk or the 5B's TTS samplers, PP with samplers other than Euler)
# and the port's (PP with the storage trunk, SP with PP, USP over an odd count)
REFUSED = {
    "sp_int8": (["--sp", "2", "--int8"], "storage trunk is single-chip"),
    "sp_int4_14b": (["--config", "i2v-14B", "--jpg_dir", "jpg", "--sp", "2", "--int4"],
                    "storage trunk is single-chip"),
    "sp_sde": (["--sp", "2", "--sde"], "supports the euler and teacache samplers"),
    "sp_time_travel": (["--sp", "2", "--time_travel"], "supports the euler and teacache"),
    "pp_teacache": (["--pp", "2", "--teacache"], "pp trunk supports the euler sampler"),
    "pp_sde_14b": (["--config", "i2v-14B", "--jpg_dir", "jpg", "--pp", "2", "--sde"],
                   "pp trunk supports the euler sampler"),
    "pp_int8": (["--pp", "2", "--int8"], "int8/int4 trunk is not staged"),
    "sp_and_pp": (["--sp", "2", "--pp", "2"], "do not combine"),
    "usp_odd": (["--sp", "3", "--sp_kind", "usp"], "usp splits the ranks 2 x N/2"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_sample_refuses(case, tmp_path):
    argv, match = REFUSED[case]
    with pytest.raises(NotImplementedError, match=match):
        sample.main(["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)] + argv)
    assert not os.listdir(tmp_path)


def test_pp_stage_count_must_divide_the_layers(tmp_path):
    with pytest.raises(SystemExit, match="does not divide the DiT's 2 layers"):
        sample.main(["--smoke", "--device", "cpu", "--pp", "3", "--output_dir",
                     str(tmp_path)])


@pytest.mark.parametrize("argv,match", [
    (["--sp", "2", "--quant", "int8"], "storage trunk is single-chip"),
    (["--pp", "2", "--teacache"], "pp trunk supports the euler sampler"),
])
def test_webapp_refuses(tmp_path, argv, match):
    args = webapp.build_argparser().parse_args(
        ["--smoke", "--device", "cpu", "--output_dir", str(tmp_path)] + argv)
    with pytest.raises(NotImplementedError, match=match):
        webapp.WebApp(args)


def test_rank_stats_report_the_stage(tmp_path):
    """The per-rank line's fields, on a staged pipeline built here."""
    from yume_tpu_torch.parallel.mesh import Rank
    from yume_tpu_torch.parallel.pipeline import held_bytes, keep_stage_, PPGroups

    args = sample.build_argparser().parse_args(["--smoke", "--device", "cpu"])
    with torch_threads(2):
        _, pipe = sample.load_pipeline(args)
    whole = held_bytes(pipe.dit)
    keep_stage_(pipe.dit, PPGroups(group=None, stages=2, stage=1))
    st = sample.rank_stats(Rank(rank=1, world=2, device=torch.device("cpu"), backend="gloo"),
                           pipe)
    blocks = sum(held_bytes(b) for b in pipe.dit.blocks)
    assert st["rank"] == 1 and st["peak_gib"] is None and 0 < blocks < st["dit_bytes"] < whole
    assert set(st["launches"]) >= {"flash_attention", "flash_attention_partial", "q8_dot"}

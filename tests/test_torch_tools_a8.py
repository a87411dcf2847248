"""The port's A8 tools on the CPU (``--device cpu`` where a tool runs a
model), on experiments/synthetic_smoke.yaml and on data the tests write:
compare, resize_images, generate_videos, tsne_visualization,
record_video, perf_latency, perf_bn_levers and perf_multistep_sweep."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hrnet_hand_pose_estimation_tpu_torch.config import load_config
from hrnet_hand_pose_estimation_tpu_torch.tools import (compare, generate_videos, perf_bn_levers,
                                                        perf_latency, perf_multistep_sweep,
                                                        record_video, resize_images,
                                                        tsne_visualization)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "experiments" / "synthetic_smoke.yaml")


def run_main(monkeypatch, module, *argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


def test_compare_matches_the_jax_tool(tmp_path, capsys):
    """The AUC lines of two written PCK2d.txt curves, as the JAX package's
    tools/compare.py prints them, and the plot."""
    dirs = []
    for i, slope in enumerate((0.02, 0.035)):
        d = tmp_path / f"eval2D_results_{i}"
        d.mkdir()
        th = np.linspace(0, 50, 51)
        np.savetxt(d / "PCK2d.txt", np.stack([th, np.clip(th * slope, 0, 1)]))
        dirs.append(str(d))
    compare.main([*dirs, "--out", str(tmp_path / "port.png")])
    got = capsys.readouterr().out.splitlines()
    want = subprocess.run([sys.executable, str(ROOT / "tools" / "compare.py"), *dirs, "--out",
                           str(tmp_path / "jax.png")], capture_output=True, text=True,
                          check=True).stdout.splitlines()
    assert got[:2] == want[:2] and "AUC" in got[0]
    assert (tmp_path / "port.png").stat().st_size > 1000


def test_resize_images(tmp_path):
    import cv2

    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    rng = np.random.default_rng(0)
    for name, shape in (("a.png", (40, 60, 3)), ("b.jpg", (30, 30, 3))):
        cv2.imwrite(str(src / name), rng.integers(0, 256, size=shape, dtype=np.uint8))
    (src / "notes.txt").write_text("skipped")
    resize_images.main(["--src", str(src), "--dst", str(dst), "--size", "32"])
    assert sorted(p.name for p in dst.iterdir()) == ["a.png", "b.jpg"]
    assert cv2.imread(str(dst / "a.png")).shape == (32, 32, 3)


def test_generate_videos(tmp_path, monkeypatch):
    import cv2

    run_main(monkeypatch, generate_videos, "--cfg", SMOKE, "--device", "cpu", "--out_dir",
             str(tmp_path), "--frames_per_video", "5", "--max_videos", "2")
    for v in range(2):
        cap = cv2.VideoCapture(str(tmp_path / f"VIDEO_{v:06d}.avi"))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        assert n == 5


def test_tsne_visualization(tmp_path, monkeypatch):
    """The plot over 16 samples, and ``embed``: (B, 120) pooled float32
    features of the smoke model, the mean of its forward's features."""
    from hrnet_hand_pose_estimation_tpu_torch.models import build_model

    out = tmp_path / "tsne.png"
    run_main(monkeypatch, tsne_visualization, "--cfg", SMOKE, "--device", "cpu", "--out",
             str(out), "--max_samples", "16")
    assert out.stat().st_size > 1000
    cfg = load_config(SMOKE)
    model = build_model(cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64, 64, 3)).astype(np.float32))
    emb = tsne_visualization.embed(cfg, model, x)
    assert emb.shape == (3, 120) and emb.dtype == torch.float32 and not model.training
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        want = model(x).features.float().mean(dim=(1, 2))
    torch.testing.assert_close(emb, want)


def test_record_video_without_a_camera(tmp_path):
    with pytest.raises(SystemExit, match="cannot open camera 97"):
        record_video.main(["--camera", "97", "--seconds", "0.1",
                           "--out", str(tmp_path / "v.avi")])


def test_perf_latency(monkeypatch, capsys):
    run_main(monkeypatch, perf_latency, "--cfg", SMOKE, "--device", "cpu", "--batches", "1,4",
             "--iters", "3", "--warmup", "1")
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["batch"] for r in rows] == [1, 4]
    for r in rows:
        assert r["iters"] == 3 and r["device"] == "cpu"
        assert 0 < r["p50_ms"] <= r["p99_ms"] and r["fps_at_batch"] > 0


def test_perf_train_probes(monkeypatch, capsys):
    """perf_bn_levers' rows (each lever and the baseline, finite losses,
    the levers off afterwards) and perf_multistep_sweep's (K losses a call)."""
    from hrnet_hand_pose_estimation_tpu_torch.models.layers import bn_levers_active

    run_main(monkeypatch, perf_bn_levers, "--cfg", SMOKE, "--device", "cpu", "--batch", "8",
             "--steps", "1", "--warmup", "1")
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["levers"] for r in rows] == [c for _, c in perf_bn_levers.lever_configs(8)]
    assert all(r["ms_per_step"] > 0 and len(r["losses"]) == 2
               and np.isfinite(r["losses"]).all() for r in rows)
    assert not bn_levers_active()
    run_main(monkeypatch, perf_multistep_sweep, "--cfg", SMOKE, "--device", "cpu", "--batch",
             "2", "--ks", "1,2", "--steps", "2")
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["k"], r["calls"], len(r["losses"])) for r in rows] == [(1, 2, 3), (2, 1, 4)]
    # the same seeded state and first batch: the first step's loss agrees
    assert rows[0]["losses"][0] == rows[1]["losses"][0]

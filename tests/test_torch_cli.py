"""The port's two CLIs on the CPU at a tiny size.

* joint_tensorf_tpu_torch.train writes options.json, log.jsonl (rows with
  the pose errors every 4 x freq.scalar and val_psnr every freq.val),
  model_it{N}.ckpt.npz every freq.ckpt, model.ckpt.npz and quant.json;
  --resume=true continues from the stored iteration; --profiling=true
  writes a trace after 5 + 3 iterations and stops at iteration 8.
* joint_tensorf_tpu_torch.evaluate on that checkpoint writes
  quant_pose.txt, quant.txt and quant_eval.json (finite psnr and ssim,
  the clip stats, the lpips note); with the config's defaults also
  poses.png, the novel-view video, the pose video's frames from the
  snapshots and test_renders/rgb_{i}.png (as this environment's packages
  allow: imageio without its ffmpeg backend, matplotlib); with both
  video flags false neither video.
* Both go through utils/cli.run_cli with --pdb.
"""
import json
import math
import os

import pytest
from test_torch_eval import one_torch_thread  # noqa: F401

from joint_tensorf_tpu_torch import evaluate
from joint_tensorf_tpu_torch.train import __main__ as train_cli
from joint_tensorf_tpu_torch.utils import run_cli

TINY = ["--yaml=configs/bat_blender_VM.yaml", "--device=cpu",
        "--data.dataset=synthetic", "--data.image_size=[16,16]",
        "--data.n_views=4", "--data.val_sub=4",
        "--train_schedule.n_voxel_init=4096",
        "--train_schedule.n_voxel_final=32768",
        "--train_schedule.n_rays_init=64", "--c2f_kernel_size=8",
        "--blur_2d_c2f_kernel_size=15",
        "--train_schedule.upsample_iters=[3]",
        "--train_schedule.update_alphamask_iters=[5]",
        "--freq.scalar=2", "--freq.val=4", "--freq.ckpt=6",
        "--+tb_logging=false", "--name=cli"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("out"))
    train_cli.main(TINY + ["--max_iter=12", f"--output_root={root}"])
    return root, os.path.join(root, "default", "cli")


def _rows(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_writes_its_outputs(trained):
    _, out = trained
    for name in ("options.json", "log.jsonl", "model_it6.ckpt.npz",
                 "model.ckpt.npz", "quant.json", "summary.json"):
        assert os.path.exists(os.path.join(out, name)), name
    rows = _rows(out)
    assert [r["it"] for r in rows] == [0, 2, 4, 6, 8, 10]
    assert all(r["split"] == "train" for r in rows)
    assert [r["it"] for r in rows if "rot_deg" in r] == [0, 8]
    assert [r["it"] for r in rows if "val_psnr" in r] == [4, 8]
    assert all(math.isfinite(r["val_psnr"]) for r in rows if "val_psnr" in r)
    with open(os.path.join(out, "quant.json")) as f:
        quant = json.load(f)
    assert quant["iters"] == 12
    for k in ("wall_s", "val_psnr", "rot_deg", "trans"):
        assert math.isfinite(quant[k]), k
    with open(os.path.join(out, "options.json")) as f:
        assert json.load(f)["max_iter"] == 12


def test_evaluate_cli_writes_its_outputs(trained):
    root, out = trained
    results = evaluate.main(TINY + [
        f"--output_root={root}", "--optim.test_iter=2",
        "--generate_video=false", "--generate_pose_video=false"])
    with open(os.path.join(out, "quant_pose.txt")) as f:
        lines = [line.split() for line in f]
    assert [int(x[0]) for x in lines] == [0, 1, 2, 3]
    assert all(math.isfinite(float(v)) for x in lines for v in x[1:])
    with open(os.path.join(out, "quant.txt")) as f:
        per_view = [json.loads(line) for line in f]
    assert [r["view"] for r in per_view] == [0, 1, 2, 3]
    with open(os.path.join(out, "quant_eval.json")) as f:
        quant = json.load(f)
    assert quant == json.loads(json.dumps(results))
    assert quant["iters"] == 12
    for k in ("psnr", "ssim", "rot_deg", "trans"):
        assert math.isfinite(quant[k]), k
    assert set(quant["clip_stats"]) == {
        "compact_k", "app_k", "max_alive", "max_gate", "compact_clip_rate",
        "app_k_clip_rate"}
    assert "lpips" in quant["lpips_note"].lower()


def test_train_cli_resumes_from_its_checkpoint(trained, capsys):
    root, out = trained
    n_rows = len(_rows(out))
    train_cli.main(TINY + ["--max_iter=16", f"--output_root={root}",
                           "--resume=true"])
    printed = capsys.readouterr().out
    assert "[resume] restored it=12" in printed
    assert "[options]   ~ max_iter: 12 -> 16" in printed
    assert [r["it"] for r in _rows(out)[n_rows:]] == [12, 14]
    with open(os.path.join(out, "quant.json")) as f:
        assert json.load(f)["iters"] == 16


def test_evaluate_cli_writes_the_visual_outputs(trained, capsys):
    """The config's defaults: generate_video and generate_pose_video on,
    60 frames; imageio here has no ffmpeg backend, so both videos are
    written as frame directories (write_video's PNG outcome)."""
    root, out = trained
    run_cli(evaluate.main, TINY + [f"--output_root={root}",
                                   "--optim.test_iter=2", "--pdb"])
    printed = capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "poses.png"))
    frames = os.path.join(out, "novel_views_frames")
    assert f"[video] wrote {frames}" in printed
    assert sorted(os.listdir(frames)) == [f"{i:04d}.png" for i in range(60)]
    snaps = sorted(int(n[len("model_it"):-len(".ckpt.npz")])
                   for n in os.listdir(out) if n.startswith("model_it"))
    assert snaps and sorted(os.listdir(os.path.join(out, "poses"))) == \
        sorted(f"{it}.png" for it in snaps)
    assert f"[video] wrote {os.path.join(out, 'poses_frames')}" in printed
    assert sorted(os.listdir(os.path.join(out, "test_renders"))) == [
        f"rgb_{i}.png" for i in range(4)]


def test_evaluate_cli_without_videos(trained, tmp_path, capsys):
    root, out = trained
    evaluate.main(TINY + [f"--output_root={tmp_path}",
                          f"--ckpt={os.path.join(out, 'model.ckpt.npz')}",
                          "--optim.test_iter=2", "--generate_video=false",
                          "--generate_pose_video=false"])
    assert "[video]" not in capsys.readouterr().out
    written = os.listdir(os.path.join(tmp_path, "default", "cli"))
    assert not [n for n in written if "novel_views" in n or
                n.startswith("poses") and n != "poses.png"]
    assert {"poses.png", "test_renders", "quant_eval.json"} <= set(written)


def test_train_cli_profiling_writes_a_trace(tmp_path, capsys):
    result = run_cli(train_cli.main, TINY + [f"--output_root={tmp_path}",
                                             "--profiling=true", "--pdb"])
    assert result["iters"] == 8
    with open(result["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert f"[profiling] trace written to {result['trace']} at it 8" in \
        capsys.readouterr().out
    out = os.path.join(tmp_path, "default", "cli")
    assert os.path.dirname(result["trace"]) == os.path.join(out,
                                                            "torch_trace")
    assert sorted(os.listdir(out)) == ["options.json", "torch_trace"]

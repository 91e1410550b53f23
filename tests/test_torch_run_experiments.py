"""The port's experiment scheduler (joint_tensorf_tpu_torch/run_experiments.py)
against the repository's scripts/run_experiments.py: the three scheduler
tests of tests/test_scheduler.py on the port's copy, and the one
adaptation, each slot's process on its own card.

* the commands dispatch the port's CLIs (python -m
  joint_tensorf_tpu_torch.train / .evaluate) with the JAX script's
  arguments, in its order;
* the slot limit holds and every command runs (a stub command);
* failures are reported with their return codes;
* slot s gets CUDA_VISIBLE_DEVICES = s mod the card count (the stubs
  write what they see); without a card the environment is unchanged;
* main's CLI takes the JAX script's flags and exits 1 on a failure.
"""
import os
import sys

import pytest

from joint_tensorf_tpu_torch import run_experiments as sched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import run_experiments as jsched  # noqa: E402


class _Args:
    yaml = "configs/x.yaml"
    scenes = ["lego", "chair"]
    mode = "both"
    prefix = "p_"
    group = "g"


def test_build_commands_train_and_eval():
    cmds = sched.build_commands(_Args(), ["--seed=3"])
    assert len(cmds) == 4                      # 2 scenes x (train + eval)
    assert cmds[0][1:3] == ["-m", "joint_tensorf_tpu_torch.train"]
    assert cmds[1][1:3] == ["-m", "joint_tensorf_tpu_torch.evaluate"]
    assert "--data.scene=lego" in cmds[0]
    assert "--name=p_lego" in cmds[0]
    assert "--seed=3" in cmds[0]
    # the JAX script's arguments, in its order, after the module
    want = jsched.build_commands(_Args(), ["--seed=3"])
    assert [c[3:] for c in cmds] == [c[2:] for c in want]
    for mode, n in (("train", 2), ("eval", 2)):
        args = _Args()
        args.mode = mode
        assert len(sched.build_commands(args, [])) == n


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(sched, "card_count", lambda: 0)


def test_scheduler_respects_slot_limit_and_runs_all(tmp_path, no_card):
    marker = tmp_path / "out"
    # each stub records how many stubs run beside it
    live = tmp_path / "live"
    live.mkdir()
    cmds = [[sys.executable, "-c",
             "import os, pathlib, time; "
             f"p = pathlib.Path(r'{live}') / '{i}'; p.write_text('x'); "
             "time.sleep(0.3); "
             f"pathlib.Path(r'{marker}_{i}').write_text("
             f"str(len(os.listdir(r'{live}')))); p.unlink()"]
            for i in range(5)]
    results = sched.run_scheduler(cmds, n_slots=2, poll_s=0.05)
    assert len(results) == 5
    assert all(rc == 0 for _, rc in results)
    for i in range(5):
        assert 1 <= int((tmp_path / f"out_{i}").read_text()) <= 2


def test_scheduler_reports_failures(tmp_path, no_card):
    cmds = [[sys.executable, "-c", "import sys; sys.exit(7)"],
            [sys.executable, "-c", "pass"]]
    results = sched.run_scheduler(cmds, n_slots=1, poll_s=0.05)
    rcs = sorted(rc for _, rc in results)
    assert rcs == [0, 7]


@pytest.mark.parametrize("n_cards", [1, 2, 3])
def test_slot_gets_its_card(tmp_path, monkeypatch, n_cards):
    monkeypatch.setattr(sched, "card_count", lambda: n_cards)
    cmds = [[sys.executable, "-c",
             "import os, pathlib, time; time.sleep(0.2); "
             f"pathlib.Path(r'{tmp_path}/{i}').write_text("
             "os.environ.get('CUDA_VISIBLE_DEVICES', 'unset'))"]
            for i in range(3)]
    sched.run_scheduler(cmds, n_slots=3, poll_s=0.05)
    # three slots start at once, in order: command i runs in slot i
    assert [(tmp_path / str(i)).read_text() for i in range(3)] == [
        str(i % n_cards) for i in range(3)]
    assert sched.slot_env(5, n_cards)["CUDA_VISIBLE_DEVICES"] \
        == str(5 % n_cards)


def test_no_card_leaves_the_environment(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    assert sched.slot_env(1, 0) == dict(os.environ)


def test_main_cli(monkeypatch, capsys):
    ran = []

    def fake(cmds, n_slots, poll_s=3.0):
        ran.append((cmds, n_slots, poll_s))
        return [(cmds[0], 0), (cmds[1], 3)]

    monkeypatch.setattr(sched, "run_scheduler", fake)
    with pytest.raises(SystemExit) as exc:
        sched.main(["--yaml=configs/x.yaml", "--scenes", "lego",
                    "--mode=both", "--slots=2", "--group=g", "--prefix=p_",
                    "--", "--seed=3"])
    assert exc.value.code == 1
    cmds, n_slots, poll_s = ran[0]
    assert n_slots == 2 and poll_s == 3.0
    assert cmds[0][-1] == "--seed=3" and "--name=p_lego" in cmds[0]
    assert "1 ok, 1 failed" in capsys.readouterr().out

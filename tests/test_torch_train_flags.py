"""The port's ``sr train`` flags that follow the JAX CLI, on the CPU.

- ``--no-vgg``: the run trains without the perceptual term and never
  builds VGG19;
- ``--fused on|off``: the generator's fused path is taken or not (default:
  on only for the card with ``--bf16``, so off here); on the CPU the fused
  step runs the kernels' plain versions;
- without ``--target``, the numbered menu takes several targets,
  comma-separated, or ``all`` (JAX ``cli/main.py:142-145``).
"""

import numpy as np
import pytest
import torch

import superresolution_def_tpu_torch.cli.trainers as trainers
from superresolution_def_tpu_torch.cli.main import main
from test_torch_trainers import _split

torch.set_num_threads(1)

TINY = ["--img-size", "16", "--embed-dim", "16", "--depths", "2", "--num-heads", "2",
        "--batch-size", "2", "--epochs", "1", "--max-steps-per-epoch", "1", "--device", "cpu"]


@pytest.fixture
def data(tmp_path):
    rng = np.random.default_rng(0)
    for name, count in (("train", 2), ("val", 1)):
        _split(tmp_path / "data", name, count, rng)
    return tmp_path / "data"


def _train(tmp_path, data, *flags):
    return main(["train", "--arch", "swin", "--target", "T1", "--data-root", str(data),
                 "--outputs-root", str(tmp_path / "out"), *TINY, *flags])


def test_no_vgg_trains_without_building_vgg(tmp_path, data, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("VGG19 built under --no-vgg")

    monkeypatch.setattr(trainers, "VGG19Features", refuse)
    last = _train(tmp_path, data, "--no-vgg")
    assert np.isfinite(last["loss_g"]) and np.isfinite(last["loss_d"])


@pytest.mark.parametrize("flag, fused", [(None, False), ("on", True), ("off", False)])
def test_fused_flag_picks_the_generator_path(tmp_path, data, monkeypatch, flag, fused):
    seen = []
    create = trainers.create_swin_train_state

    def recording(*a, **kw):
        seen.append(kw["fused"])
        return create(*a, **kw)

    monkeypatch.setattr(trainers, "create_swin_train_state", recording)
    last = _train(tmp_path, data, *([] if flag is None else ["--fused", flag]))
    assert seen == [fused]
    assert np.isfinite(last["loss_g"])


@pytest.mark.parametrize("answer, targets", [("2", ("T2",)), ("1,2", ("T1", "T2")),
                                             ("all", ("T1", "T2"))])
def test_target_menu_takes_several_targets(tmp_path, monkeypatch, answer, targets):
    for t in ("T1", "T2"):  # the menu offers the targets with a train split
        splits = tmp_path / "data" / t / "8_dataset_split" / "splits_json"
        splits.mkdir(parents=True)
        (splits / "train.json").write_text("[]")
    seen = []
    monkeypatch.setattr(trainers, "train_swin_run", lambda cfg, resume: seen.append(cfg))
    monkeypatch.setattr("builtins.input", lambda prompt: answer)
    main(["train", "--data-root", str(tmp_path / "data"), "--device", "cpu"])
    assert seen[0].targets == targets

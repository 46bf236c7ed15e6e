"""Config.profile_dir of the port's train() on the CPU: steps 2-5 traced
(a Chrome trace, a 'train step N' span a step), a short epoch's trace
closed when the epoch ends, no trace without it (split from
test_torch_surface.py so that its train() runs spread over the test
workers)."""

import json
import os

import pytest

from test_torch_data import make_dataset
from yolosharp_tpu_torch import Config, ScalarType, YoloSize, YoloTask

NC = 3


# ----------------------------------------------------------- profile_dir
@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two detect sets of 32x32 PNGs: 12 train images (6 steps at batch 2)
    and 6 (3 steps), 2 val images each."""
    out = {}
    for n in (12, 6):
        root = str(tmp_path_factory.mktemp(f"train{n}"))
        make_dataset(root, n, 2, [(32, 32)], NC, seed=n)
        out[n] = root
    return out


def _config(root, out, **kw):
    return Config(root_path=root, train_data_path="images/train",
                  val_data_path="images/val", output_path=out,
                  image_size=32, batch_size=2, epochs=1, workers=1,
                  yolo_size=YoloSize.n, number_class=NC,
                  scalar_type=ScalarType.float32, **kw)


@pytest.mark.parametrize("n,steps", [(12, (2, 3, 4, 5)), (6, (2, 3))],
                         ids=["six_steps", "short_epoch"])
def test_profile_dir_traces_steps_2_to_5(roots, tmp_path, n, steps):
    """A Chrome trace of steps 2-5 (a 3-step epoch: steps 2-3, the trace
    closed when the epoch ends), each step a 'train step N' span."""
    prof = str(tmp_path / "prof")
    task = YoloTask(_config(roots[n], str(tmp_path / "out"),
                            profile_dir=prof), device="cpu")
    task.train()
    path = task.task.trace_path
    assert len(task.task.epoch_stats[0]["step_s"]) == n // 2
    assert os.path.dirname(path) == prof and os.listdir(prof) == [
        os.path.basename(path)]
    assert path.endswith(f"_steps_{steps[0]}-{steps[-1]}.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(int(e["name"].split()[-1]) for e in events
                   if e.get("name", "").startswith("train step "))
    assert tuple(spans) == steps


def test_no_trace_without_profile_dir(roots, tmp_path):
    task = YoloTask(_config(roots[6], str(tmp_path / "out")), device="cpu")
    task.train()
    assert task.task.trace_path is None
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs
                if f.endswith(".json")]

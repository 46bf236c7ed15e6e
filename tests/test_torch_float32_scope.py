"""The port's float32 stays float32 whatever the caller's TF32 flags: every
entry point that runs a network turns cuDNN's TF32 off for the length of
its own work (utils.numerics.full_float32) and gives the caller's flags
back, also when it raises. Read on the CPU through a forward hook on a
ConvBN: the flags are process-wide, so what the hook reads is what a card
would run under."""

import threading

import numpy as np
import pytest
import torch

from test_torch_data import make_dataset
from test_torch_train import _one_thread  # noqa: F401  (autouse)
from yolosharp_tpu_torch import Config, ScalarType, YoloSize, YoloTask
from yolosharp_tpu_torch.nn import ConvBN
from yolosharp_tpu_torch.utils.numerics import full_float32

NC = 3


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def caller_tf32():
    """The caller's flags at their most permissive: TF32 on for both."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield _flags()
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[2])


def _hook_reads(net, seen, fail=False):
    """A forward hook on the first ConvBN of `net` that records the flags
    each call runs under (and raises, with fail)."""
    conv = next(m for m in net.modules() if isinstance(m, ConvBN))

    def hook(module, inp, out):
        seen.append(_flags())
        if fail:
            raise RuntimeError("hook")

    return conv.register_forward_hook(hook)


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
            for _ in range(n)]


def test_pytorch_matmul_default_is_full_float32():
    """PyTorch's own default of the float32 matmul: no TF32 (the port relies
    on it outside its scopes; cuDNN's default is TF32, which it does not)."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_float32_scope_nests_across_threads_and_restores(caller_tf32):
    """The scope counts: a thread leaving while another is inside keeps the
    flags off; the last to leave gives the caller's back, also on a raise."""
    inside, release = threading.Event(), threading.Event()

    def other():
        with full_float32():
            inside.set()
            release.wait(10)

    t = threading.Thread(target=other)
    t.start()
    inside.wait(10)
    with pytest.raises(KeyError):
        with full_float32():
            assert _flags()[:2] == (False, False)
            raise KeyError("inside")
    assert _flags()[:2] == (False, False)    # the thread is still inside
    release.set()
    t.join()
    assert _flags() == caller_tf32


@pytest.mark.parametrize("entry", ["batch_predict", "calibrate_int8",
                                   "train"])
def test_entry_points_run_without_tf32(entry, caller_tf32, tmp_path):
    """Inside a float32 CPU batch_predict, calibrate_int8 and one train()
    step, every ConvBN forward sees cuDNN's TF32 and the matmul's off; the
    caller's TF32 is back after the call and after a call that raises."""
    cfg = dict(yolo_size=YoloSize.n, number_class=NC, image_size=64,
               scalar_type=ScalarType.float32)
    if entry == "train":
        root = str(tmp_path / "data")
        make_dataset(root, 2, 2, [(64, 48), (48, 64)], NC, seed=1)
        cfg.update(root_path=root, train_data_path="images/train",
                   val_data_path="images/val", batch_size=2, epochs=1,
                   workers=1, output_path=str(tmp_path / "out"))
    task = YoloTask(Config(**cfg), device="cpu")
    calls = {"batch_predict": lambda: task.batch_predict(_images(2)),
             "calibrate_int8": lambda: task.calibrate_int8(
                 images=_images(2), n_images=2),
             "train": task.train}
    # the net the entry runs: predict's folded copy, else the master
    # (calibration runs a copy of it, hooks and all)
    net = (task.task._predict_variables() if entry == "batch_predict"
           else task.task._ensure_variables())
    seen = []
    handle = _hook_reads(net, seen)
    calls[entry]()
    handle.remove()
    assert seen and all(f[:2] == (False, False) for f in seen), seen
    assert _flags() == caller_tf32

    handle = _hook_reads(net, seen, fail=True)
    with pytest.raises(RuntimeError, match="hook"):
        calls[entry]()
    handle.remove()
    assert _flags() == caller_tf32


@pytest.mark.parametrize("entry", ["batch_predict", "predict_stream"])
def test_segment_masks_are_built_without_tf32(entry, caller_tf32,
                                              monkeypatch):
    """A segment result's masks (process_mask: a float32 matmul of the
    proto on the device) are built inside the float32 scope, in
    batch_predict and in predict_stream's unpacking, though the forward's
    own scope has closed by then; the caller's flags are back after."""
    from yolosharp_tpu_torch import TaskType, tasks

    task = YoloTask(Config(task_type=TaskType.segment, yolo_size=YoloSize.n,
                           number_class=NC, image_size=64,
                           scalar_type=ScalarType.float32), device="cpu")
    seen = []
    process_mask = tasks.process_mask

    def recorded(*args, **kwargs):
        seen.append(_flags())
        return process_mask(*args, **kwargs)

    monkeypatch.setattr(tasks, "process_mask", recorded)
    images = _images(2, seed=1)
    if entry == "batch_predict":
        results = task.batch_predict(images, predict_threshold=0.001)
    else:
        results = list(task.predict_stream(iter(images), batch_size=2,
                                           predict_threshold=0.001,
                                           workers=1))
    assert len(results) == 2 and any(r.mask is not None
                                     for rs in results for r in rs)
    assert seen and all(f[:2] == (False, False) for f in seen), seen
    assert _flags() == caller_tf32

"""The port's training slice against the JAX package, float32 on the CPU:
the LR schedules and parameter groups, train-mode BatchNorm (a ConvBN and
the whole v8n: outputs and updated running statistics), one v8n train
step against make_train_step (loss items, parameter changes, BN
statistics), the non-finite skip and the loss-scale rules, the predict
copy's refold after training, and a tiny train() with its outputs, its
resume and its val metrics against the JAX val on the same weights."""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import make_dataset
from test_torch_model import jitter_bn
from yolosharp_tpu import train as jax_train
from yolosharp_tpu.ckpt import state_dict_to_variables
from yolosharp_tpu.ckpt.fuse import bias_init as jax_bias_init
from yolosharp_tpu.ckpt.mapping import flatten
from yolosharp_tpu.config import Config as JaxConfig
from yolosharp_tpu.data.dataset import YoloDataset as JaxDataset
from yolosharp_tpu.data.loader import DataLoader as JaxLoader
from yolosharp_tpu.nn import ArchCfg as JaxArch
from yolosharp_tpu.nn import YoloNet as JaxNet
from yolosharp_tpu.nn.common import ConvBN as JaxConvBN
from yolosharp_tpu.tasks import YoloTask as JaxYoloTask
from yolosharp_tpu.types import ImageProcessType as JaxIPT
from yolosharp_tpu.types import ScalarType as JaxScalar
from yolosharp_tpu.types import YoloSize as JaxSize
from yolosharp_tpu_torch import Config, ScalarType, YoloSize, YoloTask
from yolosharp_tpu_torch import train as port_train
from yolosharp_tpu_torch.ckpt import fold_bn, state_dict_from_jax
from yolosharp_tpu_torch.data import DataLoader, YoloDataset
from yolosharp_tpu_torch.data.image_ops import read_image_rgb
from yolosharp_tpu_torch.nn import ArchCfg, ConvBN, YoloNet
from yolosharp_tpu_torch.tasks import Detector
from yolosharp_tpu_torch.train import (GROUPS, TrainState, make_lr_schedule,
                                       make_optimizer, make_train_step,
                                       next_loss_scale, param_group)
from yolosharp_tpu_torch.types import ImageProcessType

NC = 3
# the JAX package's float32 gradient error at 64x64, batch 2, relative to
# each tensor's largest (1.6e-3 against float64), with margin
GRAD_NOISE = 2e-3
ADAM_EPS = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the suite runs
    several pytest workers on the host's cores, and oversubscribed torch
    threads made this file several times slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _delta_close(got, want, name=""):
    """The parameter-change rule: |d_port - d_ref| <= 1e-3 max|d_ref| +
    1e-8."""
    tol = 1e-3 * float(np.abs(want).max()) + 1e-8
    err = float(np.abs(got - want).max())
    assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("cos", [False, True])
@pytest.mark.parametrize("nb", [10, 40])
def test_lr_schedules_match_jax(cos, nb):
    """All three groups over steps 0..3nb+5 (the warm-up and past it at
    nb = 40), to 1e-6 relative."""
    kw = dict(nc=NC, epochs=5, steps_per_epoch=nb, use_cos_lr=cos)
    for bias in (False, True):
        got = make_lr_schedule(bias_group=bias, **kw)
        want = jax_train.make_lr_schedule(bias_group=bias, **kw)
        for step in range(3 * nb + 6):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("version", ["v8", "v12"])
def test_param_groups_match_jax(version):
    """Every trainable parameter of the v8n / v12n End2End nets lands in
    the group the JAX optimizer labels its leaf with."""
    jnet = JaxNet(JaxArch(version=version, size="n", task="detect", nc=NC,
                          end2end=True))
    params = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), False))["params"]
    want = {}
    for key in flatten(params):
        stem, leaf = key.rsplit(".", 1)
        leaf = "weight" if leaf in ("kernel", "scale") else leaf
        name = f"model.{stem}.{leaf}"
        want[name] = jax_train.param_group(tuple(key.split(".")))
    net = YoloNet(ArchCfg(version=version, size="n", nc=NC, end2end=True))
    got = {n: param_group(n) for n, p in net.named_parameters()
           if p.requires_grad}
    assert got == want
    opt, _ = make_optimizer(net, nc=NC, epochs=1, steps_per_epoch=1)
    assert [g["name"] for g in opt.param_groups] == list(GROUPS)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.0, 0.0, 5e-4]
    # A2C2f's gamma (v12 l and x) decays with the weights
    assert param_group("model.6.gamma") == "weight"


def test_train_mode_convbn_matches_fastbn():
    """One 3x3 ConvBN in train mode, input with a mean offset and non-unit
    running statistics: output to 1e-5, updated running mean and biased
    variance to 1e-5 relative."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 12, 10, 8)) * 2 + 0.7).astype(np.float32)
    jm = JaxConvBN(16, 3)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False)
    stats = {"mean": rng.normal(0, 0.3, 16).astype(np.float32),
             "var": rng.uniform(0.5, 2, 16).astype(np.float32)}
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    v = {"params": {"conv": v["params"]["conv"],
                    "bn": {"scale": scale,
                           "bias": rng.normal(0, 0.1, 16).astype(np.float32)}},
         "batch_stats": {"bn": stats}}
    want, upd = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    m = ConvBN(8, 16, 3).train()
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(
            np.transpose(np.array(v["params"]["conv"]["kernel"]),
                         (3, 2, 0, 1))))
        m.bn.weight.copy_(torch.from_numpy(scale))
        m.bn.bias.copy_(torch.from_numpy(v["params"]["bn"]["bias"]))
        m.bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        m.bn.running_var.copy_(torch.from_numpy(stats["var"]))
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    ust = upd["batch_stats"]["bn"]
    np.testing.assert_allclose(m.bn.running_mean.numpy(),
                               np.asarray(ust["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(m.bn.running_var.numpy(),
                               np.asarray(ust["var"]), rtol=1e-5)


def _v8n_variables(end2end, seed=0):
    jnet = JaxNet(JaxArch(version="v8", size="n", task="detect", nc=NC,
                          end2end=end2end))
    variables = jax_bias_init(jnet.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 64, 64, 3)), False), NC)
    return jnet, jitter_bn(variables, seed)


def _port_net(variables, end2end):
    net = YoloNet(ArchCfg(size="n", nc=NC, end2end=end2end))
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net.to(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_stats(net, variables, batch_stats, rtol=1e-5):
    """Every running mean and variance to rtol of itself plus rtol of its
    tensor's largest (the means near zero carry the forward's rounding)."""
    want = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": batch_stats})
    got = net.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100
    for k in keys:
        ref = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(), err_msg=k)


def test_train_mode_v8n_matches_jax():
    """The whole v8n in train mode at 96x96, batch 2: head maps to 2e-4 +
    1e-4|ref| (BN over the 18 values a channel of the stride-32 maps
    amplifies float32 rounding; the JAX package's own jit and eager
    forwards differ by 2.3e-5 here, of head maps up to ~10), every updated
    running statistic to 1e-5 relative."""
    jnet, variables = _v8n_variables(False, seed=3)
    x = np.random.default_rng(3).uniform(0, 1, (2, 96, 96, 3)).astype(
        np.float32)
    want, upd = jax.jit(lambda v, x: jnet.apply(
        v, x, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    net = _port_net(variables, False).train()
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for kind in ("box", "cls"):
        for lvl in range(3):
            np.testing.assert_allclose(
                _nhwc(got["one2many"][kind][lvl]),
                np.asarray(want["one2many"][kind][lvl]), atol=2e-4,
                rtol=1e-4)
    _assert_stats(net, variables, upd["batch_stats"])


def _batch(seed=0, b=2, m=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
    c = rng.uniform(0.25, 0.75, (b, m, 2))
    wh = rng.uniform(0.1, 0.5, (b, m, 2))
    mask = np.zeros((b, m), bool)
    mask[0, :5] = True
    mask[1, :2] = True
    bboxes = np.where(mask[..., None], np.concatenate([c, wh], -1), 0)
    return {"images": images, "cls": rng.integers(0, NC, (b, m)).astype(
        np.int32), "bboxes": bboxes.astype(np.float32), "mask_gt": mask}


def _port_config(**kw):
    return Config(yolo_size=YoloSize.n, number_class=NC,
                  scalar_type=ScalarType.float32, **kw)


def _port_state(variables):
    net = _port_net(variables, False)
    opt, scheds = make_optimizer(net, nc=NC, epochs=2, steps_per_epoch=1)
    return TrainState(net, opt, scheds)


@pytest.fixture(scope="module")
def one_step():
    """One v8n step (NMS model; the End2End loss pair is held to JAX in
    test_torch_loss.py) at 64x64, batch 2, by the JAX package's jitted
    make_train_step and by the port's make_train_step, from the same
    weights and batch."""
    jnet, variables = _v8n_variables(False, seed=5)
    batch = _batch(5)
    jloss = JaxYoloTask(JaxConfig(
        yolo_size=JaxSize.n, number_class=NC, scalar_type=JaxScalar.float32,
        end2end=False)).task._loss_fns()[0]
    tx = jax_train.make_optimizer(nc=NC, epochs=2, steps_per_epoch=1)
    jstate = jax_train.TrainState.create(variables, tx)
    jstep = jax_train.make_train_step(jnet, jloss, donate=False)
    jnew, jl, jitems = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, {})

    loss_fn = Detector(_port_config(end2end=False),
                       device="cpu")._loss_fns()[0]
    state = _port_state(variables)
    before = {k: v.clone() for k, v in state.net.state_dict().items()}
    step = make_train_step(loss_fn)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, items = step(state, tb, {})
    return dict(variables=variables, jnew=jnew, jloss=float(jl),
                jitems=np.asarray(jitems), state=state, before=before,
                loss=float(loss), items=items.numpy(), batch=tb,
                loss_fn=loss_fn)


def test_train_step_matches_jax(one_step):
    """Loss items to 1e-4 relative (the train-mode BN of batch 2 amplifies
    float32 rounding, test_train_mode_v8n_matches_jax) and BN statistics to
    1e-5 relative; one update counted. Parameter changes: the rule of
    _delta_close wherever the gradient's sign is resolved. AdamW's first
    update is lr * g / (|g| + eps), i.e. lr * sign(g), and at 64x64, batch
    2 the JAX package's float32 gradients are off by up to 1.6e-3 of each
    tensor's largest (the port's by 1.3e-4; both against a float64
    evaluation of the port's graph). So the change is checked where that
    error dg = GRAD_NOISE * max|g| moves it by less than the rule allows:
    |g| > dg (the sign is resolved) and eps * dg / g^2 < 5e-4 (Adam's eps
    term does not amplify dg). This also leaves out SPPF's cv1 BN bias,
    whose gradient is zero by construction (the identity activation and
    the max pools carry the bias into cv2's train-mode BN, which removes
    it) and ~1e-9 of rounding noise in both."""
    s = one_step
    np.testing.assert_allclose(s["items"], s["jitems"], rtol=1e-4)
    np.testing.assert_allclose(s["loss"], s["jloss"], rtol=1e-4)
    assert s["state"].count == s["state"].step == 1
    want = state_dict_from_jax(s["jnew"].variables)
    init = state_dict_from_jax(s["variables"])
    checked = total = 0
    for name, p in s["state"].net.named_parameters():
        if not p.requires_grad:
            continue
        g = p.grad.abs().numpy()
        dg = GRAD_NOISE * g.max()
        resolved = g > max(dg, (2e3 * ADAM_EPS * dg) ** 0.5)
        got = (p.detach() - s["before"][name]).numpy()
        ref = (want[name] - init[name]).numpy()
        if resolved.any():
            _delta_close(got[resolved], ref[resolved], name)
        checked += int(resolved.sum())
        total += g.size
    assert checked > 0.8 * total, (checked, total)
    _assert_stats(s["state"].net, s["variables"], s["jnew"].batch_stats)


def test_nonfinite_step_is_skipped(one_step):
    """A NaN gradient: parameters, AdamW moments and the schedules' count
    stay as they were; the step count and the BN statistics move on."""
    state = _port_state(one_step["variables"])
    step = make_train_step(one_step["loss_fn"])
    step(state, one_step["batch"], {})
    params = [p.detach().clone() for p in state.params]
    moments = copy.deepcopy(state.optimizer.state_dict()["state"])
    rv = state.net.model[0].bn.running_var.clone()
    hook = state.params[0].register_hook(lambda g: g * float("nan"))
    step(state, one_step["batch"], {})
    hook.remove()
    assert (state.step, state.count) == (2, 1)
    for p, q in zip(state.params, params):
        torch.testing.assert_close(p.detach(), q, rtol=0, atol=0)
    for i, entry in state.optimizer.state_dict()["state"].items():
        for k, v in entry.items():
            torch.testing.assert_close(v, moments[i][k], rtol=0, atol=0)
    assert not torch.equal(state.net.model[0].bn.running_var, rv)


def test_dynamic_loss_scale_semantics(monkeypatch):
    """The rules of tests/test_resume.py::test_dynamic_loss_scale_semantics
    on the port's step: the scale halves on a non-finite step (parameters
    untouched) and doubles after the growth interval (2 here)."""
    torch.manual_seed(0)
    net = torch.nn.Conv2d(3, 4, 3, padding=1)
    opt, scheds = make_optimizer(net, nc=4, epochs=2, steps_per_epoch=4)
    state = TrainState(net, opt, scheds, init_scale=65536.0)

    def loss_fn(preds, batch):
        return (preds ** 2).mean() * batch["poison"], torch.zeros(3)

    monkeypatch.setattr(port_train, "LOSS_SCALE_GROWTH_INTERVAL", 2)
    step = make_train_step(loss_fn, dynamic_loss_scale=True)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(
        rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)),
        "poison": 1.0}
    step(state, batch, {})
    assert state.loss_scale == 65536.0 and state.grow_count == 1
    before = net.weight.detach().clone()
    step(state, dict(batch, poison=float("nan")), {})
    assert state.loss_scale == 32768.0 and state.grow_count == 0
    torch.testing.assert_close(net.weight.detach(), before, rtol=0, atol=0)
    step(state, batch, {})
    step(state, batch, {})
    assert state.loss_scale == 65536.0       # grew back 32768 -> 65536
    monkeypatch.undo()
    # the rule itself: halves to at least 1, doubles to at most the cap
    assert next_loss_scale(1.0, 5, False) == (1.0, 0)
    assert next_loss_scale(65536.0, 1999, True) == (65536.0, 0)
    assert next_loss_scale(1024.0, 1999, True) == (2048.0, 0)
    assert next_loss_scale(1024.0, 3, True) == (1024.0, 4)


def test_predict_copy_refolds_after_a_step(one_step):
    """The optimizer bumps every parameter's version, so the next predict
    folds the trained master again."""
    task = YoloTask(_port_config(end2end=False), device="cpu")
    task.task.net = _port_net(one_step["variables"], False).eval()
    first = task.task._predict_variables()
    assert task.task._predict_variables() is first
    net = task.task.net
    opt, scheds = make_optimizer(net, nc=NC, epochs=2, steps_per_epoch=1)
    make_train_step(one_step["loss_fn"])(TrainState(net, opt, scheds),
                                         one_step["batch"], {})
    net.eval()
    second = task.task._predict_variables()
    assert second is not first
    want = fold_bn(copy.deepcopy(net))
    for name in ("model.0", "model.22.cv3.2.0"):
        got_m, want_m = second.get_submodule(name), want.get_submodule(name)
        torch.testing.assert_close(got_m.w_fold, want_m.w_fold)
        assert not torch.equal(got_m.w_fold,
                               first.get_submodule(name).w_fold)


# ------------------------------------------------------------ train()
@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_pngs"))
    make_dataset(root, 2, 3, [(64, 48), (48, 64), (64, 64)], NC, seed=1)
    return root


def _train_config(root, out, **kw):
    """v8n at 64x64, batch 2 (one step an epoch on 2 train images), two
    epochs, no flips and zero HSV gains: every epoch sees the same
    pixels."""
    return _port_config(
        root_path=root, train_data_path="images/train",
        val_data_path="images/val", output_path=out, image_size=64,
        batch_size=2, epochs=2, workers=1, flip_lr=0.0, hsv_h=0.0,
        hsv_s=0.0, hsv_v=0.0, **kw)


def test_tiny_train_writes_outputs_and_resumes(train_root, tmp_path):
    """Two epochs write config.txt, log.csv, best.bin, last.bin and
    last_state.npz and leave the master in eval mode. A run cut in epoch 2
    resumes from its last_state.npz at epoch 2 and ends bit for bit where
    the uncut run ends (parameters, BN statistics): both epoch-2 steps see
    the same batch, since the loader's first two shuffles of 2 images with
    seed 0 agree and the augmentations draw nothing that changes pixels."""
    full = YoloTask(_train_config(train_root, str(tmp_path / "full")),
                    device="cpu")
    full.train()
    out = tmp_path / "full"
    for f in ("config.txt", "log.csv", "weights/best.bin", "weights/last.bin",
              "weights/last_state.npz"):
        assert (out / f).exists(), f
    rows = (out / "log.csv").read_text().strip().splitlines()
    assert len(rows) == 3 and rows[0].startswith("Epoch,Time,train/box_loss")
    assert not full.task.net.training
    assert [s["epoch"] for s in full.task.epoch_stats] == [1, 2]

    cut = YoloTask(_train_config(train_root, str(tmp_path / "cut")),
                   device="cpu")
    real_val = Detector.val

    def val(self, val_dl=None, epoch=0):
        if epoch == 2:
            raise RuntimeError("cut")
        return real_val(self, val_dl, epoch)

    cut.task.val = types.MethodType(val, cut.task)
    with pytest.raises(RuntimeError, match="cut"):
        cut.train()
    resumed = YoloTask(_train_config(train_root, str(tmp_path / "cut")),
                       device="cpu")
    resumed.train(
        resume_from=str(tmp_path / "cut" / "weights" / "last_state.npz"))
    assert [s["epoch"] for s in resumed.task.epoch_stats] == [2]
    rows = (tmp_path / "cut" / "log.csv").read_text().strip().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2"]
    got = resumed.task.net.state_dict()
    want = full.task.net.state_dict()
    for name, v in want.items():
        assert torch.equal(got[name], v), name


def test_mosaic_epochs_raise_before_the_first_step(train_root, tmp_path):
    task = YoloTask(_train_config(
        train_root, str(tmp_path / "m"), close_mosaic=1,
        image_process_type=ImageProcessType.mosaic), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        task.train()
    assert not os.path.exists(tmp_path / "m" / "weights" / "last.bin")


def _self_labelled_val(root, port, seed=4):
    """Val images whose labels are the port's own detections (conf 0.1,
    the val threshold), each corner moved by up to 3 pixels, every third
    dropped and one random box added: matches at many IoUs, misses and
    false positives. Images are 64x64, so val pads them to 96x96 with 16
    pixels on each side."""
    make_dataset(root, 1, 4, [(64, 64)], NC, seed=seed)
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, "images", "val")
    for name in sorted(os.listdir(vdir)):
        img = read_image_rgb(os.path.join(vdir, name))
        canvas = np.full((96, 96, 3), 114, np.uint8)
        canvas[16:80, 16:80] = img
        rows = []
        for i, r in enumerate(port.image_predict(canvas, 0.1, 0.7)[:12]):
            if i % 3 == 2:
                continue
            # image pixels, boxes past the border kept as they are
            x1 = r.center_x - r.width / 2 - 16 + rng.uniform(-3, 3)
            y1 = r.center_y - r.height / 2 - 16 + rng.uniform(-3, 3)
            x2 = x1 + r.width + rng.uniform(-3, 3)
            y2 = y1 + r.height + rng.uniform(-3, 3)
            rows.append(f"{r.class_id} {(x1 + x2) / 128:.6f} "
                        f"{(y1 + y2) / 128:.6f} {(x2 - x1) / 64:.6f} "
                        f"{(y2 - y1) / 64:.6f}")
        rows.append(f"{rng.integers(NC)} 0.5 0.5 0.3 0.4")
        label = os.path.join(root, "labels", "val",
                             os.path.splitext(name)[0] + ".txt")
        with open(label, "w") as f:
            f.write("\n".join(rows) + "\n")


def test_val_matches_jax(tmp_path):
    """val of the NMS model on the same weights (conv kernels x2.5 and the
    head's final convs from U(-0.3, 0.3), so that there are detections),
    on images labelled from those detections: loss items to 1e-4
    relative, P, R, mAP50 and mAP50-95 to 1e-4."""
    root = str(tmp_path)
    cfg = _train_config(root, "", end2end=False)
    port = YoloTask(cfg, device="cpu")
    net = port.task._ensure_variables()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                m.conv.weight.mul_(2.5)
        for tower in (net.model[22].cv2, net.model[22].cv3):
            for branch in tower:
                for p in (branch[2].weight, branch[2].bias):
                    p.copy_(torch.from_numpy(
                        rng.uniform(-0.3, 0.3, p.shape).astype(np.float32)))
    _self_labelled_val(root, port)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    jcfg = JaxConfig(root_path=root, train_data_path="images/train",
                     val_data_path="images/val", yolo_size=JaxSize.n,
                     number_class=NC, image_size=64, batch_size=2,
                     scalar_type=JaxScalar.float32, end2end=False,
                     image_process_type=JaxIPT.letterbox)
    det = JaxYoloTask(jcfg).task
    det.variables, report = state_dict_to_variables(
        sd, det._ensure_variables())
    assert not report.missing
    jds = JaxDataset(jcfg, is_val=True)
    want_items, want_metrics = det.val(
        JaxLoader(jds, 2, shuffle=False, workers=1,
                  max_labels=jds.max_label_count), 0)
    ds = YoloDataset(cfg, is_val=True)
    got_items, got_metrics = port.val(
        DataLoader(ds, 2, shuffle=False, workers=1,
                   max_labels=ds.max_label_count))
    np.testing.assert_allclose(got_items, np.asarray(want_items), rtol=1e-4)
    np.testing.assert_allclose(got_metrics, want_metrics, atol=1e-4)
    assert min(want_metrics) > 0.05 and max(want_metrics) < 0.99

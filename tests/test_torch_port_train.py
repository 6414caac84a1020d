"""The port's training modules against `usot_tpu` on the CPU: the copied
config, schedules and epoch weights; the losses; the pretrain loader;
checkpoints; and the naive-Siamese phase of `forward_train` and the step
(`train/step.py`, `train/optim.py`) with the NaN/explosion gate and
gradient accumulation. The cycle-memory phase and remat are in
`test_torch_port_train_cycle.py`, whose note says why the unfrozen phase
is held in float64 on both sides; the trainer in
`test_torch_port_train_cli.py`.

Tolerances are scale-aware (`max |ours - ref| / max(max |ref|, 1)`)
unless named relative; each states the measured value it covers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import usot_tpu.config.defaults as jax_defaults
import usot_tpu.train.losses as jax_losses
from usot_tpu.models.convert import convert_backbone_pretrain as \
    jax_convert_backbone
from usot_tpu.models.convert import load_pretrain as jax_load_pretrain
from usot_tpu.train.schedulers import build_lr_spaces as jax_lr_spaces
from usot_tpu.train.step import epoch_weights as jax_epoch_weights
from usot_tpu_torch.config.defaults import default_config, load_config
from usot_tpu_torch.models.convert import (convert_backbone_pretrain,
                                           load_pretrain,
                                           state_dict_from_flax)
from usot_tpu_torch.train import checkpoint, losses
from usot_tpu_torch.train.optim import build_optimizer, label_params
from usot_tpu_torch.train.schedulers import build_lr_spaces
from usot_tpu_torch.train.step import epoch_weights

from torch_port_common import (WEIGHT_DECAY, jax_train_run, load_fixture,
                               port_model, port_train_run, random_variables,
                               scaled_err, train_batch)

torch.set_num_threads(2)
B = 2
EXPERIMENT = "experiments/train/USOT.yaml"


# ------------------------------------------------------------- the copies

def test_config_copy_equals_jax():
    """The port's `config/defaults.py` is a copy: defaults and the merged
    experiment file equal JAX's."""
    assert default_config() == jax_defaults.default_config()
    assert load_config(EXPERIMENT) == jax_defaults.load_config(EXPERIMENT)


def test_schedules_equal_jax():
    """LR spaces (warmup + log decay, and the other policies) and the
    per-epoch lambda_1 / cls_ratio of the reference recipe."""
    tc = load_config(EXPERIMENT).USOT.TRAIN
    jtc = jax_defaults.load_config(EXPERIMENT).USOT.TRAIN
    np.testing.assert_array_equal(build_lr_spaces(tc, 30),
                                  jax_lr_spaces(jtc, 30))
    for policy in ("step", "multi-step", "linear", "cos"):
        tc.LR.TYPE = jtc.LR.TYPE = policy
        tc.WARMUP.IFNOT = jtc.WARMUP.IFNOT = False
        np.testing.assert_array_equal(build_lr_spaces(tc, 30),
                                      jax_lr_spaces(jtc, 30))
    for epoch in range(1, 31):
        assert epoch_weights(tc, epoch) == jax_epoch_weights(jtc, epoch)


# ----------------------------------------------------------------- losses

def _loss_case(case):
    rng = np.random.default_rng(7)
    pred = (rng.normal(size=(2, 25, 25, 1)) * 3).astype(np.float32)
    label = (rng.random((2, 25, 25)) > 0.85).astype(np.float32)
    box = np.abs(rng.normal(size=(2, 25, 25, 4)) * 20 + 30).astype(
        np.float32)
    target = np.abs(rng.normal(size=(2, 25, 25, 4)) * 20 + 30).astype(
        np.float32)
    weight = (rng.random((2, 25, 25)) > 0.7).astype(np.float32)
    if case == "all_negative":
        label[:] = 0.0
    elif case == "ignored_cells":
        label[0, :3] = 0.5
    elif case == "masked_negative_targets":
        # outside the box the ltrb targets go negative, as the dataset's
        target[weight == 0] = -np.abs(target[weight == 0])
    elif case == "no_positive_box":
        weight[:] = 0.0
        target[:] = -7.0
    return pred, label, box, target, weight


@pytest.mark.parametrize("case", ["random", "all_negative", "ignored_cells",
                                  "masked_negative_targets",
                                  "no_positive_box"])
def test_losses_match_jax(case):
    """weighted BCE and -log IoU within 1e-6 relative (measured <= 1.3e-7);
    masked cells with negative targets and empty masks stay finite."""
    pred, label, box, target, weight = _loss_case(case)
    pairs = (
        (losses.weighted_bce(torch.from_numpy(pred), torch.from_numpy(label)),
         jax_losses.weighted_bce(jnp.asarray(pred), jnp.asarray(label))),
        (losses.iou_loss(torch.from_numpy(box), torch.from_numpy(target),
                         torch.from_numpy(weight)),
         jax_losses.iou_loss(jnp.asarray(box), jnp.asarray(target),
                             jnp.asarray(weight))),
    )
    for ours, ref in pairs:
        ours, ref = float(ours), float(ref)
        assert np.isfinite(ours)
        assert abs(ours - ref) <= 1e-6 * max(abs(ref), 1e-6), (ours, ref)


def test_iou_loss_gradient_ignores_masked_cells():
    """The safe-ratio select keeps NaN out of the gradient too: cells
    outside the mask get exactly zero gradient."""
    _, _, box, target, weight = _loss_case("masked_negative_targets")
    pred = torch.from_numpy(box).requires_grad_()
    losses.iou_loss(pred, torch.from_numpy(target),
                    torch.from_numpy(weight)).backward()
    assert torch.isfinite(pred.grad).all()
    assert torch.all(pred.grad[torch.from_numpy(weight) == 0] == 0)


# ---------------------------------------------------------- pretrain load

def _moco_backbone(rng, width):
    """A torchvision-layout ResNet-50 state dict with MoCo's `encoder_q.`
    prefix (1x1 downsamples, a layer4 and an fc the port ignores)."""
    sd, cin = {}, 3

    def bn(key, c):
        for name, fn in (("weight", rng.uniform), ("bias", rng.normal),
                         ("running_mean", rng.normal),
                         ("running_var", rng.uniform)):
            sd[f"{key}.{name}"] = torch.from_numpy(
                fn(size=c).astype(np.float32))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(7)

    def conv(key, cout, cin, k):
        sd[key] = torch.from_numpy(rng.normal(size=(cout, cin, k, k))
                                   .astype(np.float32))

    conv("conv1.weight", width, 3, 7)
    bn("bn1", width)
    cin = width
    for layer, (blocks, planes) in enumerate(zip((3, 4, 6, 3),
                                                 (1, 2, 4, 8)), start=1):
        p = planes * width
        for i in range(blocks):
            tb = f"layer{layer}.{i}."
            conv(tb + "conv1.weight", p, cin, 1)
            bn(tb + "bn1", p)
            conv(tb + "conv2.weight", p, p, 3)
            bn(tb + "bn2", p)
            conv(tb + "conv3.weight", 4 * p, p, 1)
            bn(tb + "bn3", 4 * p)
            if i == 0:
                conv(tb + "downsample.0.weight", 4 * p, cin, 1)
                bn(tb + "downsample.1", 4 * p)
            cin = 4 * p
    sd["fc.weight"] = torch.zeros(10, cin)
    return {"module.encoder_q." + k: v for k, v in sd.items()}


def test_backbone_pretrain_matches_jax(tmp_path):
    """A MoCo-keyed backbone pretrain through `load_pretrain`, against
    JAX's `load_pretrain` on the same file: every weight equal (the 1x1
    downsamples of layer2/3 zero-padded into the 3x3 slot), the head and
    the stem's neighbours outside the backbone unchanged."""
    kw, v = load_fixture()
    path = str(tmp_path / "moco.pth")
    torch.save({"state_dict": _moco_backbone(np.random.default_rng(0),
                                             kw["width"]), "epoch": 200},
               path)
    ref = state_dict_from_flax(jax_load_pretrain(v, path))
    model = port_model(v)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    load_pretrain(model, path)
    got = model.state_dict()
    for k, t in ref.items():
        assert torch.equal(got[k], t), k
    ds = got["features.features.layer3.0.downsample.0.weight"]
    assert ds.shape[2:] == (3, 3) and torch.all(ds[:, :, 0] == 0) \
        and torch.all(ds[:, :, :, 2] == 0)
    assert torch.equal(got["connect_model.cls_pred.weight"],
                       before["connect_model.cls_pred.weight"])
    assert not torch.equal(got["features.features.conv1.weight"],
                           before["features.features.conv1.weight"])


def test_backbone_pretrain_conversion_alone():
    """`convert_backbone_pretrain` on numpy values, without the file, as
    JAX's converter (`backbone.` prefix, canonical keys)."""
    kw, v = load_fixture()
    sd = {k.replace("module.encoder_q.", "backbone."): t.numpy()
          for k, t in _moco_backbone(np.random.default_rng(1),
                                     kw["width"]).items()}
    ref = state_dict_from_flax(jax_convert_backbone(sd, v))
    got = convert_backbone_pretrain(sd, port_model(v).state_dict())
    for k, t in ref.items():
        assert torch.equal(got[k], t), k


def test_full_checkpoint_pretrain_loads_whole(tmp_path):
    """A full USOT checkpoint (`connect_model.` keys, `module.` prefixes)
    loads whole, over other weights."""
    _, v = load_fixture()
    path = str(tmp_path / "usot.pth")
    want = state_dict_from_flax(v)
    torch.save({"state_dict": {"module." + k: t for k, t in want.items()}},
               path)
    model = port_model(random_variables(2))
    load_pretrain(model, path)
    for k, t in want.items():
        assert torch.equal(model.state_dict()[k], t), k


# ------------------------------------------------------------ checkpoints

def test_checkpoint_roundtrip(tmp_path):
    """`save_model_epoch` writes nothing before epoch 5, then
    `checkpoint_eN.pth`; `peek_epoch` and `restore_checkpoint` (into an
    optimizer built for the checkpoint's stage) bring the weights, the BN
    stats and the momentum buffers back bitwise."""
    _, v = load_fixture()
    model = port_model(random_variables(3))
    opt, _ = build_optimizer(model, 0.9, 1e-4, 0.1, True)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    assert checkpoint.save_model_epoch(str(tmp_path), model, opt, 4) is None
    path = checkpoint.save_model_epoch(str(tmp_path), model, opt, 7)
    assert path.endswith("checkpoint_e7.pth")
    assert checkpoint.peek_epoch(path) == 7
    fresh = port_model(v)
    fresh_opt, _ = build_optimizer(fresh, 0.9, 1e-4, 0.1, True)
    assert checkpoint.restore_checkpoint(path, fresh, fresh_opt) == 7
    for k, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    pairs = [(fresh_opt.state[a]["momentum_buffer"],
              opt.state[b]["momentum_buffer"])
             for a, b in zip(fresh.parameters(), model.parameters())
             if b.requires_grad]
    assert len(pairs) > 0 and all(torch.equal(a, b) for a, b in pairs)


def test_optimizer_groups():
    """Frozen: the stem always, the stages before UNFIX_EPOCH (no grad,
    in no group); backbone group at LAYERS_LR; base: neck and head."""
    _, v = load_fixture()
    model = port_model(v)
    for unfix in (False, True):
        opt, labels = build_optimizer(model, 0.9, 1e-4, 0.1, unfix)
        assert labels == label_params(model, unfix)
        names = {g["name"]: g for g in opt.param_groups}
        assert set(names) == ({"backbone", "base"} if unfix else {"base"})
        assert names["base"]["lr_mult"] == 1.0
        for n, p in model.named_parameters():
            stage = n.startswith("features.features.layer")
            frozen = n.startswith("features.") and not (unfix and stage)
            assert labels[n] == ("frozen" if frozen else
                                 "backbone" if stage else "base"), n
            assert p.requires_grad == (not frozen), n
        if unfix:
            assert names["backbone"]["lr_mult"] == 0.1
            assert all(g["momentum"] == 0.9 and g["dampening"] == 0.0
                       and g["weight_decay"] == 1e-4 and not g["nesterov"]
                       for g in opt.param_groups)


# ------------------------------------------------------ the naive phase

def _gated_batches():
    """Two batches the NaN/explosion gate must refuse, in the frozen
    phase's dtypes: an exploding but finite loss (IoU-loss weight +1e7 on
    a cell of the box and -1e7 on one outside it: the masked mean's count
    stays, its sum gains 1e7 times the cell's loss) and an inf one (an inf template box: the pooled kernel, the
    heads and the loss go NaN). A NaN label would not do: XLA folds the
    masks into selects, so JAX's jitted loss drops the cell."""
    explode = train_batch(5, B)
    w = explode["reg_weight"] = explode["reg_weight"].copy()
    inside, outside = np.argwhere(w[0] == 1)[0], np.argwhere(w[0] == 0)[0]
    w[0][tuple(inside)] += 1e7
    w[0][tuple(outside)] = -1e7
    inf = train_batch(5, B)
    inf["template_bbox"] = inf["template_bbox"].copy()
    inf["template_bbox"][0, 2] = np.inf
    return [explode, inf]


@pytest.fixture(scope="module", params=["frozen", "unfrozen"])
def phase(request):
    """Two steps of the naive phase in both packages (frozen: float32,
    then the NaN-gated batch; unfrozen: float64, and the port's float32
    step against it)."""
    _, v = load_fixture()
    unfix = request.param == "unfrozen"
    batches = [train_batch(1, B), train_batch(2, B)]
    if not unfix:
        batches += _gated_batches()
    jax_runs = jax_train_run(v, False, unfix, batches, x64=unfix)
    port_runs, labels = port_train_run(
        v, False, unfix, batches, dtype=torch.float64 if unfix else None)
    f32_runs = port_train_run(v, False, unfix, batches[:1])[0] \
        if unfix else port_runs
    return dict(unfix=unfix, jax=jax_runs, port=port_runs, f32=f32_runs,
                labels=labels, init={k: t.numpy() for k, t in
                                     port_model(v).state_dict().items()})


def _stat_keys(state):
    return [k for k in state if k.endswith(("running_mean", "running_var"))]


def _held(phase, tol_f32, tol_f64):
    return [(phase["f32"], tol_f32)] + (
        [(phase["port"], tol_f64)] if phase["unfix"] else [])


def test_forward_train_losses(phase):
    """Losses within 1e-4 relative: measured 1.4e-6 (frozen), 2.3e-5
    (unfrozen, port f32 against JAX f64), 1.1e-7 (f64); the memory loss
    is zero in this phase."""
    ref = phase["jax"][0]["metrics"]
    for runs, tol in _held(phase, 1e-4, 1e-6):
        got = runs[0]["metrics"]
        assert got["cls_loss_memory"] == ref["cls_loss_memory"] == 0.0
        for k in ("cls_loss_ori", "reg_loss", "loss"):
            assert abs(got[k] - ref[k]) <= tol * abs(ref[k]), (k, got, ref)


def test_forward_train_bn_stats(phase):
    """BN running stats within 1e-4: measured 2.0e-6 (frozen), 3.6e-6
    (unfrozen, f32 vs f64), 6e-8 (f64). Neck and head moved; the stages
    only when unfrozen; the stem never."""
    ref = phase["jax"][0]["params"]
    for runs, tol in _held(phase, 1e-4, 1e-6):
        for k in _stat_keys(ref):
            assert scaled_err(runs[0]["params"][k], ref[k]) <= tol, k
    got, init = phase["port"][0]["params"], phase["init"]
    moved = {k for k in _stat_keys(ref) if not np.array_equal(got[k],
                                                               init[k])}
    stages = {k for k in _stat_keys(ref)
              if k.startswith("features.features.layer")}
    assert (stages <= moved) if phase["unfix"] else not (stages & moved)
    assert not any(k.startswith("features.features.bn1") for k in moved)
    assert "neck.downsample.1.running_mean" in moved


def test_step_gradients(phase):
    """Per-tensor gradients against JAX's first-step trace less the
    weight decay: 1e-4 frozen (measured 7.1e-6), 1e-6 f64 (1.1e-7).
    The memory head, which this phase does not reach, gets zero
    gradients in both (so weight decay moves it, as optax does)."""
    tol = 1e-6 if phase["unfix"] else 1e-4
    init, ref = phase["init"], phase["jax"][0]["momentum"]
    grads = phase["port"][0]["grads"]
    assert set(grads) == {n for n, label in phase["labels"].items()
                          if label != "frozen"}
    for n, g in grads.items():
        assert scaled_err(g, ref[n] - WEIGHT_DECAY * init[n]) <= tol, n


def test_step_params_and_momentum(phase):
    """Params after each of two updates within 1e-5 (measured 1.2e-7
    frozen, 6e-8 f64); torch's momentum equal to optax's trace after each
    (torch seeds the buffer with the first gradient, optax adds it to
    zero): 1e-4 frozen (measured 7.1e-6), 1e-6 f64 (6e-8); frozen params
    bitwise unchanged."""
    tol = 1e-6 if phase["unfix"] else 1e-4
    for got, ref in zip(phase["port"][:2], phase["jax"][:2]):
        for n, label in phase["labels"].items():
            assert scaled_err(got["params"][n], ref["params"][n]) <= 1e-5, n
            if label == "frozen":
                assert np.array_equal(got["params"][n], phase["init"][n]), n
        assert set(got["momentum"]) == set(phase["port"][0]["grads"])
        for n, buf in got["momentum"].items():
            assert scaled_err(buf, ref["momentum"][n]) <= tol, n


@pytest.mark.parametrize("phase", ["frozen"], indirect=True)
@pytest.mark.parametrize("which", [2, 3], ids=["explodes", "inf"])
def test_nan_gate(phase, which):
    """A gated step (the frozen phase's third and fourth batches): the loss
    is >= 1e4 or not finite in both packages; params and momentum stay
    bitwise as after the second step; the BN running stats take this
    step's update, as JAX's step returns its new stats either way (1e-4;
    measured 2.1e-6 and 2.4e-6; the inf batch makes 28 stat tensors NaN
    in both, at the same entries)."""
    before, after = phase["port"][1], phase["port"][which]
    ref = phase["jax"][which]
    for m in (after["metrics"], ref["metrics"]):
        assert not (np.isfinite(m["loss"]) and m["loss"] < 1e4), m
    for n in phase["labels"]:
        assert np.array_equal(after["params"][n], before["params"][n]), n
    for n, buf in after["momentum"].items():
        assert np.array_equal(buf, before["momentum"][n]), n
    moved = 0
    for k in _stat_keys(ref["params"]):
        got, want = after["params"][k], ref["params"][k]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        if ok.any():
            assert scaled_err(got[ok], want[ok]) <= 1e-4, k
        moved += not np.array_equal(got, phase["port"][which - 1]["params"][k])
    assert moved > 0


def test_skipped_counts_the_gated_steps(phase):
    """`step.skipped` after each step is the running count of the JAX
    run's steps on the same batches whose loss fails the gate (not finite
    or >= 1e4): the frozen phase's third and fourth batches."""
    gated = [not (np.isfinite(r["metrics"]["loss"])
                  and r["metrics"]["loss"] < 1e4) for r in phase["jax"]]
    want = np.cumsum(gated).tolist()
    assert len(phase["port"]) == len(phase["jax"])
    assert [r["skipped"] for r in phase["port"]] == want
    assert want[-1] == (0 if phase["unfix"] else 2)


def test_accum_matches_jax():
    """accum=2 on a B=2 batch (two microbatches of 1, BN stats threaded
    through them) against JAX's `accum_steps=2`: losses 1e-5 relative
    (measured 1.2e-6), params and stats 1e-5 (1.8e-6), momentum 2e-3
    (3.5e-4: train-mode BN over single samples), and not the plain
    step's result."""
    _, v = load_fixture()
    batches = [train_batch(6, B)]
    ref = jax_train_run(v, False, False, batches, accum=2)[0]
    got = port_train_run(v, False, False, batches, accum=2)[0][0]
    plain = port_train_run(v, False, False, batches)[0][0]
    for k in ("cls_loss_ori", "reg_loss", "loss"):
        assert abs(got["metrics"][k] - ref["metrics"][k]) \
            <= 1e-5 * abs(ref["metrics"][k]), k
    assert got["metrics"]["loss"] != plain["metrics"]["loss"]
    for k in got["params"]:
        if k.endswith("num_batches_tracked"):
            continue
        assert scaled_err(got["params"][k], ref["params"][k]) <= 1e-5, k
    for n, buf in got["momentum"].items():
        assert scaled_err(buf, ref["momentum"][n]) <= 2e-3, n

"""Flax checkpoints read without flax, on the CPU.

* `usot_tpu_torch.utils.msgpack.msgpack_restore` against
  `flax.serialization.msgpack_restore`, bitwise: the committed fixture,
  `usot_tpu` training checkpoints written by its `save_checkpoint` with
  the backbone frozen and unfrozen (optax's `MaskedNode` leaves are empty
  maps), a bfloat16 array, a chunked array and the scalar types;
* `load_model_state` and `restore_checkpoint`: a flax file's weights, BN
  statistics and optax momentum land in the port's model and optimizer
  (frozen parameters, `MaskedNode` in optax, have no torch state);
* the test CLI with `--resume <fixture>.msgpack` writes the same result
  files as with the fixture converted to a `.pth`;
* the trainer resumed from `checkpoint_e5.ckpt` (`--resume`) runs epoch 6
  as JAX continues from the same file (JAX's `restore_checkpoint` and
  `make_train_step` over the same shards, lr and loss weights), with the
  backbone frozen: losses within 1e-4 relative (the training tests'),
  parameters and BN stats within 1e-4 and momentum within 5e-3
  scale-aware (measured 2.3e-5 and 2.2e-3: the two packages' frozen
  float32 gradients differ by up to ~1e-3 of their scale, the training
  tests' band, and two steps at lr 0.005 carry that into both).
  Unfrozen, float32 steps are ill-conditioned
  (`test_torch_port_train_cycle.py` holds them in float64), so the
  unfrozen stage's mapping is held bitwise, by
  `test_restore_maps_optax_momentum`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from usot_tpu.train.checkpoint import save_checkpoint
from usot_tpu.train.optim import build_optimizer as jax_optimizer
from usot_tpu.train.step import TrainState
from usot_tpu_torch.cli import test as test_cli
from usot_tpu_torch.cli.train import main as train_main
from usot_tpu_torch.models.convert import state_dict_from_flax
from usot_tpu_torch.models.usot import build_usot
from usot_tpu_torch.train.checkpoint import (load_model_state, peek_epoch,
                                             restore_checkpoint)
from usot_tpu_torch.train.optim import build_optimizer
from usot_tpu_torch.utils.msgpack import msgpack_restore

from torch_port_common import (FIXTURE, LAYERS_LR, MOMENTUM, WEIGHT_DECAY,
                               load_fixture, optax_momentum, scaled_err,
                               torch_layout)

torch.set_num_threads(2)


def _same(ours, ref, path="/"):
    """Bitwise the tree flax restores: same keys in the same order, the
    same array dtypes, shapes and bytes, the same scalars and types."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            _same(ours[k], ref[k], f"{path}{k}/")
    elif isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same(a, b, f"{path}{i}/")
    elif isinstance(ref, np.ndarray) and ref.dtype == jnp.bfloat16:
        assert torch.is_tensor(ours) and ours.dtype == torch.bfloat16, path
        assert tuple(ours.shape) == ref.shape, path
        np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                      ref.view(np.int16), err_msg=path)
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        assert ours.tobytes() == ref.tobytes(), path
    else:
        assert type(ours) is type(ref) and ours == ref, (path, ours, ref)


def test_reader_restores_the_fixture_bitwise():
    with open(FIXTURE, "rb") as f:
        data = f.read()
    _same(msgpack_restore(data), serialization.msgpack_restore(data))


def _jax_checkpoint(directory, unfix: bool, epoch: int, seed: int = 0):
    """A `usot_tpu` training checkpoint of the fixture's weights whose
    optax momentum is seeded noise (so a wrong mapping shows)."""
    _, v = load_fixture()
    tx, _ = jax_optimizer(v["params"], MOMENTUM, WEIGHT_DECAY, LAYERS_LR,
                          unfix)
    opt_state = tx.init(v["params"])
    rng = np.random.default_rng(seed)

    def noise(a):
        return (rng.normal(0.0, 0.05, np.shape(a))).astype(np.float32)

    opt_state = jax.tree.map(noise, opt_state)
    state = TrainState(v["params"], v["batch_stats"], opt_state)
    return save_checkpoint(str(directory), state, epoch), opt_state


@pytest.mark.parametrize("unfix", [False, True], ids=["frozen", "unfrozen"])
def test_reader_restores_training_checkpoints_bitwise(tmp_path, unfix):
    path, _ = _jax_checkpoint(tmp_path, unfix, 5)
    with open(path, "rb") as f:
        data = f.read()
    ours = msgpack_restore(data)
    _same(ours, serialization.msgpack_restore(data))
    assert peek_epoch(path) == 5 and ours["arch"] == "USOT"
    trace = ours["opt_state"]["inner_states"]["backbone"]["inner_state"][
        "1"]["trace"]["features"]
    # the stem is always frozen: MaskedNode, an empty map
    assert trace["stem"]["conv"]["kernel"] == {}
    assert isinstance(trace["layer1_0"]["cb1"]["conv"]["kernel"],
                      np.ndarray) == unfix


def test_reader_restores_bf16_chunked_and_scalars(monkeypatch):
    import flax.serialization as fs

    rng = np.random.default_rng(1)
    tree = {"bf16": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
            "f32": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "i8": np.arange(-3, 4, dtype=np.int8), "empty": np.zeros((0, 2)),
            "scalar": np.float32(2.5), "int64": np.int64(-7),
            "ints": [0, 127, 128, 255, 65536, -1, -33, -129, -40000, 2 ** 40,
                     -2 ** 40], "floats": [0.5, -1e300], "flags": [True,
                                                              False, None],
            "text": "é" * 40, "bytes": b"\x00\x01" * 200,
            "nested": {"deep": {"x": np.ones(3, np.float64)}}}
    data = serialization.msgpack_serialize(tree)
    _same(msgpack_restore(data), serialization.msgpack_restore(data))
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)  # chunk the big leaves
    data = serialization.msgpack_serialize(
        {"w": rng.normal(size=(9, 7)).astype(np.float32),
         "b": jnp.asarray(rng.normal(size=(70,)), jnp.bfloat16)})
    ours, ref = msgpack_restore(data), serialization.msgpack_restore(data)
    _same(ours, ref)
    assert ours["w"].shape == (9, 7)


def test_reader_refuses_what_usot_files_do_not_hold():
    data = serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_restore(data)
    data = serialization.msgpack_serialize({"w": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-3])


def test_load_model_state_reads_flax_and_torch_files(tmp_path):
    _, v = load_fixture()
    want = state_dict_from_flax(v)
    got = load_model_state(FIXTURE)
    pth = tmp_path / "fixture.pth"
    torch.save({"state_dict": {f"module.{k}": t for k, t in want.items()}},
               pth)
    for state in (got, load_model_state(str(pth))):
        assert set(state) == set(want)
        for k in want:
            assert torch.equal(state[k], want[k]), k
    kw, _ = load_fixture()
    build_usot(**kw).load_state_dict(got)  # strict


def test_restore_maps_optax_momentum(tmp_path):
    """Weights and stats bitwise; each trainable parameter's
    `momentum_buffer` is optax's trace in the torch layout, bitwise; the
    frozen ones (the stem always) have no state."""
    path, opt_state = _jax_checkpoint(tmp_path, True, 5, seed=3)
    kw, v = load_fixture()
    model = build_usot(**kw)
    opt, labels = build_optimizer(model, MOMENTUM, WEIGHT_DECAY, LAYERS_LR,
                                  True)
    assert restore_checkpoint(path, model, opt) == 5
    want = state_dict_from_flax(v)
    for k, t in model.state_dict().items():
        if k in want:
            assert torch.equal(t, want[k]), k
    momentum = torch_layout(optax_momentum(opt_state, v["params"]),
                            v["batch_stats"])
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            assert p not in opt.state, name
        else:
            np.testing.assert_array_equal(
                opt.state[p]["momentum_buffer"].numpy(), momentum[name],
                err_msg=name)
    assert any(labels[n] == "frozen" for n in labels)


def test_test_cli_resumes_from_the_fixture_msgpack(tmp_path):
    """`--resume <fixture>.msgpack` and the same weights as a `.pth`: the
    same result files, byte for byte (parity tracker, OTB layout)."""
    from test_torch_port_cli import _write_datasets

    root = tmp_path / "datasets"
    _write_datasets(root)
    kw, v = load_fixture()
    pth = tmp_path / "fixture.pth"
    torch.save(state_dict_from_flax(v), pth)
    outs = {}
    for tag, ckpt in (("msgpack", FIXTURE), ("pth", str(pth))):
        outs[tag] = tmp_path / tag
        test_cli.main(["--dataset", "OTB2015", "--dataset_root", str(root),
                       "--result_dir", str(outs[tag]), "--resume", ckpt,
                       "--device", "cpu", "--width", "8", "--channels",
                       "32", "--mem_size", str(kw["mem_size"]),
                       "--engine", "parity"])
    files = sorted(os.listdir(outs["pth"] / "OTB2015" / "USOT"))
    assert files == ["Car1.txt", "Walk2.txt"]
    for name in files:
        a = (outs["msgpack"] / "OTB2015" / "USOT" / name).read_text()
        b = (outs["pth"] / "OTB2015" / "USOT" / name).read_text()
        assert a == b and len(a.splitlines()) > 1, name


END_EPOCH = 6  # naive Siamese and frozen throughout (both at 7)


def _train_cfg(root):
    cfg = {"USOT": {
        "OUTPUT_DIR": str(root / "log"),
        "CHECKPOINT_DIR": str(root / "snapshot"), "PRINT_FREQ": 1,
        "TRAIN": {"WIDTH": 8, "CHANNELS": 32, "START_EPOCH": 1,
                  "END_EPOCH": END_EPOCH, "BATCH": 2, "BATCH_STAGE_2": 2,
                  "MEMORY_EPOCH": 7, "UNFIX_EPOCH": 7,
                  "MEMORY_NUM": 2, "PRETRAIN": "none.pth"}}}
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_cli_resumes_from_a_jax_checkpoint(tmp_path):
    from usot_tpu.cli.make_shards import epoch_dir as jax_epoch_dir
    from usot_tpu.config.defaults import load_config as jax_config
    from usot_tpu.data.shards import ShardLoader as JaxShards
    from usot_tpu.models.usot import build_usot as jax_build
    from usot_tpu.train.checkpoint import restore_checkpoint as jax_restore
    from usot_tpu.train.schedulers import build_lr_spaces
    from usot_tpu.train.step import epoch_weights, make_train_step
    from usot_tpu_torch.tools.synthetic_shards import write_training_shards

    ckpt, _ = _jax_checkpoint(tmp_path / "jax", False, 5, seed=5)
    shards = str(tmp_path / "shards")
    write_training_shards(shards, END_EPOCH, 7, 4, 2, seed=11)
    cfg = _train_cfg(tmp_path)

    # the port's trainer, resumed from usot_tpu's file
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)  # no pretrain/none.pth there: from scratch
        record = train_main(["--cfg", cfg, "--device", "cpu", "--shards",
                             shards, "--resume", ckpt])
    assert record["start_epoch"] == END_EPOCH
    assert list(record["epochs"]) == [str(END_EPOCH)]
    port_losses = np.array(record["epochs"][str(END_EPOCH)]["losses"])
    port_ckpt = torch.load(
        str(tmp_path / "snapshot" / f"checkpoint_e{END_EPOCH}.pth"),
        map_location="cpu", weights_only=True)

    # JAX continuing from the same file over the same shards
    tc = jax_config(cfg).USOT.TRAIN
    kw, v = load_fixture()
    model = jax_build(**kw)
    tx, _ = jax_optimizer(v["params"], tc.MOMENTUM, tc.WEIGHT_DECAY,
                          tc.LAYERS_LR, False)
    state, epoch = jax_restore(ckpt, TrainState(
        v["params"], v["batch_stats"], tx.init(v["params"])))
    assert epoch == 5
    lambda_1, lambda_total, cls_ratio = epoch_weights(tc, END_EPOCH)
    step = make_train_step(model, tx, False, False, lambda_1, lambda_total,
                           tc.LAMBDA_1_NAIVE)
    lr = float(build_lr_spaces(tc, tc.END_EPOCH)[END_EPOCH - 1])
    losses = []
    for batch in JaxShards(jax_epoch_dir(shards, END_EPOCH), tc.BATCH):
        state, met = step(state, batch, jnp.float32(lr),
                          jnp.float32(cls_ratio))
        losses.append(float(met["loss"]))
    assert len(losses) == len(port_losses) == 2
    np.testing.assert_allclose(port_losses, losses, rtol=1e-4, atol=0)

    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    want = torch_layout(params, stats)
    for k, t in port_ckpt["state_dict"].items():
        if k in want:
            assert scaled_err(t.numpy(), want[k]) <= 1e-4, k
    ref = torch_layout(optax_momentum(state.opt_state, params), stats)
    model_pt = build_usot(**kw)
    opt, labels = build_optimizer(model_pt, 0.9, 1e-4, 0.1, False)
    names = {id(p): n for n, p in model_pt.named_parameters()}
    order = [names[id(p)] for g in opt.param_groups for p in g["params"]]
    momentum = port_ckpt["optimizer"]["state"]
    assert len(momentum) == len(order) > 0
    for i, st in momentum.items():
        n = order[i]
        assert labels[n] == "base", n
        assert scaled_err(st["momentum_buffer"].numpy(), ref[n]) <= 5e-3, n

"""Pretrained-backbone import in the port (`utils/pretrained.py`,
`train.seed_backbone`) against the JAX reference's
`bdd100k_tpu/utils/pretrained.py`, on the CPU, on synthetic state dicts
(nothing is downloaded).

Each case starts both sides from the same weights: the port's freshly
built detector, and the reference's variables made from it through the
port's key mapping. The reference's import runs on those variables, its
result is mapped back, and every tensor of the port's seeded model must
equal it: the seeded ones and the ones left at their init. Cases: a
torchvision VGG16 `.pth`; HF MobileNetV1 `.bin`, with and without the
classifier's `mobilenet_v1.` prefix; a bare `save_params_npz` transplant
(and the file the port writes equal to the reference's); the committed
SSD300 artifact seeding a YOLO-384 backbone; VGG, whose backbone has no
BatchNorm statistics, from a full artifact. Then the trainer: the EMA
shadow re-anchored at the seeded weights, and no seeding on a resume.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bdd100k_tpu_torch import train as port_train  # noqa: E402
from bdd100k_tpu_torch.configs import TrainConfig, get_config, tiny_test_config  # noqa: E402
from bdd100k_tpu_torch.models.detector import build_detector  # noqa: E402
from bdd100k_tpu_torch.parallel import train_step  # noqa: E402
from bdd100k_tpu_torch.utils import pretrained  # noqa: E402
from bdd100k_tpu_torch.utils.weights import (  # noqa: E402
    flax_from_state_dict,
    save_detector_npz,
    state_dict_from_flax,
)

torch.set_num_threads(2)

ARTIFACT = ROOT / "artifacts" / "ssd_mobilenet_300_synth9k.npz"
SYNTH = ROOT / "tests" / "fixtures" / "synth_val_seed1"


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


def _ref_variables(model: torch.nn.Module) -> dict:
    """The reference's variables tree holding the port model's weights."""
    params, stats = flax_from_state_dict(model.state_dict())
    return {"params": _nest(params), "batch_stats": _nest(stats)}


def _assert_equal_to_reference(model: torch.nn.Module, ref_vars: dict) -> None:
    from bdd100k_tpu.utils.pretrained import flatten_tree

    want = state_dict_from_flax(flatten_tree(ref_vars["params"]),
                                flatten_tree(ref_vars.get("batch_stats", {})))
    got = model.state_dict()
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[key], w), key


def _changed(before: dict, model: torch.nn.Module) -> set[str]:
    return {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}


def _model(config):
    cfg = get_config(config) if isinstance(config, str) else config
    return build_detector(cfg, dtype=torch.float32, device="cpu", seed=1).model


def _fake_torchvision_vgg16(seed: int = 0) -> dict:
    """torchvision's vgg16 layout: features.N conv weights and biases, and
    the classifier (which the import ignores)."""
    rng = np.random.RandomState(seed)
    chans = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
             (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
             (512, 512), (512, 512)]
    idx = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    sd = {}
    for i, (cin, cout) in zip(idx, chans):
        sd[f"features.{i}.weight"] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05)
        sd[f"features.{i}.bias"] = torch.from_numpy(rng.randn(cout).astype(np.float32))
    sd["classifier.0.weight"] = torch.zeros(8, 8)
    return sd


def _fake_hf_mobilenet_v1(seed: int = 0, prefix: str = "") -> dict:
    """HF transformers' MobileNetV1 layout: conv_stem and 26 alternating
    depthwise/pointwise layers, each a convolution and a normalization."""
    rng = np.random.RandomState(seed)
    chans = [32, 64, 128, 128, 256, 256, 512, 512, 512, 512, 512, 512, 1024, 1024]
    sd = {}

    def conv_bn(name, shape, c):
        f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
        sd[f"{prefix}{name}.convolution.weight"] = f(*shape)
        sd[f"{prefix}{name}.normalization.weight"] = f(c).abs()
        sd[f"{prefix}{name}.normalization.bias"] = f(c)
        sd[f"{prefix}{name}.normalization.running_mean"] = f(c)
        sd[f"{prefix}{name}.normalization.running_var"] = f(c).abs() + 0.5
        sd[f"{prefix}{name}.normalization.num_batches_tracked"] = torch.tensor(7)

    conv_bn("conv_stem", (32, 3, 3, 3), 32)
    for k in range(13):
        cin, cout = chans[k], chans[k + 1]
        conv_bn(f"layer.{2 * k}", (cin, 1, 3, 3), cin)
        conv_bn(f"layer.{2 * k + 1}", (cout, cin, 1, 1), cout)
    if prefix:
        sd["classifier.weight"] = torch.zeros(4, 1024)
    return sd


def test_torchvision_vgg16_seeds_as_the_reference(tmp_path):
    from bdd100k_tpu.utils.pretrained import import_torch_vgg16

    path = tmp_path / "vgg16.pth"
    torch.save(_fake_torchvision_vgg16(), path)
    model = _model("ssd_vgg16_512")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = import_torch_vgg16(_ref_variables(model), path)
    assert pretrained.import_torch_vgg16(model, path) == 26
    _assert_equal_to_reference(model, ref)
    changed = _changed(before, model)
    assert len(changed) == 26 and all(k.startswith("backbone.block") for k in changed)
    # the kernel transposed OIHW → HWIO and back lands as torchvision's
    sd = _fake_torchvision_vgg16()
    assert torch.equal(model.state_dict()["backbone.block3.conv2.weight"],
                       sd["features.12.weight"])


@pytest.mark.parametrize("prefix", ["", "mobilenet_v1."], ids=["bare", "prefixed"])
def test_hf_mobilenet_v1_seeds_as_the_reference(tmp_path, prefix):
    from bdd100k_tpu.utils.pretrained import import_torch_mobilenet_v1

    path = tmp_path / "pytorch_model.bin"
    torch.save(_fake_hf_mobilenet_v1(prefix=prefix), path)
    model = _model("ssd_mobilenet_300")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = import_torch_mobilenet_v1(_ref_variables(model), path)
    # 27 conv-BN layers: kernel, scale, bias, mean, var
    assert pretrained.import_torch_mobilenet_v1(model, path) == 27 * 5
    _assert_equal_to_reference(model, ref)
    changed = _changed(before, model)
    assert len(changed) == 27 * 5 and all(k.startswith("backbone.") for k in changed)
    sd = _fake_hf_mobilenet_v1(prefix=prefix)
    assert torch.equal(model.state_dict()["backbone.ds4.pw.BatchNorm_0.running_var"],
                       sd[f"{prefix}layer.7.normalization.running_var"])


def test_bare_npz_transplant_as_the_reference(tmp_path):
    from bdd100k_tpu.utils.pretrained import load_backbone_any_npz as ref_load
    from bdd100k_tpu.utils.pretrained import save_params_npz as ref_save

    donor = _model(tiny_test_config("ssd"))
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(1.0)
    ours, theirs = tmp_path / "port.npz", tmp_path / "ref.npz"
    pretrained.save_params_npz(donor, ours)
    ref_save(_ref_variables(donor)["params"], theirs, subtree="backbone")
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) and "stem/Conv_0/kernel" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    model = _model(tiny_test_config("ssd"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = ref_load(_ref_variables(model), theirs)
    n = pretrained.load_backbone_any_npz(model, ours)
    _assert_equal_to_reference(model, ref)
    # params only: a bare transplant carries no statistics
    changed = _changed(before, model)
    assert n == len(changed) and changed == {
        k for k, _ in model.named_parameters() if k.startswith("backbone.")}


def test_committed_ssd300_artifact_seeds_a_yolo384_backbone():
    from bdd100k_tpu.utils.pretrained import load_backbone_any_npz as ref_load

    model = _model("yolo_mobilenet_384")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = ref_load(_ref_variables(model), ARTIFACT)
    n = pretrained.load_backbone_any_npz(model, ARTIFACT)
    _assert_equal_to_reference(model, ref)
    changed = _changed(before, model)
    # params and BatchNorm statistics of the backbone, nothing of the head
    assert n == len(changed) == 27 * 5
    assert all(k.startswith("backbone.") for k in changed)


def test_vgg_without_backbone_statistics_from_an_artifact(tmp_path):
    """VGG16's backbone has no BatchNorm, its SSD extras do: a full VGG
    artifact seeds the backbone's params and no statistics."""
    from bdd100k_tpu.utils.pretrained import load_backbone_any_npz as ref_load

    donor = _model("ssd_vgg16_512")
    with torch.no_grad():
        for name, b in donor.named_buffers():
            if name.endswith("running_mean"):
                b.add_(0.5)
    path = tmp_path / "vgg.npz"
    save_detector_npz(path, donor.state_dict(), config_name="ssd_vgg16_512",
                      param_dtype=np.float32)
    model = _model("ssd_vgg16_512")
    with torch.no_grad():  # every param away from the donor's
        for p in model.parameters():
            p.add_(1.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ref = ref_load(_ref_variables(model), path)
    n = pretrained.load_backbone_any_npz(model, path)
    _assert_equal_to_reference(model, ref)
    changed = _changed(before, model)
    assert n == len(changed) == 31  # 13 convs, fc6, fc7 and the L2Norm scale
    assert all(k.startswith("backbone.") for k in changed)


def test_shape_mismatch_raises(tmp_path):
    path = tmp_path / "bad.npz"
    np.savez(path, **{"stem/Conv_0/kernel": np.zeros((3, 3, 3, 5), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch at backbone.stem.Conv_0.weight"):
        pretrained.load_backbone_any_npz(_model(tiny_test_config("ssd")), path)


def test_seed_backbone_reanchors_the_ema_shadow(tmp_path, capsys):
    cfg = tiny_test_config("ssd")
    path = tmp_path / "bb.npz"
    donor = _model(cfg)
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(2.0)
    pretrained.save_params_npz(donor, path)
    bundle = build_detector(cfg, device="cpu")
    state = train_step.create_train_state(bundle, TrainConfig(ema_decay=0.99))
    n = port_train.seed_backbone(state, cfg, str(path))
    assert f"seeded mobilenet backbone from {path} ({n} tensors)" in capsys.readouterr().out
    for e, p in zip(state.ema_params, bundle.model.parameters(), strict=True):
        assert torch.equal(e, p)
    assert torch.equal(bundle.model.backbone.stem.Conv_0.weight,
                       donor.backbone.stem.Conv_0.weight)


def test_trainer_seeds_only_a_fresh_run(tmp_path, capsys):
    path = tmp_path / "bb.npz"
    pretrained.save_params_npz(_model(tiny_test_config("ssd")), path)
    argv = ["--config", "ssd_tiny_64", "--synthetic", "4", "--batch_size", "4",
            "--max_boxes", "16", "--total_steps", "1", "--warmup_steps", "0",
            "--log_every", "1", "--device", "cpu", "--ema_decay", "0.9",
            "--pretrained_backbone", str(path), "--ckpt_dir", str(tmp_path / "run")]
    port_train.main(argv)
    assert "seeded mobilenet backbone" in capsys.readouterr().out
    argv[argv.index("--total_steps") + 1] = "2"
    port_train.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "seeded" not in out
